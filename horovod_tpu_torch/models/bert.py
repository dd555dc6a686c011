"""BERT encoder (BERT-Large by default) with the masked-LM loss.

Port of the data-parallel path of ``horovod_tpu/models/bert.py:28-223``.
The parameters are a plain dictionary in the JAX package's own layout
(``[in, out]`` weights: a projection is ``x @ w``);
:func:`params_from_jax` carries a JAX tree (as numpy arrays) over unchanged.

Attention is ``flash_attention(q, k, v, causal=False)`` on ``[B, T, H,
D]`` (the Hopper kernels on a card, their plain versions on the CPU), and
the training step differentiates through the flash backward.  As in the
JAX functions:

- :func:`_layernorm` normalises in float32, casts to the input's dtype,
  and only then applies ``scale`` and ``bias`` in that dtype (a fused
  ``F.layer_norm`` applies them before the cast);
- the FFN's GELU is the tanh approximation (``jax.nn.gelu``'s default),
  not PyTorch's exact default.

The masked-LM loss divides this rank's masked NLL sum by the GLOBAL mask
count, summed over the data-parallel ranks (the whole world, one engine
allreduce), because the ranks' mask counts differ.  The JAX loss is that
quotient and its gradients are ``psum``'d; ``hvd.DistributedOptimizer``
averages instead, so the port's per-rank loss is the quotient times the
world size, and the average of the gradients is the JAX sum.
:func:`psum_loss` gives the global masked mean.

Tensor and sequence parallelism are not ported: a ``mesh`` whose
``tp_axis`` or ``sp_axis`` has a size above 1 raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import mpi_ops
from ..common import basics
from ..ops.flash_attention import flash_attention
from .llama import named_parameters, params_from_jax  # noqa: F401

__all__ = ["BertConfig", "bert_large", "tiny", "init_params",
           "params_from_jax", "named_parameters", "forward", "mlm_loss_fn",
           "psum_loss", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 1024          # BERT-Large
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    max_seq: int = 512
    dtype: torch.dtype = torch.bfloat16
    # The data-parallel axis (the world; None: no exchange) and the axes
    # a mesh may name, which must have size 1 until tp/sp are ported.
    dp_axis: Optional[str] = "dp"
    tp_axis: Optional[str] = "tp"
    sp_axis: Optional[str] = "sp"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def bert_large(**kw) -> BertConfig:
    return BertConfig(**kw)


def tiny(**kw) -> BertConfig:
    defaults = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    d_ff=128, max_seq=64)
    defaults.update(kw)
    return BertConfig(**defaults)


def encoder_layers(n_layers: int, D: int, H: int, Hd: int, F_: int, dense,
                   zeros, ones):
    """The encoder blocks' parameters, shared with ViT (the JAX ViT reuses
    BERT's blocks and their layout)."""
    return [{
        "ln1_scale": ones(D), "ln1_bias": zeros(D),
        "wq": dense(D, (D, H * Hd)), "wk": dense(D, (D, H * Hd)),
        "wv": dense(D, (D, H * Hd)), "wo": dense(H * Hd, (H * Hd, D)),
        "ln2_scale": ones(D), "ln2_bias": zeros(D),
        "w_in": dense(D, (D, F_)), "b_in": zeros(F_),
        "w_out": dense(F_, (F_, D)), "b_out": zeros(D),
    } for _ in range(n_layers)]


def initializers(generator: torch.Generator, device, dt):
    """``(dense, zeros, ones)``: ``N(0, 1/fan_in)`` weights and constant
    vectors in ``dt``, leaves that require grad."""
    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, device=device) \
            * (1.0 / np.sqrt(fan_in))
        return w.to(dt).requires_grad_(True)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device,
                           requires_grad=True)

    def ones(n):
        return torch.ones(n, dtype=dt, device=device, requires_grad=True)

    return dense, zeros, ones


def init_params(cfg: BertConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters from ``generator`` on ``device`` (the generator's
    by default), leaves that require grad."""
    device = torch.device(device) if device is not None else \
        generator.device
    D, V = cfg.d_model, cfg.vocab_size
    dense, zeros, ones = initializers(generator, device, cfg.dtype)
    layers = encoder_layers(cfg.n_layers, D, cfg.n_heads, cfg.head_dim,
                            cfg.d_ff, dense, zeros, ones)
    return {
        "tok_embed": dense(D, (V, D)),
        "pos_embed": dense(D, (cfg.max_seq, D)),
        "layers": layers,
        "final_ln_scale": ones(D),
        "final_ln_bias": zeros(D),
        "mlm_head": dense(D, (D, V)),
    }


# ------------------------------------------------------------------ forward
def check_axes(cfg, mesh) -> None:
    """Refuse a mesh that would split the heads (tp) or the sequence (sp):
    only the data-parallel path is ported."""
    if mesh is None:
        return
    for ax in (getattr(cfg, "tp_axis", None), getattr(cfg, "sp_axis", None)):
        if ax and ax in mesh.axis_names and mesh.size(ax) > 1:
            raise NotImplementedError(
                f"{type(cfg).__name__}: the mesh's {ax!r} axis has size "
                f"{mesh.size(ax)}; tensor and sequence parallelism are not "
                f"ported for this family yet (data parallel only)")


def _layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def _attention(x, p, cfg):
    B, T, _ = x.shape
    H, Hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, T, H, Hd)
    k = (x @ p["wk"]).reshape(B, T, H, Hd)
    v = (x @ p["wv"]).reshape(B, T, H, Hd)
    out = flash_attention(q, k, v, causal=False)
    return out.reshape(B, T, H * Hd) @ p["wo"]


def _ffn(x, p):
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    return h @ p["w_out"] + p["b_out"]


def encode(x, layers, cfg):
    """The pre-LN encoder blocks over ``x [B, T, D]``."""
    for p in layers:
        x = x + _attention(_layernorm(x, p["ln1_scale"], p["ln1_bias"]),
                           p, cfg)
        x = x + _ffn(_layernorm(x, p["ln2_scale"], p["ln2_bias"]), p)
    return x


def forward(params, tokens, cfg: BertConfig, mesh=None):
    """Encoder states ``[B, T, D]`` for ``tokens [B, T]``."""
    check_axes(cfg, mesh)
    T = tokens.shape[1]
    x = params["tok_embed"][tokens.long()] + params["pos_embed"][:T][None]
    x = encode(x, params["layers"], cfg)
    return _layernorm(x, params["final_ln_scale"], params["final_ln_bias"])


# ----------------------------------------------------------------- training
def dp_total(x, cfg, name: str):
    """``(sum of x over the data-parallel ranks, their number)``: one
    engine allreduce over the world, or ``(x, 1)`` with no ``dp_axis`` or
    a world of one."""
    if not cfg.dp_axis or not basics.is_initialized() or basics.size() == 1:
        return x, 1
    return mpi_ops.allreduce(x.reshape(1), name=name,
                             op=mpi_ops.Sum)[0], basics.size()


def mlm_loss_fn(params, tokens, targets, mask, cfg: BertConfig, mesh=None):
    """This rank's masked NLL sum over the global mask count, times the
    data-parallel world size (see the module's docstring); ``mask`` is 1
    at masked positions.  Logits in float32."""
    x = forward(params, tokens, cfg, mesh)
    logits = (x @ params["mlm_head"]).float()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1).long(), reduction="none")
    mask = mask.reshape(-1).float()
    count, n = dp_total(mask.sum().detach(), cfg, "bert.mask_count")
    return (nll * mask).sum() / count.clamp(min=1.0) * n


def psum_loss(loss, cfg, name: str = "bert.loss"):
    """The global loss for logging: the mean over the data-parallel ranks
    of their losses (the JAX ``psum`` of the partial losses)."""
    total, n = dp_total(loss.detach(), cfg, name)
    return total / n


def make_train_step(cfg: BertConfig, optimizer, mesh=None):
    """Returns ``step(params, tokens, targets, mask) -> loss``: zero the
    grads, the masked-LM loss, backward, ``optimizer.step()``.  The loss
    is this rank's (:func:`mlm_loss_fn`) for the parameters before the
    update; :func:`psum_loss` gives the global one."""
    def step(params, tokens, targets, mask):
        optimizer.zero_grad()
        loss = mlm_loss_fn(params, tokens, targets, mask, cfg, mesh)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
