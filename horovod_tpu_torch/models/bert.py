"""BERT encoder (BERT-Large by default) with the masked-LM loss.

Port of ``horovod_tpu/models/bert.py:28-223``: data, tensor and sequence
parallelism.
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
count, summed over the data ranks (dp × sp: those that hold other tokens),
because the ranks' mask counts differ.  The JAX loss is that quotient
(divided by tp as well) and its gradients are ``psum``'d;
``hvd.DistributedOptimizer`` averages instead, so the port's per-rank loss
is the quotient times the number of data ranks, and the average of the
gradients is the JAX sum.  :func:`psum_loss` gives the global masked mean.

On a ``mesh`` (JAX :92-165): tensor parallelism splits the heads
(``wq``/``wk``/``wv`` by columns, ``wo`` by rows) and the FFN's hidden
units (``w_in``/``b_in`` by columns, ``w_out`` by rows) over
``cfg.tp_axis`` as Llama does, with Megatron's ``f``/``g`` pair
(``parallel/mesh.py``); ``b_out`` is added once, after ``g``.  Sequence
parallelism over ``cfg.sp_axis`` attends by Ulysses' head exchange,
non-causal, and takes positions from the sp coordinate.  Every other axis
of a size above 1 is refused.  :func:`param_specs` names the split leaves
for ``parallel.ShardedParallel``.
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
from ..parallel.expert import Split, refuse_world_averaged
from ..parallel.mesh import psum
from ..parallel.ulysses import ulysses_attention
from .llama import _copy_in, _reduce_out, _tp
from .llama import named_parameters, params_from_jax  # noqa: F401

__all__ = ["BertConfig", "bert_large", "tiny", "init_params",
           "params_from_jax", "named_parameters", "param_specs", "forward",
           "mlm_loss_fn", "psum_loss", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 1024          # BERT-Large
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    max_seq: int = 512
    dtype: torch.dtype = torch.bfloat16
    # The mesh axes: data (None: no exchange), heads and hidden units
    # (Megatron), and the sequence (Ulysses).
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


def encoder_specs(n_layers: int, tp: Optional[str]):
    """The encoder blocks' splits (JAX :92-108): heads and hidden units by
    columns over ``tp``, their output projections by rows, ``b_in`` with
    its columns; the rest replicated.  Shared with ViT."""
    cols, rows = (Split(tp, 1), Split(tp, 0)) if tp else (None, None)
    layer = {"ln1_scale": None, "ln1_bias": None, "wq": cols, "wk": cols,
             "wv": cols, "wo": rows, "ln2_scale": None, "ln2_bias": None,
             "w_in": cols, "b_in": Split(tp, 0) if tp else None,
             "w_out": rows, "b_out": None}
    return [dict(layer) for _ in range(n_layers)]


def param_specs(cfg: BertConfig) -> Dict:
    """The mesh axis and dimension each leaf is split over, shaped like the
    parameters (``parallel.expert.Split``; None: replicated)."""
    return {"tok_embed": None, "pos_embed": None,
            "layers": encoder_specs(cfg.n_layers, cfg.tp_axis),
            "final_ln_scale": None, "final_ln_bias": None, "mlm_head": None}


# ------------------------------------------------------------------ forward
def _axis(cfg, name: str) -> Optional[str]:
    return getattr(cfg, name, None)


def _size(cfg, name: str, mesh) -> int:
    """The size of the config's ``name`` axis in ``mesh`` (1 without)."""
    ax = _axis(cfg, name)
    if mesh is None or ax is None or ax not in mesh.axis_names:
        return 1
    return mesh.size(ax)


def check_axes(cfg, mesh) -> None:
    """Refuse a mesh axis of a size above 1 that the family does not
    split over (every axis but the config's dp, tp and sp), and heads that
    tp does not divide (JAX :119-121)."""
    if mesh is None:
        return
    known = {_axis(cfg, a) for a in ("dp_axis", "tp_axis", "sp_axis")}
    for ax in mesh.axis_names:
        if ax not in known and mesh.size(ax) > 1:
            raise ValueError(
                f"{type(cfg).__name__}: the mesh's {ax!r} axis has size "
                f"{mesh.size(ax)}, and this family splits over "
                f"{sorted(a for a in known if a)} only")
    tp = _size(cfg, "tp_axis", mesh)
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by tp={tp}")


def _layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def _attention(x, p, cfg, mesh=None):
    """This rank's heads, summed over tp; Ulysses over sp."""
    B, T, _ = x.shape
    H, Hd = cfg.n_heads // _tp(cfg, mesh), cfg.head_dim
    x = _copy_in(x, cfg, mesh)
    q = (x @ p["wq"]).reshape(B, T, H, Hd)
    k = (x @ p["wk"]).reshape(B, T, H, Hd)
    v = (x @ p["wv"]).reshape(B, T, H, Hd)
    if _size(cfg, "sp_axis", mesh) > 1:
        out = ulysses_attention(q, k, v, mesh, axis_name=cfg.sp_axis,
                                causal=False)
    else:
        out = flash_attention(q, k, v, causal=False)
    return _reduce_out(out.reshape(B, T, H * Hd) @ p["wo"], cfg, mesh)


def _ffn(x, p, cfg=None, mesh=None):
    """This rank's hidden units, summed over tp, then ``b_out``."""
    x = _copy_in(x, cfg, mesh)
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    return _reduce_out(h @ p["w_out"], cfg, mesh) + p["b_out"]


def encode(x, layers, cfg, mesh=None):
    """The pre-LN encoder blocks over ``x [B, T, D]``."""
    for p in layers:
        x = x + _attention(_layernorm(x, p["ln1_scale"], p["ln1_bias"]),
                           p, cfg, mesh)
        x = x + _ffn(_layernorm(x, p["ln2_scale"], p["ln2_bias"]), p, cfg,
                     mesh)
    return x


def forward(params, tokens, cfg: BertConfig, mesh=None):
    """Encoder states ``[B, T, D]`` for this rank's ``tokens [B, T]``: with
    the sequence split over ``mesh``, its ``T`` positions start at
    ``sp_rank · T``."""
    check_axes(cfg, mesh)
    T = tokens.shape[1]
    start = mesh.index(cfg.sp_axis) * T \
        if _size(cfg, "sp_axis", mesh) > 1 else 0
    x = params["tok_embed"][tokens.long()] \
        + params["pos_embed"][start:start + T][None]
    x = encode(x, params["layers"], cfg, mesh)
    return _layernorm(x, params["final_ln_scale"], params["final_ln_bias"])


# ----------------------------------------------------------------- training
def dp_total(x, cfg, name: str, mesh=None):
    """``(sum of x over the data ranks, their number)``.  The data ranks
    are those that hold other tokens: the whole world without a ``mesh``
    (one engine allreduce; ``(x, 1)`` with no ``dp_axis`` or a world of
    one), the ranks along the config's dp and sp axes of ``mesh``
    otherwise (one sum on each axis's group), never the tp ranks, which
    hold this rank's tokens."""
    if mesh is not None:
        n = 1
        for a in ("dp_axis", "sp_axis"):
            if _size(cfg, a, mesh) > 1:
                x = psum(x.reshape(1), mesh, _axis(cfg, a))[0]
                n *= mesh.size(_axis(cfg, a))
        return x, n
    if not cfg.dp_axis or not basics.is_initialized() or basics.size() == 1:
        return x, 1
    return mpi_ops.allreduce(x.reshape(1), name=name,
                             op=mpi_ops.Sum)[0], basics.size()


def mlm_loss_fn(params, tokens, targets, mask, cfg: BertConfig, mesh=None):
    """This rank's masked NLL sum over the global mask count, times the
    number of data ranks (see the module's docstring); ``mask`` is 1 at
    masked positions.  Logits in float32."""
    x = forward(params, tokens, cfg, mesh)
    logits = (x @ params["mlm_head"]).float()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1).long(), reduction="none")
    mask = mask.reshape(-1).float()
    count, n = dp_total(mask.sum().detach(), cfg, "bert.mask_count", mesh)
    return (nll * mask).sum() / count.clamp(min=1.0) * n


def psum_loss(loss, cfg, name: str = "bert.loss", mesh=None):
    """The global loss for logging: the mean over the data ranks of their
    losses (the JAX ``psum`` of the partial losses)."""
    total, n = dp_total(loss.detach(), cfg, name, mesh)
    return total / n


def train_step(loss_fn, specs, optimizer, mesh=None, shards=None):
    """``step(params, *batch) -> loss``: zero the grads, ``loss_fn(params,
    *batch)``, backward, ``optimizer.step()`` and, with ``shards`` (a
    ``parallel.ShardedParallel`` over the tp-split leaves),
    ``shards.step()``.  The first step raises ``ValueError`` if
    ``optimizer`` is a ``DistributedOptimizer`` that steps a leaf that
    ``specs`` splits over an axis of ``mesh`` of a size above 1.  Shared
    by BERT, ViT and GPT-2."""
    checked = []

    def step(params, *batch):
        if not checked:
            refuse_world_averaged(optimizer, params, specs, mesh)
            checked.append(True)
        optimizer.zero_grad()
        if shards is not None:
            shards.zero_grad()
        loss = loss_fn(params, *batch)
        loss.backward()
        optimizer.step()
        if shards is not None:
            shards.step()
        return loss.detach()

    return step


def make_train_step(cfg: BertConfig, optimizer, mesh=None, shards=None):
    """Returns ``step(params, tokens, targets, mask) -> loss``
    (:func:`train_step` of :func:`mlm_loss_fn`).  The loss is this rank's
    for the parameters before the update; :func:`psum_loss` gives the
    global one."""
    return train_step(
        lambda params, tokens, targets, mask: mlm_loss_fn(
            params, tokens, targets, mask, cfg, mesh),
        param_specs(cfg), optimizer, mesh, shards)
