"""Vision Transformer (ViT-B/16 by default) for image classification.

Port of ``horovod_tpu/models/vit.py:35-209``: data and tensor
parallelism.
As the JAX module does, it reuses BERT's encoder blocks (``bert.encode``:
the same layer layout, float32 LayerNorm with the affine after the cast,
tanh GELU, non-causal flash attention).  The ViT pieces are the patch
embedding (space-to-depth, then one ``[P·P·C, D]`` product), a CLS token,
learned positions and a classification head.  At 224/16 the sequence is
196 patches plus CLS, 197 rows: not a multiple of the kernels' 128-row
tile, which the kernels mask.

The loss divides this rank's NLL sum by the GLOBAL example count (summed
over the data ranks), times their number for
``hvd.DistributedOptimizer``'s average, as ``bert.mlm_loss_fn`` does.
Tensor parallelism rides BERT's encoder blocks (JAX :118-134), with the
same splits (:func:`param_specs`).  Sequence parallelism is refused at
construction, as in the JAX ``__post_init__``, and so is a ``mesh`` with
any axis but dp and tp of a size above 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import bert as _bert
from .llama import named_parameters, params_from_jax  # noqa: F401

__all__ = ["ViTConfig", "vit_b16", "tiny", "init_params", "params_from_jax",
           "named_parameters", "param_specs", "forward", "logits", "loss_fn",
           "psum_loss", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    n_classes: int = 1000
    d_model: int = 768           # ViT-Base
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    dp_axis: Optional[str] = "dp"
    tp_axis: Optional[str] = "tp"
    sp_axis: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_patches(self) -> int:
        g = self.image_size // self.patch_size
        return g * g

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} not divisible "
                             f"by patch_size {self.patch_size}")
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")
        if self.sp_axis is not None:
            raise ValueError("ViT does not support sequence parallelism "
                             "(short patch sequences); set sp_axis=None")


def vit_b16(**kw) -> ViTConfig:
    return ViTConfig(**kw)


def tiny(**kw) -> ViTConfig:
    defaults = dict(image_size=32, patch_size=8, channels=3, n_classes=10,
                    d_model=64, n_layers=2, n_heads=4, d_ff=128)
    defaults.update(kw)
    return ViTConfig(**defaults)


def init_params(cfg: ViTConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters from ``generator`` on ``device`` (the generator's
    by default), leaves that require grad."""
    device = torch.device(device) if device is not None else \
        generator.device
    D = cfg.d_model
    pdim = cfg.patch_size * cfg.patch_size * cfg.channels
    dense, zeros, ones = _bert.initializers(generator, device, cfg.dtype)
    layers = _bert.encoder_layers(cfg.n_layers, D, cfg.n_heads,
                                  cfg.head_dim, cfg.d_ff, dense, zeros, ones)
    return {
        "patch_proj": dense(pdim, (pdim, D)),
        "cls": zeros(1, 1, D),
        "pos_embed": dense(D, (cfg.n_patches + 1, D)),
        "layers": layers,
        "final_ln_scale": ones(D),
        "final_ln_bias": zeros(D),
        "head": dense(D, (D, cfg.n_classes)),
    }


def param_specs(cfg: ViTConfig) -> Dict:
    """The mesh axis and dimension each leaf is split over (JAX
    :118-134): the encoder blocks' as BERT's, the rest replicated."""
    return {"patch_proj": None, "cls": None, "pos_embed": None,
            "layers": _bert.encoder_specs(cfg.n_layers, cfg.tp_axis),
            "final_ln_scale": None, "final_ln_bias": None, "head": None}


def _patchify(images, cfg: ViTConfig):
    """``[B, H, W, C]`` -> ``[B, N, P·P·C]`` (space-to-depth)."""
    B, Himg, Wimg, C = images.shape
    Ps = cfg.patch_size
    g_h, g_w = Himg // Ps, Wimg // Ps
    x = images.reshape(B, g_h, Ps, g_w, Ps, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g_h * g_w, Ps * Ps * C)


def forward(params, images, cfg: ViTConfig, mesh=None):
    """The CLS token's encoder state ``[B, D]`` for ``images [B, H, W,
    C]``."""
    _bert.check_axes(cfg, mesh)
    x = _patchify(images.to(cfg.dtype), cfg) @ params["patch_proj"]
    B, _, D = x.shape
    cls = params["cls"].expand(B, 1, D).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    x = _bert.encode(x, params["layers"], cfg, mesh)
    x = _bert._layernorm(x, params["final_ln_scale"],
                         params["final_ln_bias"])
    return x[:, 0]


def logits(params, images, cfg: ViTConfig, mesh=None):
    return (forward(params, images, cfg, mesh) @ params["head"]).float()


def loss_fn(params, images, labels, cfg: ViTConfig, mesh=None):
    """This rank's NLL sum over the global example count, times the
    number of data ranks."""
    nll = F.cross_entropy(logits(params, images, cfg, mesh), labels.long(),
                          reduction="sum")
    count = torch.tensor(float(labels.shape[0]), device=nll.device)
    count, n = _bert.dp_total(count, cfg, "vit.count", mesh)
    return nll / count * n


def psum_loss(loss, cfg: ViTConfig, mesh=None):
    """The global loss for logging (see ``bert.psum_loss``)."""
    return _bert.psum_loss(loss, cfg, "vit.loss", mesh)


def make_train_step(cfg: ViTConfig, optimizer, mesh=None, shards=None):
    """Returns ``step(params, images, labels) -> loss``
    (``bert.train_step`` of :func:`loss_fn`)."""
    return _bert.train_step(
        lambda params, images, labels: loss_fn(params, images, labels, cfg,
                                               mesh),
        param_specs(cfg), optimizer, mesh, shards)
