"""ResNet, the canonical Horovod benchmark model (ResNet-50 by default).

Port of ``horovod_tpu/models/resnet.py:25-224``.  The parameters are a
plain dictionary in the JAX package's own layout, with convolution weights
kept ``HWIO`` (``[kh, kw, in, out]``) and every parameter and batch-norm
statistic in float32; :func:`params_from_jax` carries a JAX
``(params, stats)`` pair (as numpy arrays) over unchanged.

Activations are ``NHWC`` in memory, as in the JAX model: the images
``[B, H, W, C]`` are viewed as ``NCHW`` tensors in PyTorch's
``channels_last`` layout, which is the same memory, and every convolution
takes its weight permuted and cast to ``compute_dtype`` in that layout
(one copy a weight and step, which the cast needs anyway).  The
convolutions are cuDNN's (``torch.nn.functional.conv2d``): the JAX package
leaves them to XLA, outside any Pallas kernel.

Three places follow the JAX model rather than PyTorch's habits:

- ``padding="SAME"`` is XLA's: ``total = max((ceil(n/s) - 1)·s + k - n,
  0)``, ``lo = total // 2``, ``hi = total - lo``.  Where that is
  asymmetric (the 7×7/2 stem on 224 pads ``(2, 3)``, a 3×3/2 convolution
  or the 3×3/2 max-pool on an even size ``(0, 1)``) the input is padded
  with ``F.pad`` first (``-inf`` for the pool): a symmetric
  ``Conv2d(padding=3)`` would shift the sampling grid.
- Batch norm is the JAX model's own (``_batch_norm`` :102-128), in
  float32: ``var = E[x²] - E[x]²`` (biased, also into the running
  statistics), ``new = momentum·old + (1 - momentum)·batch`` with
  ``momentum = 0.9``, normalise, scale and shift, cast back.
- With ``sync_bn_axis`` set and a world above one rank, the training
  statistics are the mean over the ranks of each rank's ``[E[x], E[x²]]``
  (``psum(·)/n``), and so is their gradient (``psum``'s transpose is
  ``psum``): one engine allreduce forward and one backward a layer, named
  by the layer's path so the names agree across ranks and steps.

The loss is this rank's mean negative log-likelihood.  The JAX ``loss_fn``
divides the rank's sum by the global batch and ``psum``s the gradients;
``hvd.DistributedOptimizer`` averages the per-rank means instead, which is
the same gradient when every rank holds as many images.
:func:`make_sharded_train_step` (JAX :208-215) is the step over
``parallel.make_sharded_train_step``: it takes the global batch and cuts
this rank's block along the mesh's data axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import mpi_ops
from ..common import basics
from .llama import named_parameters, params_from_jax as _tree_from_jax

__all__ = ["BLOCKS", "BOTTLENECK", "ResNetConfig", "init_params",
           "params_from_jax", "named_parameters", "forward", "loss_fn",
           "make_train_step", "make_sharded_train_step", "synthetic_batch"]

BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
          101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BOTTLENECK = {50, 101, 152}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    compute_dtype: torch.dtype = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    # Cross-rank batch norm over the world; None: each rank's own batch.
    sync_bn_axis: Optional[str] = "hvd"


def _conv_shapes(cfg: ResNetConfig):
    """``(path, HWIO shape)`` of every convolution, in the JAX model's
    initialisation order."""
    bottleneck = cfg.depth in BOTTLENECK
    expansion = 4 if bottleneck else 1
    yield ("stem",), (7, 7, 3, cfg.width)
    in_ch = cfg.width
    for si, n_blocks in enumerate(BLOCKS[cfg.depth]):
        out_ch = cfg.width * (2 ** si) * expansion
        mid_ch = cfg.width * (2 ** si)
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            if bottleneck:
                shapes = [(1, 1, in_ch, mid_ch), (3, 3, mid_ch, mid_ch),
                          (1, 1, mid_ch, out_ch)]
            else:
                shapes = [(3, 3, in_ch, mid_ch), (3, 3, mid_ch, out_ch)]
            for ci, shp in enumerate(shapes):
                yield (f"stage{si}", bi, f"conv{ci}"), shp
            if in_ch != out_ch or stride != 1:
                yield (f"stage{si}", bi, "proj"), (1, 1, in_ch, out_ch)
            in_ch = out_ch


def init_params(cfg: ResNetConfig, generator: torch.Generator,
                device=None) -> Tuple[Dict, Dict]:
    """``(params, stats)``: He-normal convolutions, unit batch-norm scales,
    an ``N(0, 0.01²)`` classifier, drawn from ``generator`` on ``device``
    (the generator's by default); the parameters are float32 leaves that
    require grad, the statistics float32 tensors (mean 0, var 1)."""
    device = torch.device(device) if device is not None else \
        generator.device

    def leaf(t):
        return t.requires_grad_(True)

    def conv(shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return leaf(torch.randn(shape, generator=generator, device=device)
                    * float(np.sqrt(2.0 / fan_in)))

    def bn(ch):
        return {"scale": leaf(torch.ones(ch, device=device)),
                "bias": leaf(torch.zeros(ch, device=device))}

    def bn_stats(ch):
        return {"mean": torch.zeros(ch, device=device),
                "var": torch.ones(ch, device=device)}

    params: Dict = {"stem": {}}
    stats: Dict = {}
    for path, shp in _conv_shapes(cfg):
        entry = {"w": conv(shp), "bn": bn(shp[-1])}
        if path == ("stem",):
            params["stem"], stats["stem"] = entry, bn_stats(shp[-1])
            continue
        stage, bi, name = path
        blocks_p = params.setdefault(stage, [])
        blocks_s = stats.setdefault(stage, [])
        if bi == len(blocks_p):
            blocks_p.append({})
            blocks_s.append({})
        blocks_p[bi][name] = entry
        blocks_s[bi][name] = bn_stats(shp[-1])
    out_ch = shp[-1]                  # the last block's last convolution
    params["fc"] = {
        "w": leaf(torch.randn((out_ch, cfg.num_classes), generator=generator,
                              device=device) * 0.01),
        "b": leaf(torch.zeros(cfg.num_classes, device=device))}
    return params, stats


def params_from_jax(params, stats, device="cpu") -> Tuple[Dict, Dict]:
    """The JAX package's ``(params, stats)`` (leaves as numpy arrays) as
    the port's, layouts and dtypes unchanged.  The leaves do not require
    grad; ``requires_grad_()`` the parameters to train."""
    return _tree_from_jax(params, device), _tree_from_jax(stats, device)


# ------------------------------------------------------------------ forward
def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dimension: ``(lo, hi)``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh: int, kw: int, stride: int, value: float = 0.0):
    """``(x, padding)``: where XLA pads symmetrically, ``x`` itself and the
    padding for the operation; else ``x`` padded with ``value`` and
    ``(0, 0)``."""
    (top, bottom) = _same_pads(x.shape[2], kh, stride)
    (left, right) = _same_pads(x.shape[3], kw, stride)
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


def _conv(x, w, stride: int = 1):
    """``SAME`` convolution of ``x [B, C, H, W]`` (channels_last) by the
    ``HWIO`` weight ``w``, in ``x``'s dtype."""
    x, padding = _pad_same(x, w.shape[0], w.shape[1], stride)
    wt = w.permute(3, 2, 0, 1).to(x.dtype, memory_format=torch.channels_last)
    return F.conv2d(x, wt, stride=stride, padding=padding)


def _max_pool(x):
    """The 3×3/2 ``SAME`` max-pool, padding with ``-inf``."""
    x, padding = _pad_same(x, 3, 3, 2, value=float("-inf"))
    return F.max_pool2d(x, 3, 2, padding=padding)


def _exchanging(cfg: ResNetConfig) -> bool:
    return bool(cfg.sync_bn_axis) and basics.is_initialized() \
        and basics.size() > 1


def _world_mean(t, name: str):
    """``psum(t) / n`` over the world through the engine."""
    cross_rank_moments.exchanges += 1
    return mpi_ops.allreduce(t, name=name, op=mpi_ops.Sum) / basics.size()


class _CrossRankMoments(torch.autograd.Function):
    """``[E[x], E[x²]]`` of this rank -> their mean over the ranks; the
    gradient is the mean over the ranks of the cotangents."""

    @staticmethod
    def forward(ctx, pair, name):
        ctx.name = name
        return _world_mean(pair, name + ".fwd")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return _world_mean(grad.contiguous(), ctx.name + ".bwd"), None


def cross_rank_moments(pair, name: str):
    """The world's mean of each rank's ``pair [2, C]`` (``[E[x], E[x²]]``
    of one batch-norm layer), differentiable; ``exchanges`` counts the
    allreduces, forward and backward."""
    return _CrossRankMoments.apply(pair, name)


cross_rank_moments.exchanges = 0


def _batch_norm(x, bn, stats, cfg: ResNetConfig, train: bool, name: str):
    """``(y, new_stats)``: the JAX ``_batch_norm`` on ``x [B, C, H, W]``."""
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = xf.square().mean(dim=(0, 2, 3))
        if _exchanging(cfg):
            mean, mean2 = cross_rank_moments(torch.stack([mean, mean2]),
                                             name)
        var = mean2 - mean.square()
        m = cfg.bn_momentum
        new_stats = {"mean": m * stats["mean"] + (1 - m) * mean.detach(),
                     "var": m * stats["var"] + (1 - m) * var.detach()}
    else:
        mean, var = stats["mean"], stats["var"]
        new_stats = stats

    def ch(v):
        return v.reshape(1, -1, 1, 1)

    y = (xf - ch(mean)) * ch(torch.rsqrt(var + cfg.bn_eps)) \
        * ch(bn["scale"]) + ch(bn["bias"])
    return y.to(x.dtype), new_stats


def forward(params, stats, images, cfg: ResNetConfig, train: bool = True):
    """``images [B, H, W, 3]`` -> ``(logits [B, classes] float32,
    new_stats)``; in eval mode ``new_stats`` holds ``stats``' tensors."""
    x = images.to(cfg.compute_dtype).permute(0, 3, 1, 2)   # channels_last
    new_stats: Dict = {}
    y = _conv(x, params["stem"]["w"], stride=2)
    y, new_stats["stem"] = _batch_norm(y, params["stem"]["bn"],
                                       stats["stem"], cfg, train,
                                       "resnet.stem")
    y = _max_pool(F.relu(y))

    bottleneck = cfg.depth in BOTTLENECK
    n_convs = 3 if bottleneck else 2
    for si in range(len(BLOCKS[cfg.depth])):
        stage_stats = []
        for bi, (bp, bs) in enumerate(zip(params[f"stage{si}"],
                                          stats[f"stage{si}"])):
            stride = 2 if (si > 0 and bi == 0) else 1
            path = f"resnet.stage{si}.{bi}"
            bstat: Dict = {}
            h = y
            for ci in range(n_convs):
                # The stride sits on the bottleneck's 3×3, conv1.
                s = stride if ci == (1 if bottleneck else 0) else 1
                h = _conv(h, bp[f"conv{ci}"]["w"], stride=s)
                h, bstat[f"conv{ci}"] = _batch_norm(
                    h, bp[f"conv{ci}"]["bn"], bs[f"conv{ci}"], cfg, train,
                    f"{path}.conv{ci}")
                if ci < n_convs - 1:
                    h = F.relu(h)
            res = y
            if "proj" in bp:
                res = _conv(y, bp["proj"]["w"], stride=stride)
                res, bstat["proj"] = _batch_norm(
                    res, bp["proj"]["bn"], bs["proj"], cfg, train,
                    f"{path}.proj")
            y = F.relu(h + res)
            stage_stats.append(bstat)
        new_stats[f"stage{si}"] = stage_stats

    pooled = y.float().mean(dim=(2, 3))
    return pooled @ params["fc"]["w"] + params["fc"]["b"], new_stats


# ----------------------------------------------------------------- training
def loss_fn(params, stats, images, labels, cfg: ResNetConfig):
    """``(mean NLL over this rank's images, new_stats)``, logits in
    float32."""
    logits, new_stats = forward(params, stats, images, cfg, train=True)
    return F.cross_entropy(logits.float(), labels.long()), new_stats


def make_train_step(cfg: ResNetConfig, optimizer):
    """Returns ``step(params, stats, images, labels) -> (loss,
    new_stats)``: zero the grads, forward in training mode, backward,
    ``optimizer.step()``.  ``params`` must be the leaves ``optimizer``
    updates; with ``hvd.DistributedOptimizer`` the step averages the
    gradients across processes."""
    def step(params, stats, images, labels):
        optimizer.zero_grad()
        loss, new_stats = loss_fn(params, stats, images, labels, cfg)
        loss.backward()
        optimizer.step()
        return loss.detach(), new_stats

    return step


def make_sharded_train_step(cfg: ResNetConfig, optimizer, mesh,
                            axis_name: str = "dp"):
    """Returns ``step(params, stats, images, labels) -> (loss,
    new_stats)`` over the global batch: :func:`make_train_step` fed this
    rank's block of ``images`` and ``labels`` along ``axis_name`` of
    ``mesh`` (``parallel.make_sharded_train_step``; JAX :208-215, whose
    ``P(axis_name)`` batch spec this is).  ``params`` and ``stats`` are
    replicated."""
    from ..parallel.spmd import make_sharded_train_step as _harness
    inner = make_train_step(cfg, optimizer)
    sharded = _harness(lambda ps, x, y: inner(ps[0], ps[1], x, y), mesh,
                       data_axes=(axis_name,))

    def step(params, stats, images, labels):
        return sharded((params, stats), images, labels)

    return step


def synthetic_batch(batch: int, image_size: int = 224,
                    num_classes: int = 1000,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX ``synthetic_batch``: ``(images [B, H, W, 3] float32,
    labels [B] int32)`` from ``seed``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, image_size, image_size, 3).astype(np.float32)
    y = rng.randint(0, num_classes, size=(batch,)).astype(np.int32)
    return x, y
