"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

Port of ``horovod_tpu/ops/flash_attention.py:277-401``.  The TPU kernel it
replaces is ``_fwd_kernel`` (``:98-166``, launched by ``_fwd_impl``); the
CUDA source is ``csrc/flash_fwd.cu``, whose header states its bound on the
H100 and what its simple design leaves on the table.

Layout: ``[B, T, H, D]`` (the llama layout).  GQA is native: k and v carry
``K = H / rep`` heads and each group of ``rep`` consecutive q heads reads
its shared kv head, with no repeat in memory.  The forward returns
``(o, lse)``: ``o`` in q's dtype, ``lse [B, H, Tq]`` in float32 (the JAX
``[BH, Tq]`` reshaped), because ring attention needs both.

Routing is by device only.  A CPU tensor goes through
:func:`flash_attention_plain`; a CUDA tensor launches the kernel or raises.
The TPU's routing knobs and tile sizes are measurements of that chip and
are not carried over.  The backward kernels (``_dq_kernel``,
``_dkv_kernel``) arrive with the training slice; until then a call that
needs a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_INT_MAX = 2 ** 31 - 1


def _check(q, k, v, causal: bool, window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, T, heads, D]")
    B, _, H, D = q.shape
    K = k.shape[2]
    if v.shape[2] != K:
        raise ValueError(f"k has {K} heads but v has {v.shape[2]}")
    if H % K:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads "
                         f"({K}) for GQA")
    if k.shape[0] != B or v.shape[0] != B or k.shape[1] != v.shape[1] \
            or k.shape[3] != D or v.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype, got {q.dtype}/"
                         f"{k.dtype}/{v.dtype}; cast before the call")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window attention) requires "
                             "causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward is not ported yet: the dq and dk/dv "
            "kernels arrive with the training slice of the port")


def _mask(Tq: int, Tk: int, causal: bool, window: Optional[int], device):
    rows = torch.arange(Tq, device=device)[:, None]
    cols = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones(Tq, Tk, dtype=torch.bool, device=device)
    if causal:
        mask = rows >= cols
        if window:
            mask = mask & (rows - cols < window)
    return mask


def flash_attention_plain(q, k, v, causal: bool = False,
                          scale: Optional[float] = None,
                          window: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, dense and in float32: the
    same masks, the NEG_INF sentinel, p rounded to v's dtype before p.v,
    and ``o = 0, lse = 0`` for a row no key may attend."""
    _check(q, k, v, causal, window)
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    rep = H // K
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().permute(0, 2, 1, 3)                      # [B, H, Tq, D]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale     # [B, H, Tq, Tk]
    mask = _mask(Tq, Tk, causal, window, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).float(), vf) / safe_l    # [B, H, Tq, D]
    lse = torch.where(l == 0, torch.zeros_like(l), m + torch.log(safe_l))
    return o.permute(0, 2, 1, 3).to(q.dtype), lse[..., 0]


def _flash_kernel(q, k, v, causal: bool, scale: float,
                  window: Optional[int]):
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its head dim")
        if max(x.stride()[:3]) > _INT_MAX:
            raise ValueError(f"{name} strides exceed the kernel's int range")
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.hvd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, K, Tq, Tk, D,
        q.stride(0), q.stride(2), q.stride(1),
        k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1),
        o.stride(0), o.stride(2), o.stride(1),
        float(scale), int(bool(causal)), int(window or 0),
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_fwd.launches += 1
    return o, lse


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_fwd")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hvd_flash_fwd.restype = ci
        lib.hvd_flash_fwd.argtypes = ([vp] * 5 + [ci] * 6 + [ci] * 12
                                      + [ctypes.c_float, ci, ci, ci, vp])
        _LIB = lib
    return _LIB


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention, ``(o [B, Tq, H, D], lse [B, H, Tq])``.

    q: ``[B, Tq, H, D]``; k, v: ``[B, Tk, K, D]`` with ``H % K == 0``.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``launches`` counts those launches) or raise."""
    _check(q, k, v, causal, window)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return _flash_kernel(q, k, v, causal, scale, window)


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Memory-efficient exact attention; returns ``o`` only (the JAX
    package's ``flash_attention`` surface)."""
    return flash_attention_fwd(q, k, v, causal, scale, window)[0]
