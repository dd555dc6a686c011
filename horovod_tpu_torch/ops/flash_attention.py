"""Flash attention: the hand-written Hopper kernels, their plain PyTorch
versions and the autograd function that ties them together.

Port of ``horovod_tpu/ops/flash_attention.py:277-511``.  The TPU kernels
replaced are ``_fwd_kernel`` (``:98-166``, launched by ``_fwd_impl``), whose
CUDA source is ``csrc/flash_fwd.cu``, and ``_dq_kernel``/``_dkv_kernel``
(``:170-273``, launched by ``_bwd_impl``), whose source is
``csrc/flash_bwd.cu``.  Each source's header states its bound on the H100
and what its design leaves on the table.

Two designs, chosen by dtype inside the C entry points:

- bfloat16, all three kernels (forward, dq, dk/dv): warp-specialised
  blocks of one TMA producer and two consumer warpgroups; the products run
  on the tensor cores (``wgmma``) from 128-byte-swizzled tiles that TMA
  streams through a ring of shared-memory stages (``csrc/hopper.cuh`` holds
  the pieces).  TMA needs a 16-byte-aligned base and batch, head and row
  strides that are multiples of 16 bytes (:func:`tma_ok`); a bfloat16
  operand without them is copied to a fresh contiguous tensor before the
  launch.
- float32: the first design, f32 FMAs on operands staged in shared memory,
  which keeps float32 exact to the 1e-4 the tests hold (a TF32 ``wgmma``
  would not).

Layout: ``[B, T, H, D]`` (the llama layout).  GQA is native: k and v carry
``K = H / rep`` heads and each group of ``rep`` consecutive q heads reads
its shared kv head, with no repeat in memory.  The forward returns
``(o, lse)``: ``o`` in q's dtype, ``lse [B, H, Tq]`` in float32 (the JAX
``[BH, Tq]`` reshaped), because ring attention needs both.

Routing is by device only.  A CPU tensor goes through
:func:`flash_attention_plain`; a CUDA tensor launches the kernel or raises
(a fake CUDA tensor, traced by the collective audit, gets stand-ins of
the outputs' shapes and launches nothing).
The TPU's routing knobs and tile sizes are measurements of that chip and
are not carried over.

:func:`flash_attention` is differentiable: its forward saves ``(q, k, v,
o, lse)``, and its backward computes ``delta = rowsum(do * o)`` in float32
and casts ``do`` to q's dtype outside any kernel, as ``_flash_bwd`` does,
then calls :func:`flash_attention_bwd`.  That function also takes an
externally supplied ``lse``/``delta`` (ring attention passes the global
ones, ``horovod_tpu/parallel/ring_attention.py:177-301``).
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


def _check_kernel_operands(named) -> None:
    """What the CUDA kernels take: float32 or bfloat16, head_dim 64 or 128,
    a contiguous head dim and strides in int range."""
    dtype, D = named[0][1].dtype, named[0][1].shape[3]
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {D}")
    for name, x in named:
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its head dim")
        if max(x.stride()[:3]) > _INT_MAX:
            raise ValueError(f"{name} strides exceed the kernel's int range")


def _strides(x):
    """(batch, head, row) element strides of a [B, T, heads, D] tensor.  A
    dimension of size 1 is never stepped along, so it gets the stride a
    contiguous tensor would have: TMA takes no other value for it."""
    B, T, H, D = x.shape
    return (x.stride(0) if B > 1 else T * H * D,
            x.stride(2) if H > 1 else D,
            x.stride(1) if T > 1 else H * D)


def tma_ok(x) -> bool:
    """Can TMA describe this ``[B, T, heads, D]`` tensor as it lies?  Its
    base must be 16-byte aligned and its batch, head and row strides
    multiples of 16 bytes (the head dim is contiguous)."""
    size = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        s > 0 and s * size % 16 == 0 for s in _strides(x))


def _tma_operand(x):
    """``x`` itself where the bfloat16 kernels can map it, else a fresh
    contiguous copy (new storage: an aligned base)."""
    if x.dtype != torch.bfloat16 or tma_ok(x):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _flash_kernel(q, k, v, causal: bool, scale: float,
                  window: Optional[int]):
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    _check_kernel_operands((("q", q), ("k", k), ("v", v)))
    q, k, v = (_tma_operand(x) for x in (q, k, v))
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    err = _lib("flash_fwd").hvd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, K, Tq, Tk, D,
        *_strides(q), *_strides(k), *_strides(v), *_strides(o),
        float(scale), int(bool(causal)), int(window or 0),
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_fwd.launches += 1
    return o, lse


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# The C signature of each entry point, by source.
_SIGNATURES = {
    "flash_fwd": {
        "hvd_flash_fwd": [_VP] * 5 + [_CI] * 6 + [_CI] * 12
        + [ctypes.c_float, _CI, _CI, _CI, _VP],
        "hvd_wgmma_probe": [_VP] * 3 + [_CI] * 3 + [_VP],
    },
    "flash_bwd": {
        "hvd_flash_bwd_dq": [_VP] * 7 + [_CI] * 6 + [_IP] + [_CI] * 3
        + [ctypes.c_float, _CI, _CI, _CI, _VP],
        "hvd_flash_bwd_dkv": [_VP] * 8 + [_CI] * 6 + [_IP] + [_CI] * 6
        + [ctypes.c_float, _CI, _CI, _CI, _VP],
    },
}
_LIBS = {}


def _lib(name: str):
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.load(name)
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).restype = _CI
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib


def _on_cpu(q) -> bool:
    """Routing by device only: True for CPU tensors, False for CUDA ones;
    any other device raises."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return False


def _fake(q) -> bool:
    """A fake CUDA tensor of a collective audit's trace
    (``analysis/trace_check.py``): it has no memory to launch on."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(q, FakeTensor)


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention, ``(o [B, Tq, H, D], lse [B, H, Tq])``.

    q: ``[B, Tq, H, D]``; k, v: ``[B, Tk, K, D]`` with ``H % K == 0``.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``launches`` counts those launches) or raise.  Not differentiable:
    :func:`flash_attention` is."""
    _check(q, k, v, causal, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError("flash_attention_fwd records no gradient; call "
                         "flash_attention for a differentiable attention")
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, causal, scale, window)
    if _fake(q):
        B, Tq, H, _ = q.shape
        return (torch.empty_like(q),
                q.new_empty((B, H, Tq), dtype=torch.float32))
    return _flash_kernel(q, k, v, causal, scale, window)


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------- backward
def _check_bwd(q, do, lse, delta) -> None:
    B, Tq, H, _ = q.shape
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if do.dtype != q.dtype:
        raise ValueError(f"do must have q's dtype {q.dtype}, got {do.dtype}; "
                         f"cast before the call")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (B, H, Tq) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [B, H, Tq] = "
                             f"{(B, H, Tq)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if not (do.device == lse.device == delta.device == q.device):
        raise ValueError("do, lse and delta must lie on q's device")


@torch.no_grad()
def flash_attention_bwd_plain(q, k, v, do, lse, delta, causal: bool = False,
                              scale: Optional[float] = None,
                              window: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' function in plain PyTorch, dense and in
    float32: ``p = exp(s - lse)`` (exactly 0 where masked, so an empty row
    with ``lse = 0`` contributes nothing), ``ds = p (dp - delta) scale``
    rounded to the operand dtype before ``ds.k`` and ``ds^T.q``, and p
    rounded to do's dtype before ``p^T.do``, as ``_dq_kernel`` and
    ``_dkv_kernel`` round.  Returns ``(dq, dk, dv)`` in the operands'
    dtypes, dk and dv summed over the q heads that share a kv head."""
    _check(q, k, v, causal, window)
    _check_bwd(q, do, lse, delta)
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    rep = H // K
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().permute(0, 2, 1, 3)                      # [B, H, Tq, D]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    dof = do.float().permute(0, 2, 1, 3)
    mask = _mask(Tq, Tk, causal, window, q.device)
    # In place where the dense [B, H, Tq, Tk] temporaries allow: they are
    # the plain version's memory.
    p = torch.matmul(qf, kf.transpose(-1, -2)).mul_(scale)
    p = p.sub_(lse.float()[..., None]).exp_().masked_fill_(~mask, 0.0)
    ds = torch.matmul(dof, vf.transpose(-1, -2))            # dp
    ds = ds.sub_(delta.float()[..., None]).mul_(p).mul_(scale)
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)             # [B, H, Tk, D]
    del ds
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dk = dk.reshape(B, K, rep, Tk, D).sum(dim=2)
    dv = dv.reshape(B, K, rep, Tk, D).sum(dim=2)
    return (dq.permute(0, 2, 1, 3).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _bwd_operands(q, k, v, do, lse, delta):
    """The operands as the backward kernels take them.  One whose head dim
    is not contiguous (an expanded cotangent, for one) is made contiguous,
    and so is a bfloat16 one that TMA cannot map; any other strides go to
    the kernels as they are."""
    q, k, v, do = (x if x.stride(3) == 1 else x.contiguous()
                   for x in (q, k, v, do))
    _check_kernel_operands((("q", q), ("k", k), ("v", v), ("do", do)))
    q, k, v, do = (_tma_operand(x) for x in (q, k, v, do))
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def _bwd_args(q, k, v, do, lse, delta, causal, scale, window):
    """The arguments the two entry points share, around their outputs."""
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    strides = (ctypes.c_int * 12)(*_strides(q), *_strides(k), *_strides(v),
                                  *_strides(do))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    dims = (B, H, K, Tq, Tk, D, strides)
    tail = (float(scale), int(bool(causal)), int(window or 0),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    return ins, dims, tail


def _launch_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
               window: Optional[int]):
    """The dq kernel on operands from :func:`_bwd_operands`."""
    ins, dims, tail = _bwd_args(q, k, v, do, lse, delta, causal, scale,
                                window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _lib("flash_bwd").hvd_flash_bwd_dq(*ins, dq.data_ptr(), *dims,
                                             *_strides(dq), *tail)
    if err != 0:
        raise RuntimeError(f"flash_bwd dq kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_bwd.launches_dq += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                window: Optional[int]):
    """The dk/dv kernel on operands from :func:`_bwd_operands`."""
    ins, dims, tail = _bwd_args(q, k, v, do, lse, delta, causal, scale,
                                window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _lib("flash_bwd").hvd_flash_bwd_dkv(
        *ins, dk.data_ptr(), dv.data_ptr(), *dims, *_strides(dk),
        *_strides(dv), *tail)
    if err != 0:
        raise RuntimeError(f"flash_bwd dk/dv kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches_dkv += 1
    return dk, dv


def flash_attention_bwd(q, k, v, do, lse, delta, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward over one (q, kv) pair: the public counterpart of
    ``_bwd_impl``.

    q, do: ``[B, Tq, H, D]`` (do in q's dtype); k, v: ``[B, Tk, K, D]``;
    lse, delta: float32 ``[B, H, Tq]``, which may come from outside (the
    global logsumexp of ring attention).  Returns ``(dq, dk, dv)`` in the
    operands' dtypes.  CPU tensors take the plain version; CUDA tensors
    launch the dq and the dk/dv kernel (``launches_dq``/``launches_dkv``
    count them) or raise."""
    _check(q, k, v, causal, window)
    _check_bwd(q, do, lse, delta)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    if _on_cpu(q):
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, causal,
                                         scale, window)
    if _fake(q):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ops = _bwd_operands(q, k, v, do, lse, delta)
    dq = _launch_dq(*ops, causal, scale, window)
    return (dq, *_launch_dkv(*ops, causal, scale, window))


flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0


class _FlashAttention(torch.autograd.Function):
    """``o = flash_attention_fwd(q, k, v)[0]`` with the flash backward as
    its gradient (``_flash_core`` and its custom VJP,
    ``horovod_tpu/ops/flash_attention.py:404-429``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        o, lse = flash_attention_fwd(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attrs = (causal, scale, window)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, window = ctx.attrs
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
        # The kernels dot do against v and q in the operands' dtype: an
        # f32 cotangent over bf16 operands is cast, as _flash_bwd casts it.
        dq, dk, dv = flash_attention_bwd(q, k, v, do.to(q.dtype), lse, delta,
                                         causal, scale, window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Memory-efficient exact attention; returns ``o`` only (the JAX
    package's ``flash_attention`` surface), differentiable through the
    flash backward."""
    _check(q, k, v, causal, window)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    return _FlashAttention.apply(q, k, v, causal, scale, window)
