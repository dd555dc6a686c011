"""Adasum's arithmetic on a working segment: the dots and the combine.

No Pallas counterpart: in the JAX package this arithmetic is jnp code
inside the jitted collective (``horovod_tpu/parallel/adasum.py`` ``_dots``
:34-38, ``adasum_combine`` :41-53 and the halving rounds of ``_vhd``
:224-238), which XLA fuses around its collective-permutes.  Here NCCL
moves the segments, so each round is two kernels of
``ops/csrc/adasum.cu`` on float32 vectors:

- :func:`dots`: ``(a·b, a·a, b·b)`` as a float32 tensor of 3 on the card,
  deterministic (a second call gives the same bits);
- :func:`combine`: the coefficients ``ca = 1 - ab / (2·aa + eps)`` and
  ``cb = 1 - ab / (2·bb + eps)`` from a summed triple on the card, then
  ``ck·kept + cr·received`` with ``(ck, cr) = (ca, cb)`` for the rank that
  keeps the low half (``is_low``) and ``(cb, ca)`` for its partner.

Each wrapper takes CPU tensors through its plain PyTorch version
(:func:`dots_plain`, :func:`combine_plain`), which the CPU tests hold
against the JAX functions; a CUDA tensor launches the kernel or raises.
``dots.launches`` and ``combine.launches`` count kernel launches only.
The combine is bitwise its plain version for the same triple; the dots
agree with theirs to float32 rounding (another order of the sum).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

EPS = 1e-30
_SCRATCH = 3 * 1024        # adasum.cu's kMaxBlocks partial triples


def _check(name: str, *tensors: torch.Tensor) -> torch.device:
    dev, n = tensors[0].device, tensors[0].numel()
    for t in tensors:
        if t.dtype != torch.float32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"{name} takes flat contiguous float32 "
                             f"tensors, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev or t.numel() != n:
            raise ValueError(f"{name} takes tensors of one length on one "
                             f"device, got {t.numel()} on {t.device} beside "
                             f"{n} on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"adasum {what} kernel launch failed: CUDA error "
                           f"{err}")


def dots_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.dot(a, b), torch.dot(a, a), torch.dot(b, b)])


def dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a·b, a·a, b·b)`` of two flat float32 tensors of one length, as a
    float32 tensor of 3 on their device."""
    dev = _check("dots", a, b)
    if dev.type == "cpu":
        return dots_plain(a, b)
    out = torch.empty(3, dtype=torch.float32, device=dev)
    scratch = torch.empty(_SCRATCH, dtype=torch.float32, device=dev)
    _launched(_lib().hvd_adasum_dots(a.data_ptr(), b.data_ptr(), a.numel(),
                                     scratch.data_ptr(), out.data_ptr(),
                                     _stream(dev)), "dots")
    dots.launches += 1
    return out


dots.launches = 0


def coefficients(triple: torch.Tensor, eps: float = EPS):
    """``(ca, cb)`` from ``(ab, aa, bb)``, in float32, as the combine
    kernel computes them."""
    ab, aa, bb = triple[0], triple[1], triple[2]
    return 1.0 - ab / (2.0 * aa + eps), 1.0 - ab / (2.0 * bb + eps)


def combine_plain(kept: torch.Tensor, received: torch.Tensor,
                  triple: torch.Tensor, is_low: bool,
                  out: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    ca, cb = coefficients(triple, eps)
    ck, cr = (ca, cb) if is_low else (cb, ca)
    out.copy_(ck * kept + cr * received)
    return out


def combine(kept: torch.Tensor, received: torch.Tensor,
            triple: torch.Tensor, is_low: bool,
            out: Optional[torch.Tensor] = None,
            eps: float = EPS) -> torch.Tensor:
    """``ck·kept + cr·received`` (flat float32, one length), the
    coefficients from the summed ``triple`` (float32, 3, on their device);
    into ``out``, which may be ``kept`` itself, or a new tensor."""
    if out is None:
        out = torch.empty_like(kept)
    dev = _check("combine", kept, received, out)
    if triple.dtype != torch.float32 or triple.shape != (3,) \
            or triple.device != dev:
        raise ValueError(f"combine takes the float32 triple on {dev}, got "
                         f"{triple.dtype} {tuple(triple.shape)} on "
                         f"{triple.device}")
    if dev.type == "cpu":
        return combine_plain(kept, received, triple, is_low, out, eps)
    n = kept.numel()
    _launched(_lib().hvd_adasum_combine(
        kept.data_ptr(), received.data_ptr(), triple.data_ptr(),
        int(bool(is_low)), float(eps), out.data_ptr(), n, _stream(dev)),
        "combine")
    if n:
        combine.launches += 1
    return out


combine.launches = 0

_VP, _CI, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "hvd_adasum_dots": [_VP, _VP, _LL, _VP, _VP, _VP],
    "hvd_adasum_combine": [_VP, _VP, _VP, _CI, ctypes.c_double, _VP, _LL,
                           _VP],
}
_LIB = []


def _lib():
    if not _LIB:
        lib = _build.load("adasum")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).restype = _CI
            getattr(lib, fn).argtypes = argtypes
        _LIB.append(lib)
    return _LIB[0]
