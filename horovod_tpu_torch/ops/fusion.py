"""The fusion buffer: pack a dtype group of tensors into one flat buffer
before its collective, and unpack the reduced buffer into the outputs.

No Pallas counterpart: the JAX package's fused collective is one jitted XLA
program (``horovod_tpu/ops/engine.py`` ``_build_fused_reduce``,
:1955-2026), which fuses this work around its reduction.  Here the
reduction is one NCCL (or gloo) call, so the work on either side of it is
two kernels, ``hvd_fusion_pack`` and ``hvd_fusion_unpack``
(``ops/csrc/fusion.cu``), one launch each per fused batch and dtype group:

- ``pack``: ``buf[off_i + j] = W(round_T(x_i[j] * round_T(pre)))`` — the
  prescale in the tensors' dtype T, then the cast to the buffer's dtype W
  (the wire dtype of a compressed float group; int32 for a bool, int8,
  uint8 or int16 group that the reduction counts or multiplies wider; else
  T);
- ``unpack``: ``out_i[j] = round_T(T(avg_W(buf[off_i + j])) *
  round_T(post))`` — ``Average``'s division by the set's size in W, the
  cast back to T, then the postscale.  An integer output is cast first
  (an int32 buffer narrowed to int16 wraps, as the JAX program's int16
  sum does) and floor-divided in its own dtype; an integer buffer into a
  float32 output (a reducescatter's ``Average``, ``/`` in the JAX program)
  divides in float32 after the cast, an int32 buffer of int16 sums after
  narrowing to int16 first (``narrow``: the JAX program's int16 sum
  wraps before its ``/``).

A group with no arithmetic (no factor, no wire cast, no division: every
broadcast group, and the gradients of an allreduce without factors on the
way in) goes by bytes: ``hvd_fusion_copy`` copies any dtype, bool and
complex included, with no dtype code — by Hopper's bulk asynchronous copies
when every tensor and its place in the buffer start on a 16-byte boundary,
else by the same 16-byte walk as the arithmetic path.  The arithmetic path
takes float32, float64, bfloat16, float16, int8, uint8, int32 and int64,
and bool and int16 as sources of the widening to int32.

``pack`` writes into a buffer the caller gives (``out=``: the engine's
ping-pong staging slots and fast-lane pins), and both wrappers take any
contiguous tensors, views that start inside a tensor included: a chunk of
a pipelined allreduce is the ``span`` of its dtype group's concatenation
from one element to another, which may begin and end mid-tensor.  No
chunk is made by a ``torch.cat``.

Each wrapper takes CPU tensors through its plain PyTorch version
(``torch.cat``, ``split``, the factor rounded by ``collectives._scale``; a
``torch.cat`` of byte views for the byte path), which the CPU tests hold
against the JAX program; a CUDA tensor launches the kernel or raises.
``pack.launches`` and ``unpack.launches`` count kernel launches only, of
either path.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import _build
from .collectives import _scale, scale_factor

# Dtype codes of fusion.cu's arithmetic path.
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.int32: 3, torch.int64: 4, torch.float64: 5, torch.int8: 6,
          torch.uint8: 7, torch.bool: 8, torch.int16: 9}
_WIRE = (torch.bfloat16, torch.float16)
_WIDENED = (torch.bool, torch.int8, torch.uint8, torch.int16)
_INTEGERS = (torch.int8, torch.uint8, torch.int32, torch.int64)
_AVG_DIVIDE, _AVG_FLOOR, _AVG_NARROW_DIVIDE = 1, 2, 3


def _packs(src: torch.dtype, buf: torch.dtype) -> bool:
    """The casts ``pack`` takes: none, a float group to a wire dtype, or
    a small integer or bool group widened to int32."""
    return (buf == src or (src.is_floating_point and buf in _WIRE)
            or (src in _WIDENED and buf == torch.int32))


def _unpacks(buf: torch.dtype, out: torch.dtype) -> bool:
    """The casts ``unpack`` takes: none, a wire buffer to a float group,
    int32 narrowed to int16, or an integer buffer to float32."""
    return (out == buf or (out.is_floating_point and buf in _WIRE)
            or (buf == torch.int32 and out == torch.int16)
            or (buf in _INTEGERS and out == torch.float32))


def buffer_dtype(dtype: torch.dtype,
                 wire: Optional[torch.dtype]) -> torch.dtype:
    """The buffer's dtype for a group of ``dtype``: the wire dtype for a
    floating group under compression, else the group's own."""
    if wire is not None and dtype.is_floating_point and dtype != wire:
        return wire
    return dtype


def _offsets(sizes: Sequence[int]) -> List[int]:
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + n)
    return offs


def pack_plain(tensors: Sequence[torch.Tensor], buf_dtype: torch.dtype,
               prescale: Optional[float]) -> torch.Tensor:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return _scale(flat, prescale).to(buf_dtype)


def unpack_plain(buf: torch.Tensor, outs: Sequence[torch.Tensor],
                 divisor: int, postscale: Optional[float],
                 narrow: Optional[torch.dtype] = None) -> None:
    dt = outs[0].dtype
    red = buf if narrow is None else buf.to(narrow)
    if not (dt.is_floating_point and buf.dtype.is_floating_point):
        red = red.to(dt)
    if divisor > 1:
        red = (red / divisor if red.dtype.is_floating_point
               else torch.div(red, divisor, rounding_mode="floor"))
    for out, seg in zip(outs, red.split([o.numel() for o in outs])):
        out.copy_(_scale(seg.to(out.dtype), postscale).view(out.shape))


def span(tensors: Sequence[torch.Tensor], start: int,
         end: int) -> List[torch.Tensor]:
    """Flat views of elements ``[start, end)`` of the tensors'
    concatenation, in order, the empty ones left out: the first may start
    and the last may end inside a tensor.  Each tensor must be
    contiguous."""
    out: List[torch.Tensor] = []
    off = 0
    for t in tensors:
        n = t.numel()
        a, b = max(start, off), min(end, off + n)
        if a < b:
            out.append(t.view(-1)[a - off:b - off])
        off += n
        if off >= end:
            break
    return out


def _check(tensors: Sequence[torch.Tensor], what: str) -> torch.device:
    if not tensors:
        raise ValueError(f"{what} needs at least one tensor")
    dt, dev = tensors[0].dtype, tensors[0].device
    for t in tensors:
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"{what} takes one dtype group on one device, "
                             f"got {t.dtype} on {t.device} beside {dt} on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors (the engine "
                             f"stages a strided view into a copy)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {dev}")
    return dev


def _code(dtype: torch.dtype, what: str) -> int:
    """``dtype``'s code; ``TypeError`` where the kernels' arithmetic path
    takes no such dtype (the byte path takes every dtype)."""
    if dtype not in _CODES:
        names = ", ".join(str(d).replace("torch.", "") for d in _CODES)
        raise TypeError(f"the {what} kernel's arithmetic path takes {names}, "
                        f"got {dtype}")
    return _CODES[dtype]


def _table(ptrs: Sequence[int], offs: Sequence[int],
           dev: torch.device) -> torch.Tensor:
    """The kernel's device table: the pointers, then the offsets.  Copied
    from pinned memory on the current stream, so the host never waits."""
    host = torch.tensor(list(ptrs) + list(offs), dtype=torch.int64)
    return host.pin_memory().to(dev, non_blocking=True)


def _factor_arg(factor: Optional[float], dtype: torch.dtype):
    if factor is None or factor == 1.0:
        return 0, 0.0
    return 1, float(scale_factor(factor, dtype))


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"fusion {what} kernel launch failed: CUDA error "
                           f"{err}")


def _byte_sizes(tensors: Sequence[torch.Tensor]) -> List[int]:
    return [t.numel() * t.element_size() for t in tensors]


def _aligned(buf_ptr: int, ptrs: Sequence[int], offs: Sequence[int],
             sizes: Sequence[int]) -> int:
    """1 when the buffer, every non-empty tensor and its place in the
    buffer (byte offsets) start on a 16-byte boundary: the byte path's bulk
    copies."""
    return int(buf_ptr % 16 == 0
               and all(p % 16 == 0 for p, n in zip(ptrs, sizes) if n)
               and all(o % 16 == 0 for o in offs[:-1]))


def _copy(tensors: Sequence[torch.Tensor], buf: torch.Tensor,
          to_buffer: int, dev: torch.device) -> None:
    """``hvd_fusion_copy`` between ``tensors`` and ``buf``'s bytes."""
    sizes = _byte_sizes(tensors)
    offs = _offsets(sizes)
    ptrs = [t.data_ptr() for t in tensors]
    table = _table(ptrs, offs, dev)
    _launched(_lib().hvd_fusion_copy(
        table.data_ptr(), len(tensors), offs[-1], buf.data_ptr(), to_buffer,
        _aligned(buf.data_ptr(), ptrs, offs, sizes), _stream(dev)),
        "pack" if to_buffer else "unpack")


def _pack_bytes(tensors: Sequence[torch.Tensor], dev: torch.device,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The byte path of ``pack``: the tensors' bytes in order, as one
    buffer of their dtype (``out``'s bytes when given)."""
    dt = tensors[0].dtype
    raw = None if out is None else out.view(torch.uint8)
    if dev.type == "cpu":
        parts = [t.reshape(-1).view(torch.uint8) for t in tensors]
        if raw is None:
            return torch.cat(parts).view(dt)
        torch.cat(parts, out=raw)
        return out
    if raw is None:
        raw = torch.empty(sum(_byte_sizes(tensors)), dtype=torch.uint8,
                          device=dev)
    _copy(tensors, raw, 1, dev)
    return raw.view(dt)


def _unpack_bytes(buf: torch.Tensor, outs: Sequence[torch.Tensor],
                  dev: torch.device) -> None:
    """The byte path of ``unpack``: the buffer's bytes into the outputs."""
    if dev.type == "cpu":
        for out, seg in zip(outs, buf.view(torch.uint8).split(
                _byte_sizes(outs))):
            out.reshape(-1).view(torch.uint8).copy_(seg)
        return
    _copy(outs, buf, 0, dev)


def pack(tensors: Sequence[torch.Tensor], buf_dtype: torch.dtype,
         prescale: Optional[float] = None,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One flat buffer of ``buf_dtype`` holding ``tensors`` (one dtype,
    contiguous, one device) in order, each scaled by ``prescale``: ``out``
    when given (flat, contiguous, of ``buf_dtype`` on the tensors' device,
    as many elements as the tensors hold), else a new one."""
    dev = _check(tensors, "pack")
    dt = tensors[0].dtype
    if not _packs(dt, buf_dtype):
        raise ValueError(f"pack casts a float group to bfloat16 or float16, "
                         f"or widens a small integer group to int32, got "
                         f"{dt} -> {buf_dtype}")
    total = sum(t.numel() for t in tensors)
    if out is not None and (out.dtype != buf_dtype or out.device != dev
                            or out.dim() != 1 or not out.is_contiguous()
                            or out.numel() != total):
        raise ValueError(f"pack writes a flat contiguous {buf_dtype} buffer "
                         f"of {total} elements on {dev}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    scale, f = _factor_arg(prescale, dt)
    if buf_dtype == dt and not scale:
        buf = _pack_bytes(tensors, dev, out)
    elif dev.type == "cpu":
        buf = pack_plain(tensors, buf_dtype, prescale)
        if out is None:
            return buf
        out.copy_(buf)
        return out
    else:
        offs = _offsets([t.numel() for t in tensors])
        buf = out if out is not None else torch.empty(
            offs[-1], dtype=buf_dtype, device=dev)
        table = _table([t.data_ptr() for t in tensors], offs, dev)
        _launched(_lib().hvd_fusion_pack(
            table.data_ptr(), len(tensors), offs[-1], buf.data_ptr(),
            _code(dt, "pack"), _code(buf_dtype, "pack"), scale, f,
            _stream(dev)), "pack")
    if dev.type == "cuda":
        pack.launches += 1
    return buf


pack.launches = 0


def unpack(buf: torch.Tensor, outs: Sequence[torch.Tensor], divisor: int = 1,
           postscale: Optional[float] = None,
           narrow: Optional[torch.dtype] = None) -> None:
    """Write the reduced ``buf`` into ``outs`` (one dtype, contiguous, on
    ``buf``'s device, their sizes summing to ``buf``'s): divided by
    ``divisor`` in ``buf``'s dtype when it is above 1 (floor division for
    integers), cast to the outputs' dtype, scaled by ``postscale``.  An
    output may be the packed tensor itself (the in-place forms).
    ``narrow=torch.int16`` passes an int32 buffer's values through int16
    (wrapping) before a float32 output's division."""
    dev = _check(outs, "unpack")
    if buf.device != dev or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("unpack takes a flat contiguous buffer on the "
                         "outputs' device")
    offs = _offsets([o.numel() for o in outs])
    if offs[-1] != buf.numel():
        raise ValueError(f"the outputs hold {offs[-1]} elements, the buffer "
                         f"{buf.numel()}")
    dt = outs[0].dtype
    if not _unpacks(buf.dtype, dt):
        raise ValueError(f"unpack casts a bfloat16 or float16 buffer to a "
                         f"float group, int32 to int16, or an integer buffer "
                         f"to float32, got {buf.dtype} -> {dt}")
    if divisor < 1:
        raise ValueError(f"divisor must be >= 1, got {divisor}")
    if narrow is not None and (narrow, buf.dtype, dt) != (
            torch.int16, torch.int32, torch.float32):
        raise ValueError(f"unpack narrows an int32 buffer to int16 before "
                         f"a float32 output only, got {buf.dtype} -> "
                         f"{narrow} -> {dt}")
    scale, f = _factor_arg(postscale, dt)
    if buf.dtype == dt and divisor == 1 and not scale:
        _unpack_bytes(buf, outs, dev)
    elif dev.type == "cpu":
        unpack_plain(buf, outs, divisor, postscale, narrow)
        return
    else:
        avg = 0
        if narrow is not None:
            avg = _AVG_NARROW_DIVIDE
        elif divisor > 1:
            avg = _AVG_DIVIDE if dt.is_floating_point else _AVG_FLOOR
        table = _table([o.data_ptr() for o in outs], offs, dev)
        _launched(_lib().hvd_fusion_unpack(
            table.data_ptr(), len(outs), offs[-1], buf.data_ptr(),
            _code(buf.dtype, "unpack"), _code(dt, "unpack"), avg,
            int(divisor), scale, f, _stream(dev)), "unpack")
    if dev.type == "cuda":
        unpack.launches += 1


unpack.launches = 0

_VP, _CI, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "hvd_fusion_pack": [_VP, _CI, _LL, _VP, _CI, _CI, _CI, ctypes.c_double,
                        _VP],
    "hvd_fusion_unpack": [_VP, _CI, _LL, _VP, _CI, _CI, _CI, _CI, _CI,
                          ctypes.c_double, _VP],
    "hvd_fusion_copy": [_VP, _CI, _LL, _VP, _CI, _CI, _VP],
}
_LIB = []


def _lib():
    if not _LIB:
        lib = _build.load("fusion")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).restype = _CI
            getattr(lib, fn).argtypes = argtypes
        _LIB.append(lib)
    return _LIB[0]
