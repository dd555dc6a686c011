"""The allreduce family over ``torch.Tensor``, with integer handles.

Port of ``horovod_tpu/torch/mpi_ops.py:35-41, 136-265`` (reference:
``horovod/torch/mpi_ops.py``): ``allreduce``, ``allreduce_``,
``grouped_allreduce`` and their ``_async`` forms, resolved by
``synchronize`` and ``poll``.  These are what ``DistributedOptimizer``
needs.  Allgather, alltoall, reducescatter, join and barrier come with the
collective engine.

The data plane here is a stand-in: each call is one
``torch.distributed.all_reduce(..., async_op=True)`` on the process set's
group (NCCL on the card, gloo on the CPU), with no negotiation and no
fusion, so every rank must issue its calls in the same order (backward
order does that for the optimizer's hooks).  ``prescale_factor`` applies
before the call and ``postscale_factor`` after it; ``Average`` is a sum
divided by the set's size; ``compression="bf16"``/``"fp16"`` casts a
floating tensor to that wire dtype around the call, and the result comes
back in the input's dtype.  In a world of one process the tensor comes back
with only the scale factors applied.  The negotiated, fused engine of
``horovod_tpu/ops/engine.py`` replaces this stand-in in its own slice of
the port; ``priority`` is accepted for its sake and unused here.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import torch

from .common import basics
from .common.process_sets import ProcessSet
from .ops import collectives as C

ReduceOp = C.ReduceOp
Average = C.ReduceOp.AVERAGE
Sum = C.ReduceOp.SUM
Min = C.ReduceOp.MIN
Max = C.ReduceOp.MAX
Product = C.ReduceOp.PRODUCT
Adasum = C.Adasum

_WIRE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}

_handle_counter = itertools.count(1)
_handles: Dict[int, "_PendingOp"] = {}


class _PendingOp:
    """One submitted allreduce: the work in flight (None when there was no
    collective to run), its buffer, and what to do once it completes."""

    def __init__(self, work, buf: torch.Tensor, like: torch.Tensor,
                 divisor: int, postscale: Optional[float],
                 out: Optional[torch.Tensor]):
        self.work = work
        self.buf = buf
        self.like = like
        self.divisor = divisor
        self.postscale = postscale
        self.out = out


def _scale(x: torch.Tensor, factor: Optional[float]) -> torch.Tensor:
    """``x * factor`` in x's dtype; integers scale in float32 and cast back
    (``horovod_tpu/ops/collectives.py:62-68``)."""
    if factor is None or factor == 1.0:
        return x
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        return (x.to(torch.float32) * factor).to(x.dtype)
    return x * factor


def _dist_op(op: ReduceOp):
    import torch.distributed as dist
    return {ReduceOp.AVERAGE: dist.ReduceOp.SUM, ReduceOp.SUM: dist.ReduceOp.SUM,
            ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}[op]


def _submit(tensor: torch.Tensor, op: ReduceOp,
            prescale_factor: Optional[float],
            postscale_factor: Optional[float],
            process_set: Optional[ProcessSet], compression: Optional[str],
            out: Optional[torch.Tensor]) -> int:
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet: it arrives with parallel/adasum.py "
            "(ROADMAP queue 1, hierarchical collectives and Adasum)")
    if compression is not None and compression not in _WIRE_DTYPES:
        raise ValueError(f"compression must be one of "
                         f"{sorted(_WIRE_DTYPES)} or None, got "
                         f"{compression!r}")
    ps = process_set if process_set is not None else \
        basics.global_process_set
    n = ps.size() if basics.size() > 1 else 1
    work = None
    buf = _scale(tensor.detach(), prescale_factor)
    if n > 1:
        if not ps.included(basics.rank()):
            raise ValueError(f"rank {basics.rank()} is not in {ps}")
        wire = _WIRE_DTYPES.get(compression)
        if wire is not None and buf.dtype.is_floating_point:
            buf = buf.to(wire)
    # The result lives in its own buffer, never in the caller's tensor.
    if buf.data_ptr() == tensor.data_ptr():
        buf = buf.clone()
    if n > 1:
        import torch.distributed as dist
        buf = buf.contiguous()
        work = dist.all_reduce(buf, op=_dist_op(op), group=ps.group,
                               async_op=True)
    h = next(_handle_counter)
    _handles[h] = _PendingOp(work, buf, tensor,
                             n if op == ReduceOp.AVERAGE else 1,
                             postscale_factor, out)
    return h


def synchronize(handle):
    """Wait for an async handle; returns the resulting tensor (the input's
    dtype and shape; the tensor itself for the in-place forms)."""
    if isinstance(handle, (list, tuple)):
        return [synchronize(h) for h in handle]
    op = _handles.pop(handle)
    if op.work is not None:
        op.work.wait()
    t = op.buf.to(op.like.dtype)
    if op.divisor > 1:
        t = _scale(t, 1.0 / op.divisor)
    t = _scale(t, op.postscale)
    if op.out is not None:
        with torch.no_grad():
            op.out.copy_(t.reshape(op.out.shape))
        return op.out
    return t


def poll(handle) -> bool:
    """True once ``synchronize(handle)`` would not wait."""
    work = _handles[handle].work
    return work is None or work.is_completed()


# ------------------------------------------------------------------ allreduce
def allreduce_async(tensor: torch.Tensor, name: Optional[str] = None,
                    op: ReduceOp = Average,
                    prescale_factor: Optional[float] = None,
                    postscale_factor: Optional[float] = None,
                    process_set: Optional[ProcessSet] = None,
                    compression: Optional[str] = None,
                    priority: int = 0) -> int:
    """``compression="bf16"``/``"fp16"``: wire-dtype cast around the
    collective; the result returns in the input dtype.  ``name`` and
    ``priority`` are the engine's (negotiation and drain order) and unused
    by this stand-in."""
    return _submit(tensor, op, prescale_factor, postscale_factor,
                   process_set, compression, None)


def allreduce(tensor: torch.Tensor, name: Optional[str] = None,
              op: ReduceOp = Average,
              prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None,
              process_set: Optional[ProcessSet] = None,
              compression: Optional[str] = None) -> torch.Tensor:
    return synchronize(allreduce_async(tensor, name, op, prescale_factor,
                                       postscale_factor, process_set,
                                       compression))


def allreduce_async_(tensor: torch.Tensor, name: Optional[str] = None,
                     op: ReduceOp = Average,
                     prescale_factor: Optional[float] = None,
                     postscale_factor: Optional[float] = None,
                     process_set: Optional[ProcessSet] = None) -> int:
    return _submit(tensor, op, prescale_factor, postscale_factor,
                   process_set, None, tensor)


def allreduce_(tensor: torch.Tensor, name: Optional[str] = None,
               op: ReduceOp = Average,
               prescale_factor: Optional[float] = None,
               postscale_factor: Optional[float] = None,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(allreduce_async_(tensor, name, op, prescale_factor,
                                        postscale_factor, process_set))


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None,
                            op: ReduceOp = Average,
                            prescale_factor: Optional[float] = None,
                            postscale_factor: Optional[float] = None,
                            process_set: Optional[ProcessSet] = None
                            ) -> List[int]:
    return [_submit(t, op, prescale_factor, postscale_factor, process_set,
                    None, None) for t in tensors]


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      name: Optional[str] = None, op: ReduceOp = Average,
                      prescale_factor: Optional[float] = None,
                      postscale_factor: Optional[float] = None,
                      process_set: Optional[ProcessSet] = None):
    return [synchronize(h) for h in grouped_allreduce_async(
        tensors, name, op, prescale_factor, postscale_factor, process_set)]


def grouped_allreduce_async_(tensors: Sequence[torch.Tensor],
                             name: Optional[str] = None,
                             op: ReduceOp = Average,
                             prescale_factor: Optional[float] = None,
                             postscale_factor: Optional[float] = None,
                             process_set: Optional[ProcessSet] = None
                             ) -> List[int]:
    return [_submit(t, op, prescale_factor, postscale_factor, process_set,
                    None, t) for t in tensors]


def grouped_allreduce_(tensors: Sequence[torch.Tensor],
                       name: Optional[str] = None, op: ReduceOp = Average,
                       prescale_factor: Optional[float] = None,
                       postscale_factor: Optional[float] = None,
                       process_set: Optional[ProcessSet] = None):
    return [synchronize(h) for h in grouped_allreduce_async_(
        tensors, name, op, prescale_factor, postscale_factor, process_set)]
