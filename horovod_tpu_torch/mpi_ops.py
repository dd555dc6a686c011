# Ported from horovod_tpu/torch/mpi_ops.py:35-41, 136-166 (synchronize,
# poll), 170-306 (the allreduce family, allgather and broadcast), 308-379
# (broadcast_object, allgather_object, alltoall, reducescatter, barrier,
# join); the grouped allgather and reducescatter from
# horovod_tpu/ops/eager.py:375-464.  What horovod_tpu/ops/bridge.py does for
# a ragged alltoall on per-rank tensors (the splits check, this rank's
# result) is the eager layer's two-stage handle here.
"""The torch binding's collectives over ``torch.Tensor``, with integer
handles.

Port of ``horovod_tpu/torch/mpi_ops.py`` (reference:
``horovod/torch/mpi_ops.py``): ``allreduce``, ``allreduce_``,
``grouped_allreduce``, ``allgather``, ``grouped_allgather``,
``broadcast``, ``broadcast_``, ``alltoall`` (even, or ragged with
``splits``), ``reducescatter``, ``grouped_reducescatter`` and their
``_async`` forms, resolved by ``synchronize`` and ``poll``;
``broadcast_object``, ``allgather_object``, ``barrier`` and ``join``.
Every call goes through the collective engine
(``ops/eager.py`` → ``ops/engine.py``): negotiated by name across ranks,
fused with the other tensors of its cycle, packed, reduced or broadcast by
one collective per fused dtype buffer (NCCL on the card, gloo on the CPU),
and unpacked.  ``name`` is the negotiation key (auto-generated, in call
order, when omitted) and ``priority`` the drain order.  ``prescale_factor``
and ``postscale_factor`` are rounded to the tensor's dtype and applied in
it; ``Average`` divides the sum by the set's size in the reduced buffer's
dtype, with floor division for integers; ``compression="bf16"``/``"fp16"``
casts a floating tensor to that wire dtype around the collective, and the
result comes back in the input's dtype.  In a world of one process the
collective is the identity and the scale factors still apply.

A result has the JAX engine's dtype, which the JAX torch binding casts
back to the input's (``horovod_tpu/torch/mpi_ops.py:151-152``): a bool
``Sum`` counts in int32, an int8 ``Product`` returns int32, an integer
``reducescatter`` ``Average`` float32 (``ops/engine.py`` ``reduce_dtypes``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .common.process_sets import ProcessSet
from .ops import collectives as C
from .common import basics
from .ops import eager

ReduceOp = C.ReduceOp
Average = C.ReduceOp.AVERAGE
Sum = C.ReduceOp.SUM
Min = C.ReduceOp.MIN
Max = C.ReduceOp.MAX
Product = C.ReduceOp.PRODUCT
Adasum = C.Adasum


def synchronize(handle):
    """Wait for an async handle; returns the resulting tensor (the input's
    dtype, shape and device; the tensor itself for the in-place forms).

    Reference: ``horovod/torch/mpi_ops.py synchronize`` resolving the handle
    table filled by ``mpi_ops_v2.cc`` (SURVEY.md §3.2 completion path)."""
    return eager.synchronize(handle)


def poll(handle) -> bool:
    """True once ``synchronize(handle)`` would not wait."""
    return eager.poll(handle)


# ------------------------------------------------------------------ allreduce
def allreduce_async(tensor: torch.Tensor, name: Optional[str] = None,
                    op: ReduceOp = Average,
                    prescale_factor: Optional[float] = None,
                    postscale_factor: Optional[float] = None,
                    process_set: Optional[ProcessSet] = None,
                    compression: Optional[str] = None,
                    priority: int = 0) -> int:
    """``compression="bf16"``/``"fp16"``: wire-dtype cast in the fusion
    kernels; the result returns in the input dtype.  ``priority``:
    coordinator drain priority (higher first; must match across ranks —
    see the engine's priority queue)."""
    return eager.allreduce_async(tensor, name=name, op=op,
                                 prescale_factor=prescale_factor,
                                 postscale_factor=postscale_factor,
                                 process_set=process_set,
                                 compression=compression, priority=priority)


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
    return eager.allreduce_async(tensor, name=name, op=op,
                                 prescale_factor=prescale_factor,
                                 postscale_factor=postscale_factor,
                                 process_set=process_set, inplace=True)


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
    return eager.grouped_allreduce_async(
        tensors, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set)


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
    return eager.grouped_allreduce_async(
        tensors, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set,
        inplace=True)


def grouped_allreduce_(tensors: Sequence[torch.Tensor],
                       name: Optional[str] = None, op: ReduceOp = Average,
                       prescale_factor: Optional[float] = None,
                       postscale_factor: Optional[float] = None,
                       process_set: Optional[ProcessSet] = None):
    return [synchronize(h) for h in grouped_allreduce_async_(
        tensors, name, op, prescale_factor, postscale_factor, process_set)]


# ------------------------------------------------------------------ allgather
def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    return eager.allgather_async(tensor, name=name, process_set=process_set)


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Every rank's tensor concatenated on dim 0 in rank order."""
    return synchronize(allgather_async(tensor, name, process_set))


def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None,
                            process_set: Optional[ProcessSet] = None
                            ) -> List[int]:
    return eager.grouped_allgather_async(tensors, name=name,
                                         process_set=process_set)


def grouped_allgather(tensors: Sequence[torch.Tensor],
                      name: Optional[str] = None,
                      process_set: Optional[ProcessSet] = None):
    return synchronize(grouped_allgather_async(tensors, name, process_set))


def allgather_object(obj, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None,
                     per_rank: Optional[bool] = None) -> list:
    """List of every rank's pickled object (reference:
    ``horovod/torch/mpi_ops.py allgather_object``)."""
    return eager.allgather_object(obj, name=name, process_set=process_set,
                                  per_rank=per_rank)


# ------------------------------------------------------------------ broadcast
def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    return eager.broadcast_async(tensor, root_rank=root_rank, name=name,
                                 process_set=process_set)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def broadcast_async_(tensor: torch.Tensor, root_rank: int = 0,
                     name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> int:
    return eager.broadcast_async(tensor, root_rank=root_rank, name=name,
                                 process_set=process_set, inplace=True)


def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               name: Optional[str] = None,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name, process_set))


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None):
    return eager.broadcast_object(obj, root_rank=root_rank, name=name,
                                  process_set=process_set)


# ------------------------------------------------------------------ alltoall
def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: Optional[str] = None,
                   process_set: Optional[ProcessSet] = None):
    if splits is not None:
        return eager.alltoall_async(tensor, splits=splits, name=name,
                                    process_set=process_set)
    world = (process_set.size() if process_set is not None
             else basics.size())
    if tensor.dim() == 0 or tensor.shape[0] % world != 0:
        raise ValueError(
            f"alltoall with even splits needs dim0 divisible by the "
            f"process set size ({world}); got {tuple(tensor.shape)}")
    return eager.alltoall_async(tensor, name=name, process_set=process_set)


def alltoall(tensor: torch.Tensor, splits=None, name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None):
    """Even splits: returns the gathered tensor.  With ``splits``: returns
    ``(output, received_splits)`` (reference ``hvd.alltoall`` ragged form)."""
    return synchronize(alltoall_async(tensor, splits, name, process_set))


# -------------------------------------------------------------- reducescatter
def reducescatter_async(tensor: torch.Tensor, name: Optional[str] = None,
                        op: ReduceOp = Sum,
                        process_set: Optional[ProcessSet] = None) -> int:
    return eager.reducescatter_async(tensor, name=name, op=op,
                                     process_set=process_set)


def reducescatter(tensor: torch.Tensor, name: Optional[str] = None,
                  op: ReduceOp = Sum,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(reducescatter_async(tensor, name, op, process_set))


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor],
                                name: Optional[str] = None,
                                op: ReduceOp = Sum,
                                process_set: Optional[ProcessSet] = None
                                ) -> List[int]:
    return eager.grouped_reducescatter_async(tensors, name=name, op=op,
                                             process_set=process_set)


def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          name: Optional[str] = None, op: ReduceOp = Sum,
                          process_set: Optional[ProcessSet] = None):
    return synchronize(grouped_reducescatter_async(tensors, name, op,
                                                   process_set))


# ------------------------------------------------------------------- control
def barrier(process_set: Optional[ProcessSet] = None):
    return eager.barrier(process_set=process_set)


def join(timeout: Optional[float] = None) -> int:
    """This rank submits no more work; returns the last rank to join."""
    return eager.join(timeout)
