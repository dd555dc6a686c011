# Ported from horovod_tpu/ops/eager.py:31-97 (auto names,
# reset_name_counters, _engine, _ps, _auto_name, _wire_mode), 253-357
# (allreduce and grouped allreduce), 466-478 (broadcast), 599-622
# (broadcast_object) and 817-840 (synchronize/poll/barrier).
"""Eager collective API over per-rank torch tensors — the engine's face.

Port of ``horovod_tpu/ops/eager.py``.  Requests flow through the background
coordinator (``ops/engine.py``) exactly like the reference's enqueue path
(SURVEY.md §3.2): negotiation, fusion, pack, one collective per fused dtype
buffer, unpack.

Where the JAX layer takes a stacked ``[world, *S]`` array, one process here
is one rank: every function takes this rank's own tensor.  A tensor that
is not contiguous on the engine's device (``basics.device()``) is staged
into a contiguous copy there; the result is written back into the caller's
tensor (the in-place forms) or returned on the caller's device.  Every
submit kicks the engine: without a controller (a world of one process)
the cycle runs inline, so a handle is settled by the time its ``_async``
call returns; with one, the kick wakes the cycle thread.
"""

from __future__ import annotations

import itertools
import pickle
from typing import List, Optional, Sequence

import torch

from . import collectives as C
from .engine import CollectiveType
from ..common import basics
from ..common.process_sets import ProcessSet

_name_counter = itertools.count(0)
_group_counter = itertools.count(0)


def reset_name_counters():
    """Auto-generated collective names are part of the negotiation wire
    protocol: they must be identical on every rank, so ``init()`` restarts
    them with the runtime."""
    global _name_counter, _group_counter
    _name_counter = itertools.count(0)
    _group_counter = itertools.count(0)


def _engine():
    st = basics._get_state()
    if not st.initialized or st.engine is None:
        raise basics.NotInitializedError()
    return st.engine


def _ps(process_set: Optional[ProcessSet]) -> int:
    if process_set is None:
        return 0
    if process_set.process_set_id is None:
        raise ValueError("process_set has not been registered via add_process_set()")
    return process_set.process_set_id


def _auto_name(prefix: str, name: Optional[str]) -> str:
    return name if name else f"{prefix}.noname.{next(_name_counter)}"


def _wire_mode(compression) -> Optional[str]:
    """Normalize a ``compression=`` argument to an engine wire-dtype mode.

    Accepts ``None``/``"none"`` (off), ``"bf16"``/``"bfloat16"`` and
    ``"fp16"``/``"float16"``, or a Compressor class that carries a
    ``wire_mode``."""
    if compression is None:
        return None
    if hasattr(compression, "wire_mode"):
        return _wire_mode(compression.wire_mode)
    if isinstance(compression, str):
        c = compression.strip().lower()
        if c in ("", "none"):
            return None
        if c in ("fp16", "float16"):
            return "fp16"
        if c in ("bf16", "bfloat16"):
            return "bf16"
    raise ValueError(
        f"unsupported compression {compression!r}: expected None, 'none', "
        f"'fp16', 'bf16', or a Compression.* cast compressor")


def _item(tensor: torch.Tensor, inplace: bool) -> dict:
    """The engine's view of one tensor: its input on the engine's device,
    contiguous; the output unpack writes; and the tensor ``synchronize``
    returns where that is not the output (the caller's own, for the
    in-place forms; one on the caller's device, for a tensor staged from
    another device)."""
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"collectives take torch tensors, got "
                        f"{type(tensor).__name__}")
    dev = basics.device()
    t = tensor.detach()
    staged = t if t.device == dev and t.is_contiguous() \
        else t.to(dev).contiguous()
    if inplace:
        return dict(tensor=staged, output=staged, target=tensor)
    if t.device == dev:
        return dict(tensor=staged, output=torch.empty_like(staged))
    return dict(tensor=staged, output=torch.empty_like(staged),
                target=torch.empty_like(t))


def _check_op(op: C.ReduceOp):
    if op == C.ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet: it arrives with parallel/adasum.py "
            "(ROADMAP queue 1, hierarchical collectives and Adasum)")


def _submit(items: List[dict]) -> List[int]:
    eng = _engine()
    handles = eng.enqueue_group(items)
    eng.kick()
    return handles


# ------------------------------------------------------------------ allreduce
def allreduce_async(tensor: torch.Tensor, name: Optional[str] = None,
                    op: C.ReduceOp = C.ReduceOp.AVERAGE,
                    prescale_factor: Optional[float] = None,
                    postscale_factor: Optional[float] = None,
                    process_set: Optional[ProcessSet] = None,
                    compression=None, priority: int = 0,
                    inplace: bool = False) -> int:
    """``compression="bf16"``/``"fp16"`` casts a floating tensor to the
    wire dtype in the pack kernel (after the prescale) and back in the
    unpack kernel (before the postscale); the result is in the input dtype.

    ``priority``: higher drains first from the coordinator queue (stable
    within equal priority).  Must be stamped identically on every rank —
    the DistributedOptimizer bindings use reverse registration order so
    first-needed gradients lead each cycle."""
    _check_op(op)
    comp = _wire_mode(compression)
    return _submit([dict(
        _item(tensor, inplace), name=_auto_name("allreduce", name),
        ctype=CollectiveType.ALLREDUCE, reduce_op=op,
        process_set_id=_ps(process_set), prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, compression=comp,
        priority=priority)])[0]


def allreduce(tensor: torch.Tensor, name: Optional[str] = None,
              op: C.ReduceOp = C.ReduceOp.AVERAGE,
              prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None,
              process_set: Optional[ProcessSet] = None,
              compression=None, priority: int = 0,
              inplace: bool = False) -> torch.Tensor:
    return synchronize(allreduce_async(
        tensor, name, op, prescale_factor, postscale_factor, process_set,
        compression, priority, inplace))


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None,
                            op: C.ReduceOp = C.ReduceOp.AVERAGE,
                            prescale_factor: Optional[float] = None,
                            postscale_factor: Optional[float] = None,
                            process_set: Optional[ProcessSet] = None,
                            compression=None,
                            priorities: Optional[Sequence[int]] = None,
                            inplace: bool = False) -> List[int]:
    """Enqueue a group that fuses/executes atomically (reference: N13).

    ``priorities`` (one int per tensor, same on every rank): drain
    priority per member — the group still executes atomically, but its
    position among OTHER clusters in the cycle follows its members'
    priorities."""
    _check_op(op)
    ps_id = _ps(process_set)
    comp = _wire_mode(compression)
    gid = next(_group_counter)
    base = _auto_name("grouped_allreduce", name)
    if priorities is not None and len(priorities) != len(tensors):
        raise ValueError(
            f"priorities must have one entry per tensor: got "
            f"{len(priorities)} for {len(tensors)} tensors")
    # One atomic push: all members negotiate in the same round on every
    # rank, which both preserves fusion atomicity and lets a negotiation
    # error on one member abort the whole group (reference N13).
    return _submit([dict(
        _item(t, inplace), name=f"{base}.{i}",
        ctype=CollectiveType.ALLREDUCE, reduce_op=op, process_set_id=ps_id,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        group_id=gid, compression=comp,
        priority=int(priorities[i]) if priorities is not None else 0)
        for i, t in enumerate(tensors)])


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      name: Optional[str] = None,
                      op: C.ReduceOp = C.ReduceOp.AVERAGE,
                      prescale_factor: Optional[float] = None,
                      postscale_factor: Optional[float] = None,
                      process_set: Optional[ProcessSet] = None,
                      compression=None,
                      priorities: Optional[Sequence[int]] = None,
                      inplace: bool = False):
    return synchronize(grouped_allreduce_async(
        tensors, name, op, prescale_factor, postscale_factor, process_set,
        compression, priorities, inplace))


# ------------------------------------------------------------------ broadcast
def broadcast_many_async(tensors: Sequence[torch.Tensor], names: Sequence[str],
                         root_rank: int = 0,
                         process_set: Optional[ProcessSet] = None,
                         inplace: bool = False) -> List[int]:
    """Broadcast several tensors from ``root_rank``, pushed to the queue at
    once so that one cycle negotiates and fuses them all, cut into batches
    at the fusion threshold (they are not a group: no atomicity)."""
    ps_id = _ps(process_set)
    return _submit([dict(
        _item(t, inplace), name=n, ctype=CollectiveType.BROADCAST,
        root_rank=root_rank, process_set_id=ps_id)
        for t, n in zip(tensors, names)])


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None,
                    inplace: bool = False) -> int:
    return broadcast_many_async([tensor], [_auto_name("broadcast", name)],
                                root_rank, process_set, inplace)[0]


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None,
              inplace: bool = False) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank, name, process_set,
                                       inplace))


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None):
    """Pickle-broadcast an arbitrary Python object (reference:
    ``horovod/torch/functions.py broadcast_object``): its length, then its
    bytes (a broadcast goes by bytes, whatever the dtype)."""
    dev = basics.device()
    payload = pickle.dumps(obj)
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    size = int(broadcast(n, root_rank=root_rank,
                         name=_auto_name("bcast_obj_size", name),
                         process_set=process_set).item())
    data = bytearray(size)
    k = min(len(payload), size)
    data[:k] = payload[:k]
    buf = torch.frombuffer(data, dtype=torch.uint8).to(dev) if data else \
        torch.zeros(0, dtype=torch.uint8, device=dev)
    out = broadcast(buf, root_rank=root_rank,
                    name=_auto_name("bcast_obj", name),
                    process_set=process_set)
    return pickle.loads(out.cpu().numpy().tobytes())


# ------------------------------------------------------------------- control
def synchronize(handle):
    """Wait for handle(s); returns result(s) (reference: mpi_ops.synchronize)."""
    if isinstance(handle, (list, tuple)):
        return [synchronize(h) for h in handle]
    return _engine().synchronize(handle)


def poll(handle) -> bool:
    return _engine().poll(handle)


def barrier(process_set: Optional[ProcessSet] = None):
    """Block until all ranks reach the barrier (reference: hvd.barrier)."""
    ps_id = _ps(process_set)
    eng = _engine()
    h = eng.enqueue(_auto_name("barrier", None), CollectiveType.BARRIER,
                    None, process_set_id=ps_id)
    eng.kick()
    return eng.synchronize(h)
