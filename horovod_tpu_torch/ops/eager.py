# Ported from horovod_tpu/ops/eager.py:31-97 (auto names,
# reset_name_counters, _engine, _ps, _auto_name, _wire_mode), 253-357
# (allreduce and grouped allreduce), 361-464 (allgather, grouped allgather
# and reducescatter, with their sharded= and prefetch= 402-460), 466-478
# (broadcast), 501-596 (allgather_object),
# 599-622 (broadcast_object), 624-797 (even and ragged alltoall), 799-815
# (reducescatter), 817-840 (synchronize/poll/barrier) and 842-862 (join).
"""Eager collective API over per-rank torch tensors — the engine's face.

Port of ``horovod_tpu/ops/eager.py``.  Requests flow through the background
coordinator (``ops/engine.py``) exactly like the reference's enqueue path
(SURVEY.md §3.2): negotiation, fusion, pack, one collective per fused dtype
buffer, unpack.

Where the JAX layer takes a stacked ``[world, *S]`` array, one process here
is one rank: every function takes this rank's own tensor, and returns this
rank's result (an allgather's ``[world·S0, *S']``, a reducescatter's
``[S0/world, *S']``, an alltoall's rows from every rank).  A tensor that
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
from typing import Callable, List, Optional, Sequence

import torch

from . import collectives as C
from .engine import CollectiveType, reduce_dtypes
from ..common import basics
from ..common.process_sets import ProcessSet

_name_counter = itertools.count(0)
_group_counter = itertools.count(0)


_counter_resets: List[Callable[[], None]] = []


def register_name_counter_reset(fn: Callable[[], None]) -> None:
    """``fn`` restarts another module's wire-visible name counters with
    this module's (``SyncBatchNorm``'s call-order names)."""
    _counter_resets.append(fn)


def reset_name_counters():
    """Auto-generated collective names are part of the negotiation wire
    protocol: they must be identical on every rank, so ``init()`` restarts
    them with the runtime."""
    global _name_counter, _group_counter
    _name_counter = itertools.count(0)
    _group_counter = itertools.count(0)
    for fn in _counter_resets:
        fn()


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


def _item(tensor: torch.Tensor, inplace: bool = False,
          out_dtype: Optional[torch.dtype] = None) -> dict:
    """The engine's view of one tensor: its input on the engine's device,
    contiguous; for the in-place forms, the output unpack writes (the
    input itself, unless the result's dtype ``out_dtype`` differs; else
    the engine makes one) and the caller's tensor, which ``synchronize``
    fills and returns; otherwise the caller's device, where a result
    staged from another device returns."""
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"collectives take torch tensors, got "
                        f"{type(tensor).__name__}")
    dev = basics.device()
    t = tensor.detach()
    staged = t if t.device == dev and t.is_contiguous() \
        else t.to(dev).contiguous()
    if inplace:
        same = out_dtype is None or out_dtype == t.dtype
        return dict(tensor=staged, output=staged if same else None,
                    target=tensor)
    return dict(tensor=staged, home=None if t.device == dev else t.device)


def _reduced_dtype(tensor, op: C.ReduceOp) -> Optional[torch.dtype]:
    """An allreduce's result dtype (the JAX engine's outcome), or None for
    what is not a tensor (``_item`` refuses it)."""
    if not isinstance(tensor, torch.Tensor):
        return None
    return reduce_dtypes(CollectiveType.ALLREDUCE, tensor.dtype, op)[1]


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
                    inplace: bool = False,
                    hierarchical: Optional[bool] = None) -> int:
    """``compression="bf16"``/``"fp16"`` casts a floating tensor to the
    wire dtype in the pack kernel (after the prescale) and back in the
    unpack kernel (before the postscale); the result is in the input dtype.

    ``priority``: higher drains first from the coordinator queue (stable
    within equal priority).  Must be stamped identically on every rank —
    the DistributedOptimizer bindings use reverse registration order so
    first-needed gradients lead each cycle.

    ``op=Adasum`` combines the ranks' tensors by adaptive summation
    (``parallel/adasum.py``), in float32 over the whole fused buffer of
    the tensor's batch and dtype, and returns the input's dtype.

    ``hierarchical``: per-call override of the two-level schedule (True
    forces it where the world has slices, False pins flat, None defers to
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` and ``HOROVOD_HIER_THRESHOLD``);
    the same on every rank."""
    comp = _wire_mode(compression)
    return _submit([dict(
        _item(tensor, inplace, _reduced_dtype(tensor, op)),
        name=_auto_name("allreduce", name),
        ctype=CollectiveType.ALLREDUCE, reduce_op=op,
        process_set_id=_ps(process_set), prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, compression=comp,
        priority=priority, hierarchical=hierarchical)])[0]


def allreduce(tensor: torch.Tensor, name: Optional[str] = None,
              op: C.ReduceOp = C.ReduceOp.AVERAGE,
              prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None,
              process_set: Optional[ProcessSet] = None,
              compression=None, priority: int = 0,
              inplace: bool = False,
              hierarchical: Optional[bool] = None) -> torch.Tensor:
    return synchronize(allreduce_async(
        tensor, name, op, prescale_factor, postscale_factor, process_set,
        compression, priority, inplace, hierarchical))


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None,
                            op: C.ReduceOp = C.ReduceOp.AVERAGE,
                            prescale_factor: Optional[float] = None,
                            postscale_factor: Optional[float] = None,
                            process_set: Optional[ProcessSet] = None,
                            compression=None,
                            priorities: Optional[Sequence[int]] = None,
                            inplace: bool = False,
                            hierarchical: Optional[bool] = None
                            ) -> List[int]:
    """Enqueue a group that fuses/executes atomically (reference: N13).

    ``priorities`` (one int per tensor, same on every rank): drain
    priority per member — the group still executes atomically, but its
    position among OTHER clusters in the cycle follows its members'
    priorities."""
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
        _item(t, inplace, _reduced_dtype(t, op)), name=f"{base}.{i}",
        ctype=CollectiveType.ALLREDUCE, reduce_op=op, process_set_id=ps_id,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        group_id=gid, compression=comp, hierarchical=hierarchical,
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
                      inplace: bool = False,
                      hierarchical: Optional[bool] = None):
    return synchronize(grouped_allreduce_async(
        tensors, name, op, prescale_factor, postscale_factor, process_set,
        compression, priorities, inplace, hierarchical))


# ------------------------------------------------------------------ allgather
def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    """Every rank's ``[S0, *S']`` concatenated on dim 0 in rank order:
    ``[world·S0, *S']``.  Every rank must give the same shape (the
    negotiation digest holds it; a first dim that differs fails with
    ``NegotiationError`` on every rank, as in the JAX engine)."""
    return _submit([dict(_item(tensor), name=_auto_name("allgather", name),
                         ctype=CollectiveType.ALLGATHER,
                         process_set_id=_ps(process_set))])[0]


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(allgather_async(tensor, name, process_set))


def _grouped_async(tensors, name, prefix, ctype, process_set,
                   priorities=None, **extra) -> List[int]:
    """One atomic push of a group (reference N13): every member
    negotiates and batches together."""
    ps_id = _ps(process_set)
    gid = next(_group_counter)
    base = _auto_name(prefix, name)
    if priorities is not None and len(priorities) != len(tensors):
        raise ValueError(
            f"priorities must have one entry per tensor: got "
            f"{len(priorities)} for {len(tensors)} tensors")
    return _submit([dict(
        _item(t), name=f"{base}.{i}", ctype=ctype, process_set_id=ps_id,
        group_id=gid,
        priority=int(priorities[i]) if priorities is not None else 0,
        **extra) for i, t in enumerate(tensors)])


def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None,
                            process_set: Optional[ProcessSet] = None,
                            priorities: Optional[Sequence[int]] = None,
                            sharded=False, prefetch: bool = False
                            ) -> List[int]:
    """Reference: ``hvd.grouped_allgather`` (upstream v0.28).

    ``sharded=True`` marks the group as the allgather leg of a ZeRO-sharded
    optimizer step (``"full"``: of the FSDP plane): the flag rides the
    fusion key and the negotiation digest, so a sharded group never fuses
    with an unsharded collective of the same shapes, and a rank whose flag
    differs fails negotiation.  ``prefetch=True`` puts the group's batch on
    the engine's prefetch lane (before the fused lane, outside its
    budget): the FSDP optimizer marks the gathers of the next buckets'
    parameters so.  The fusion key holds it, the digest does not: it must
    be the same on every rank."""
    return _grouped_async(tensors, name, "grouped_allgather",
                          CollectiveType.ALLGATHER, process_set, priorities,
                          sharded=sharded, prefetch=prefetch)


def grouped_allgather(tensors: Sequence[torch.Tensor],
                      name: Optional[str] = None,
                      process_set: Optional[ProcessSet] = None,
                      priorities: Optional[Sequence[int]] = None,
                      sharded=False, prefetch: bool = False):
    return synchronize(grouped_allgather_async(tensors, name, process_set,
                                               priorities, sharded, prefetch))


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor],
                                name: Optional[str] = None,
                                op: C.ReduceOp = C.ReduceOp.SUM,
                                process_set: Optional[ProcessSet] = None,
                                priorities: Optional[Sequence[int]] = None,
                                sharded=False) -> List[int]:
    """Reference: ``hvd.grouped_reducescatter`` (upstream v0.28).  See
    :func:`grouped_allgather_async` for ``priorities`` and ``sharded``
    (``"full"`` marks the FSDP gradient reduce-scatter legs)."""
    return _grouped_async(tensors, name, "grouped_reducescatter",
                          CollectiveType.REDUCESCATTER, process_set,
                          priorities, reduce_op=op, sharded=sharded)


def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          name: Optional[str] = None,
                          op: C.ReduceOp = C.ReduceOp.SUM,
                          process_set: Optional[ProcessSet] = None,
                          priorities: Optional[Sequence[int]] = None,
                          sharded=False):
    return synchronize(grouped_reducescatter_async(tensors, name, op,
                                                   process_set, priorities,
                                                   sharded))


def allgather_object(obj, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None,
                     per_rank: Optional[bool] = None) -> list:
    """The list of every rank's pickled object, the same on every rank
    (reference: ``horovod/torch/mpi_ops.py allgather_object``): the
    payloads' lengths, then the payloads padded to the longest, through
    two even allgathers.  ``per_rank=True`` takes a 1-list holding this
    rank's object, as the JAX engine does for a process of one rank."""
    if per_rank is True:
        if not isinstance(obj, (list, tuple)) or len(obj) != 1:
            raise ValueError("per_rank=True in a single-device process: "
                             "pass a 1-list holding this rank's object")
        obj = obj[0]
    dev = basics.device()
    base = _auto_name("allgather_obj", name)
    payload = pickle.dumps(obj)
    sizes = allgather(torch.tensor([len(payload)], dtype=torch.int64,
                                   device=dev),
                      name=f"{base}.sizes", process_set=process_set).tolist()
    m = max(1, max(sizes))
    buf = torch.zeros(m, dtype=torch.uint8)
    buf[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    out = allgather(buf.to(dev), name=f"{base}.payload",
                    process_set=process_set).cpu().view(len(sizes), m)
    return [pickle.loads(out[r, :n].numpy().tobytes())
            for r, n in enumerate(sizes)]


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


# ------------------------------------------------------------------ alltoall
def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: Optional[str] = None,
                   process_set: Optional[ProcessSet] = None):
    """The even form (dim 0 split in ``world`` equal chunks, chunk j to
    rank j, the received chunks concatenated in rank order) returns an
    engine handle; the ragged form (``splits``: the rows this rank sends to
    each rank) a two-stage handle whose size exchange is in flight when
    this returns."""
    if splits is not None:
        return _RaggedAlltoallHandle(tensor, splits,
                                     _auto_name("alltoallv", name),
                                     process_set)
    return _submit([dict(_item(tensor), name=_auto_name("alltoall", name),
                         ctype=CollectiveType.ALLTOALL,
                         process_set_id=_ps(process_set))])[0]


def alltoall(tensor: torch.Tensor, splits=None, name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None):
    """Even: the received rows.  Ragged: ``(output, received_splits)``."""
    return synchronize(alltoall_async(tensor, splits, name, process_set))


def _pad_chunks(x: torch.Tensor, row: Sequence[int], world: int,
                m: int) -> torch.Tensor:
    """``[n, *inner]`` rows split per ``row`` → zero-padded
    ``[world·m, *inner]``, chunk j at rows ``[j·m, j·m + row[j])``."""
    out = x.new_zeros((world, m) + tuple(x.shape[1:]))
    off = 0
    for j in range(world):
        out[j, :row[j]] = x[off:off + row[j]]
        off += row[j]
    if off != x.shape[0]:
        raise ValueError(f"splits sum to {off} but tensor has {x.shape[0]} "
                         f"rows")
    return out.view((world * m,) + tuple(x.shape[1:]))


class _RaggedAlltoallHandle:
    """Uneven alltoall (reference ``hvd.alltoall`` with splits): the send
    matrix first (every rank's splits through one allgather, in flight
    once the constructor returns), then the payload with every chunk
    padded to the largest through one even alltoall, and the real rows
    sliced out.  Both are negotiated collectives on the engine's cycle
    thread.  ``poll``/``synchronize`` advance the two stages; the result
    is ``(output, received_splits)``."""

    def __init__(self, tensor, splits, base, process_set):
        self._ps_obj = process_set
        self._base = base
        self._world = basics._get_state().process_set_table.get(
            _ps(process_set)).size()
        sp = torch.as_tensor(splits, dtype=torch.int64).reshape(-1)
        if sp.numel() != self._world:
            raise ValueError(f"splits must have {self._world} entries, got "
                             f"{sp.numel()}")
        if int(sp.sum()) != tensor.shape[0]:
            raise ValueError(f"splits sum to {int(sp.sum())} but tensor has "
                             f"{tensor.shape[0]} rows")
        self._sp = sp.tolist()
        self._tensor = tensor
        self._result = None
        self._h_payload = None
        self._h_sizes = allgather_async(sp.to(basics.device()),
                                        name=f"{base}.splits",
                                        process_set=process_set)

    def _start_payload(self, sizes: torch.Tensor):
        world = self._world
        self._send = sizes.cpu().view(world, world)
        self._m = max(1, int(self._send.max()))
        padded = _pad_chunks(self._tensor.detach().to(basics.device()),
                             self._sp, world, self._m)
        self._home = self._tensor.device
        self._tensor = None
        self._h_payload = alltoall_async(padded, name=f"{self._base}.payload",
                                         process_set=self._ps_obj)

    def _finish(self, res: torch.Tensor):
        me = basics._get_state().process_set_table.get(
            _ps(self._ps_obj)).ranks.index(basics.rank())
        rsplits = self._send[:, me].clone()
        m = self._m
        out = torch.cat([res[r * m:r * m + int(n)]
                         for r, n in enumerate(rsplits.tolist())])
        self._result = (out.to(self._home), rsplits)

    def poll(self) -> bool:
        if self._result is not None:
            return True
        eng = _engine()
        if self._h_payload is None:
            if not eng.poll(self._h_sizes):
                return False
            self._start_payload(eng.synchronize(self._h_sizes))
        if eng.poll(self._h_payload):
            self._finish(eng.synchronize(self._h_payload))
            return True
        return False

    def synchronize(self):
        if self._result is None:
            eng = _engine()
            if self._h_payload is None:
                self._start_payload(eng.synchronize(self._h_sizes))
            self._finish(eng.synchronize(self._h_payload))
        return self._result


# -------------------------------------------------------------- reducescatter
def reducescatter_async(tensor: torch.Tensor, name: Optional[str] = None,
                        op: C.ReduceOp = C.ReduceOp.SUM,
                        process_set: Optional[ProcessSet] = None) -> int:
    """This rank's chunk of dim 0 of the reduction: ``[S0/world, *S']``.
    ``Sum``/``Average`` need S0 divisible by the set's size; ``Min``,
    ``Max`` and ``Product`` drop the last ``S0 % world`` rows, and
    ``Average`` divides with ``/`` (an integer input returns float32), as
    the JAX engine does."""
    return _submit([dict(_item(tensor),
                         name=_auto_name("reducescatter", name),
                         ctype=CollectiveType.REDUCESCATTER, reduce_op=op,
                         process_set_id=_ps(process_set))])[0]


def reducescatter(tensor: torch.Tensor, name: Optional[str] = None,
                  op: C.ReduceOp = C.ReduceOp.SUM,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(reducescatter_async(tensor, name, op, process_set))


# ------------------------------------------------------------------- control
def synchronize(handle):
    """Wait for handle(s); returns result(s) (reference: mpi_ops.synchronize)."""
    if isinstance(handle, (list, tuple)):
        return [synchronize(h) for h in handle]
    if isinstance(handle, _RaggedAlltoallHandle):
        return handle.synchronize()
    return _engine().synchronize(handle)


def poll(handle) -> bool:
    if isinstance(handle, _RaggedAlltoallHandle):
        return handle.poll()
    return _engine().poll(handle)


def barrier(process_set: Optional[ProcessSet] = None):
    """Block until all ranks reach the barrier (reference: hvd.barrier)."""
    ps_id = _ps(process_set)
    eng = _engine()
    h = eng.enqueue(_auto_name("barrier", None), CollectiveType.BARRIER,
                    None, process_set_id=ps_id)
    eng.kick()
    return eng.synchronize(h)


def join(timeout: Optional[float] = None) -> int:
    """Signal that this rank submits no more work (reference: hvd.join).

    Until every rank has joined, this rank takes part in its peers'
    collectives with identity contributions (zeros for a sum, the dtype's
    max for a ``Min``; ``engine._join_fill_value``); returns the last rank
    to join.  In a world of one process it is a barrier and returns 0.
    Raises ``JoinTimeoutError`` when ``timeout`` expires first (the join
    stays pending)."""
    eng = _engine()
    ctrl = eng.controller
    if ctrl is None:
        barrier()
        return basics.size() - 1
    ctrl.request_join()
    eng._wake.set()
    return ctrl.join_wait(timeout)
