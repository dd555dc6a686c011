# Ported from horovod_tpu/ops/engine.py: CollectiveType 59-66,
# TensorTableEntry 68-148 (with the sharded 88-98, prefetch 117-126, fast-
# lane 113-118, cache-slot 127-134 and partition 135-141 fields, without the
# donation field), _SPAN_DROPPED/_live_span 178-184, _fusion_key 151-169,
# the pipeline, fast-lane, partition and checkpoint-lane state 218-275 (with
# the state plane's obtain 273-283 and detach 475-485), the
# prefetch counters 320-325, the cycle and negotiation accounting 350-377,
# the tracer 378-386 and 471-474, the sanitizer's install 398-405, observe
# and rollback 662-680 and observe_synthesized 1517-1520 and 1564-1565, the
# autotuner 406-413, the monitor's fault
# hook 557-564, the timeline lanes and trace stamps 576-587, 682-685,
# 957-977, 1021-1047, 1114-1133, 1165-1213, 1270-1272, 1346-1350, 1368-1380,
# 1391 and 1399-1429, the two-level span share 1825-1840,
# start/quiesce/stop/_abort_engine/_settle_queued 416-598 (the staged
# checkpoint items and ping-pong slots of 450-465 and 526-546),
# enqueue/enqueue_group 610-697, _maybe_partition 699-757 (the parts are
# views: _split_parts/_assemble_parts 759-800 have no counterpart),
# synchronize/poll 802-850, the checkpoint lane 853-909, the cycle 911-1133
# (the backlog's fast, prefetch and fused lanes 1076-1094, the checkpoint
# tail 1098-1103, the autotuner's feed 1124-1127), _compute_response_list
# 1136-1335 (the slot-drop hook 1150, the in-flight abort on a leave notice
# 1252-1268, the fast-lane fork 1281-1300), _perform_operation/
# _settle_batch/_inflight_ring 1338-1463 (the ping-pong slots 1351-1361,
# 1405-1411, 1457-1459), _join_fill_value/
# _synthesize_join_entry 1470-1566 (with the sharded token 1537-1548),
# _slice_topology/_hier_decision/
# _hier_ag_decision/_hier_bcast_decision/_batch_payload_bytes 1568-1707,
# _chunk_plan 1709-1734, _on_slot_drop/_fast_pin_key/_execute_fast_lane
# 1736-1790 (a pin holds a resolved plan and a staging buffer, not a
# compiled program), _execute_batch 1792-1889 (with its two-level verdict
# and leg counters 1802-1830 and the pinning 1854-1870) and the builders
# 1896-2094 (fused reduce with its chunks, allreduce with Adasum,
# broadcast, two-level broadcast), 2136-2222 (allgather, two-level
# allreduce and allgather) and 2225-2275 (reducescatter, alltoall).
"""The collective engine: Horovod's background coordinator, on torch tensors.

Port of ``horovod_tpu/ops/engine.py`` (reference: ``horovod/common/
operations.cc`` ``BackgroundThreadLoop``/``RunLoopOnce``, ``tensor_queue.cc``,
``fusion_buffer_cache.cc``, ``response_cache.cc`` — SURVEY.md §2a
N1/N2/N6/N7/N8 and §3.2).  The control plane is the JAX package's: a cycle
thread drains a thread-safe tensor queue, negotiates which tensors are
ready on every rank (the copied ``TCPController`` against the copied
``coordinator.cc``; in a world of one process every submitted tensor is
ready), fuses them into batches by fusion key and threshold, and dispatches
one collective per fused dtype buffer.  The data plane is new: each dtype
group of a batch is packed into one flat buffer by the ``hvd_fusion_pack``
kernel (prescale, wire cast), reduced or broadcast by one
``torch.distributed`` call on the set's process group (NCCL on the card,
gloo on the CPU; none in a set of one, where the collective is the
identity), and unpacked into the outputs by ``hvd_fusion_unpack`` (average,
cast back, postscale) — see ``ops/fusion.py``.  A broadcast, allgather or
alltoall group goes by bytes, whatever its dtype.  Allgather unpacks
through world × N destination views (rank r's part of tensor i lands at
rows ``[r·S0_i, (r+1)·S0_i)`` of its output); reducescatter and alltoall
pack through world × N source views, rank-major, so that rank q's chunk is
contiguous.

An allreduce and a reducescatter give the JAX engine's outcome for every
dtype (``reduce_dtypes``): bool counts in int32 (``Min``/``Max`` stay
bool), int16 travels as int32 and is narrowed back, an int8/int16
``Product`` returns int32 and a uint8 one uint32, complex ``Sum`` reduces
float pairs and complex ``Product`` gathers and multiplies in rank order;
a reducescatter's ``Average`` of integers returns float32, and its complex
``Average``/``Min``/``Max`` work as the JAX engine's do.  The pack kernel
widens and the unpack kernel narrows.  What the JAX engine refuses (a
complex allreduce's ``Average``/``Min``/``Max``, a bool reducescatter's
``Sum``/``Average``) is refused at submission.

Tensors are per-rank: an entry holds this rank's own ``[*S]`` tensor, where
the JAX engine holds the stacked ``[world, *S]``.  The fusion threshold
still counts global stacked bytes (per-rank bytes × the set's size, the JAX
engine's convention), so both engines cut the same batches.

On the card the engine packs, reduces and unpacks on its own stream, from
the cycle thread.  A submit records a ready event on the caller's current
stream, which the engine stream waits on before packing; a batch records a
done event after its unpack, on which the in-flight window settles and
which ``synchronize`` makes the caller's stream wait on.  This engine's
cycle thread is the port's only caller of ``torch.distributed``
collectives.

A joined rank (``join``) takes part in every collective its peers submit
with an identity contribution (``_join_fill_value``), synthesized by the
controller's ``synthesizer`` hook from the negotiated digest (zeros for
``Adasum``: ``adasum(a, 0) = a``).

``Adasum`` (``parallel/adasum.py``) runs on the packed dtype-group buffer
after the wire cast, as the JAX engine's ``_build_fused_reduce`` runs it
on its concatenation: the coefficients are those of the whole fused
buffer, not of each tensor.  A set of a power-of-two size above 1 takes
vector-halving-doubling, its pairwise swaps ``batch_isend_irecv`` calls on
the set's group; any other size gathers and reduces by the tree.  Every
dtype keeps its own (the arithmetic is float32, cast back as the JAX
``_vhd`` casts); a reducescatter refuses ``Adasum``.

The two-level data plane (``parallel/hierarchical.py``): where the global
set has a slice topology (``_slice_topology``: ``HOROVOD_SLICE_MAP``,
``HOROVOD_HIERARCHICAL_LOCAL_SIZE`` or the launcher's uniform ranks per
host), ``init()`` has the engine make one local group per slice and one
cross group per local index (``_make_hier_groups``).  A batch then goes
two-level when its verdict says so (``_hier_decision``,
``_hier_ag_decision``, ``_hier_bcast_decision``: pure functions of the
negotiated batch, the knobs and the static topology, so every rank
decides alike with no control-plane traffic): allreduce ``Sum``/
``Average``/``Min``/``Max`` as reduce-scatter(local) → allreduce(cross) →
allgather(local), ``Adasum`` as the VHD with its local rounds first,
allgather as local then cross, broadcast as the root's cross leg then the
local fan-out.  Each is bitwise the flat path where the JAX engine's is
(min/max, data movement, sums of exact values, the VHD's schedule).

Observability is the JAX engine's, at its sites: the Chrome timeline
(``utils/timeline.py``: a ``QUEUE``, ``NEGOTIATE_<type>``, collective and
``INFLIGHT`` lane per tensor, cycle marks, the ``negotiation``,
``pipeline`` and ``reduce`` counter tracks), the collective tracer
(``trace/``: each tensor's span through queue, negotiation, copy_in,
reduce and drain, armed by ``HOROVOD_TRACE``) and the cycle accounting the
monitor agent reads (``monitor/agent.py``, which reaches the engine by
attribute only).  The collective lane is ``NCCL_<type>`` where the JAX
engine's is ``XLA_<type>`` (``collective_lane``).  On the card a batch's
host dispatch returns before its work ends, so the reduce phase is the
card's own time: armed (a tracer, or a timeline with a file), a batch
records CUDA events on the engine stream before its first pack and after
each dtype group's pack, collective and unpack, and the span's reduce
phase is the elapsed time from the first to the last once the done event
has completed (the in-flight watcher reads them after its wait; an
inline-settled batch is read at a later cycle's drain, or at ``stop``;
the cycle thread never waits for them).  The pack, collective and unpack
times add up in ``reduce_pack_us_total``, ``reduce_collective_us_total``
and ``reduce_unpack_us_total`` (on the CPU, where the work is done when
the call returns, host clock times).  Disarmed, every site is one
attribute check and no event is made beyond the done event.

The ZeRO-sharded optimizer (``optimizer.py``) marks its reduce-scatter and
allgather entries ``sharded`` (``True``, or ``"full"`` for FSDP): part of
the fusion key and of the negotiation digest, so a sharded batch never
fuses with an unsharded one of the same shapes and a rank whose flag
differs fails negotiation.  FSDP's parameter gathers are also marked
``prefetch``: the backlog pushes them on the prefetch lane, ahead of the
fused lane and outside its budget.

The data plane's depth, each off by default as in the JAX engine:

- Chunked pipelining (``HOROVOD_PIPELINE_CHUNK``): ``_chunk_plan`` gives
  each dtype group of a fused allreduce a chunk count; chunk i's views of
  the group's concatenation (``fusion.span``, boundaries on 16 bytes) are
  packed into its slice of the group's buffer, reduced by an asynchronous
  NCCL call, and unpacked once that work is waited on, so that pack i+1
  and unpack i-1 overlap collective i.  The done event follows the last
  unpack.  Bitwise the unchunked path (each element is reduced alike).
- The fast lane (``HOROVOD_FAST_LANE_THRESHOLD``): ungrouped,
  unpartitioned allreduces under the threshold become single-entry
  batches, dispatched first; each pins its resolved plan (buffer and wire
  dtypes, divisor, chunk count) and a staging buffer under its
  response-cache slot (or its name alone), dropped by the controller's
  ``slot_drop_hook`` and on any change of shape, dtype, fusion key, chunk
  knob or two-level verdict.
- Partitioning (``HOROVOD_PARTITION_THRESHOLD``): an allreduce above the
  threshold (global bytes, as the fusion threshold counts) splits at
  enqueue into priority-inheriting parts that are views of its flattened
  input and output (no split or join copy); ``synchronize`` and ``poll``
  wait on every part.  Adasum and grouped members stay whole.
- Ping-pong staging: with the in-flight window, a batch acquires one of
  two slots per dtype before launch and releases it first thing at its
  settle (after its done event); each slot owns a real fusion buffer per
  dtype group, reused and grown to the largest batch.
- The checkpoint lane (``submit_checkpoint_io``): ``CheckpointChunk``
  items run at the tail of a cycle, after every gradient batch, at most
  ``HOROVOD_CKPT_LANE_BUDGET`` a cycle.  Their user is the state plane
  (``HOROVOD_CKPT_DIR``, ``elastic/stateplane.py``), obtained in the
  constructor and detached, never closed, at ``stop``.
- The autotuner (``HOROVOD_AUTOTUNE``, ``ops/autotune.py``): fed once a
  cycle that carried work; its agreement broadcast is enqueued into this
  engine, dispatched like any batch and settled where it is dispatched,
  so that every rank applies a move at the end of the same cycle.

The runtime sanitizer (``HVD_TPU_SANITIZER``, ``analysis/
runtime_sanitizer.py``): installed in the constructor, it tags the
partitioned entries before the push (and rolls them back if the push is
refused) and counts the entries synthesized for a joined rank.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import enum
import heapq
import itertools
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from . import collectives as C
from . import fusion
from .scheduler import (CKPT_LANE, FAST_LANE, FUSED_LANE, PREFETCH_LANE,
                        InflightRing, PingPongBuffers, StallInspector,
                        TensorQueue, partition_name, partition_plan,
                        pop_checkpoint_items, pop_gradient_batches)
from ..common.exceptions import ControlPlaneError
from ..trace import maybe_install
from ..utils.logging import get_logger

log = get_logger()

WIRE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


def collective_lane(ctype) -> str:
    """The timeline's lane for a collective's execution: upstream
    Horovod's ``NCCL_<type>``, where the JAX engine writes ``XLA_<type>``.
    The one place the two names are mapped."""
    return f"NCCL_{ctype.name}"


class CollectiveType(enum.Enum):
    ALLREDUCE = "allreduce"
    ALLGATHER = "allgather"
    BROADCAST = "broadcast"
    ALLTOALL = "alltoall"
    REDUCESCATTER = "reducescatter"
    BARRIER = "barrier"


@dataclasses.dataclass
class TensorTableEntry:
    """One pending collective request (reference: TensorTableEntry, N6)."""
    handle: int
    name: str
    ctype: CollectiveType
    tensor: Any                      # this rank's [*S] (None for barrier)
    reduce_op: C.ReduceOp = C.ReduceOp.AVERAGE
    root_rank: int = 0
    process_set_id: int = 0
    prescale_factor: Optional[float] = None
    postscale_factor: Optional[float] = None
    group_id: int = -1               # grouped ops execute atomically together
    # Wire-dtype compression ("bf16"/"fp16"/None): the pack kernel casts a
    # floating group down to the wire dtype after the prescale, the unpack
    # kernel casts it back before the postscale.  Reduction ops only; part
    # of the fusion key AND the negotiation digest (divergence would
    # execute mismatched batches).
    compression: Optional[str] = None
    # Two-level data plane: per-call override of the engine's
    # HOROVOD_HIERARCHICAL_* default — True forces the two-level schedule
    # for this entry, False forces flat, None defers to the knob (and the
    # HOROVOD_HIER_THRESHOLD crossover for allreduce).  Part of the fusion
    # key but NOT the negotiation digest: the value must be the same on
    # every rank, because batching groups by fusion key.
    hierarchical: Optional[bool] = None
    # ZeRO-sharded data plane: True for the reduce-scatter/allgather legs
    # of DistributedOptimizer(sharded=True), "full" for those of
    # sharded="full" (FSDP).  Part of the fusion key AND the negotiation
    # digest (the controller's "sharded"/"sharded-full" token): a sharded
    # batch never fuses with an ordinary collective (or an FSDP one with a
    # ZeRO-1 one) of the same shapes, and a rank whose flag diverges fails
    # negotiation instead of executing a mismatched batch.
    sharded: Any = False
    # FSDP parameter prefetch: marked on the allgathers that rematerialize
    # the next buckets' parameters.  The backlog pushes their batch on the
    # prefetch lane (before the fused lane, outside its budget).  Part of
    # the fusion key but NOT the digest, like ``hierarchical``: the value
    # must be the same on every rank.
    prefetch: bool = False
    # Drain priority (higher drains first; default 0 = FIFO).  Stamped by
    # the DistributedOptimizer bindings with reverse-registration order so
    # first-needed gradients lead each cycle (ByteScheduler-style priority
    # scheduling); must be identical across ranks for a given name.
    priority: int = 0
    enqueue_time: float = 0.0
    # Latency fast lane: marked at the ready verdict for sub-threshold
    # ungrouped allreduces — the entry dispatches as its own single-tensor
    # batch through its pinned plan and staging buffer, skipping the
    # batch's planning (bitwise-identical results).
    fast_lane: bool = False
    # Response-cache slot (stamped by the controller when this entry's
    # announce rides the warm-path bitvector; -1 until learned): the
    # fast-lane pin key.  Slot ids are server-assigned and digest-scoped,
    # so a pin keyed by a slot is valid for exactly as long as the slot is
    # (coordinated invalidation via the controller's slot_drop_hook).
    cache_slot: int = -1
    # ByteScheduler-style partitioning: a part of a split parent carries
    # (parent_name, index, count) and the parent entry; the parent itself
    # never enters the queue and holds its ``parts`` (views of its
    # flattened input and output), which synchronize waits on.
    partition: Optional[Tuple] = None
    parent: Any = None
    parts: Any = None
    # Lifecycle span (trace.core.TensorSpan) while tracing is armed; the
    # _SPAN_DROPPED sentinel once a claim was dropped (ring full); None
    # before the first drain or when disarmed.
    span: Any = None
    # Where unpack writes: the result's tensor on the engine's device
    # (``tensor`` itself for the in-place forms whose result keeps its
    # dtype; made at submission when not given).  ``target``, when set, is
    # what ``synchronize`` returns, filled from the output unless it is
    # the output's own memory (the caller's tensor for the in-place forms,
    # which the engine may have staged onto its device or into contiguous
    # memory).  ``home``, when set, is the caller's device, where
    # ``synchronize`` returns a result staged from it.
    output: Any = None
    target: Any = None
    home: Any = None
    ready: Any = None                # CUDA event: the inputs are written
    # filled on completion:
    result: Any = None
    done_event: Any = None           # CUDA event: the outputs are written
    error: Optional[BaseException] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)


# A dropped span claim: the entry stays untraced (claimed at most once).
_SPAN_DROPPED = object()


def _live_span(e):
    """The entry's span, or None when untraced or dropped."""
    sp = e.span
    return None if (sp is None or sp is _SPAN_DROPPED) else sp


class _Timing:
    """One batch's reduce-phase marks: CUDA events with timing on the card
    (the first before the first pack, then one after each pack, each
    collective's wait and each unpack, a chunk's or a dtype group's),
    host ``time.monotonic()`` seconds on the CPU (``host``).  ``parts``
    says what each interval was: ``(part, starts, end)``, the part (0
    pack, 1 collective, 2 unpack) running from the latest of the ``starts``
    marks to the ``end`` mark.  ``pending`` holds an inline-settled
    batch's spans until the card is done, for the recorder that claimed
    them."""

    __slots__ = ("host", "marks", "parts", "t_launch", "pending", "recorder",
                 "t_settle")

    def __init__(self, host: bool):
        self.host = host
        self.marks: List[Any] = []
        self.parts: List[Tuple[int, Tuple[int, ...], int]] = []
        self.t_launch = 0.0
        self.pending: List[Any] = []
        self.recorder = None
        self.t_settle = 0.0

    def mark(self) -> int:
        """A new mark on the current stream (the host clock on the CPU);
        returns its index."""
        if self.host:
            self.marks.append(time.monotonic())
        else:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        return len(self.marks) - 1

    def _gap_us(self, a, b) -> float:
        return (b - a) * 1e6 if self.host else a.elapsed_time(b) * 1e3

    def reduce_s(self) -> float:
        """The first mark to the last, in seconds (on the card only once
        they have completed)."""
        return self._gap_us(self.marks[0], self.marks[-1]) * 1e-6

    def parts_us(self) -> Tuple[float, float, float]:
        """(pack, collective, unpack) microseconds summed over the chunks
        and groups; on the card only once the marks have completed.  A
        chunked group's parts overlap: their sum less the first mark to
        the last is the overlap.  Marks with no ``parts`` read as
        consecutive (pack, collective, unpack) triples, a group each."""
        m = self.marks
        parts = self.parts or [((i - 1) % 3, (i - 1,), i)
                               for i in range(1, len(m))]
        out = [0.0, 0.0, 0.0]
        for part, starts, end in parts:
            out[part] += min(self._gap_us(m[s], m[end]) for s in starts)
        return out[0], out[1], out[2]


def _fusion_key(e: TensorTableEntry) -> Tuple:
    """Entries with equal keys may fuse into one batch.

    dtype is deliberately NOT part of the key: a batch groups its tensors
    by dtype (one buffer and one collective per dtype) — this keeps grouped
    ops with mixed fp32/bf16 members atomic in a single batch (reference:
    group table N13 semantics).

    The partition COUNT distinguishes a part from a same-shaped ordinary
    tensor, so that a part's fast-lane pin can never serve an unpartitioned
    entry; parts of equal-shaped parents share one key."""
    return (e.ctype, e.reduce_op, e.root_rank, e.process_set_id,
            e.prescale_factor, e.postscale_factor, e.compression,
            e.sharded, e.hierarchical, e.prefetch,
            e.partition[2] if e.partition is not None else 0)


def reduce_dtypes(ctype: CollectiveType, dtype: torch.dtype,
                  op: C.ReduceOp) -> Tuple[torch.dtype, torch.dtype]:
    """``(buffer dtype, result dtype)`` of a reduction of ``dtype`` under
    ``op``: what the JAX engine gives without x64
    (``horovod_tpu/ops/engine.py`` ``_build_allreduce`` :2028-2073,
    ``_build_reducescatter`` :2225-2260).  ``Adasum`` keeps every dtype,
    as the JAX ``_vhd`` and ``adasum_combine`` cast to float32 and back
    (a complex group keeps its real part; a float out of an integer
    dtype's range converts as the platform converts, in both engines
    undefined), and a reducescatter refuses it (``ValueError``, as
    ``_build_reducescatter`` :2225-2229).  The buffer's dtype is what the
    collective reduces: int32 where the JAX program counts or multiplies
    in a wider type and where int16 travels (NCCL has no int16), the
    group's own otherwise; a complex group reduces its float pairs or is
    gathered.  A reducescatter's ``Average`` divides with ``/``, so an
    integer input comes back float32 (an int16 sum wraps first).  Raises
    ``TypeError`` for what the JAX engine refuses: a complex allreduce's
    ``Average``/``Min``/``Max`` and a bool reducescatter's ``Sum``/
    ``Average`` (its ``psum_scatter`` adds no bool)."""
    P = C.ReduceOp.PRODUCT
    scatter = ctype == CollectiveType.REDUCESCATTER
    if op == C.ReduceOp.ADASUM:
        if scatter:
            raise ValueError(f"reducescatter does not support ReduceOp "
                             f"{op.name}, as the JAX engine does not")
        return dtype, dtype
    if dtype.is_complex:
        if not scatter and op not in (C.ReduceOp.SUM, P):
            raise TypeError(f"allreduce of {dtype} takes Sum and Product, as "
                            f"the JAX engine does, got {op.name}")
        return dtype, dtype
    if dtype == torch.bool:
        if op in (C.ReduceOp.MIN, C.ReduceOp.MAX):
            return dtype, dtype
        if scatter and op != P:
            raise TypeError(f"reducescatter of {dtype} takes Min, Max and "
                            f"Product, as the JAX engine does, got {op.name}")
        return torch.int32, torch.int32
    if op == P and dtype in (torch.int8, torch.uint8, torch.int16):
        return torch.int32, (torch.uint32 if dtype == torch.uint8
                             else torch.int32)
    buf = torch.int32 if dtype == torch.int16 else dtype
    if scatter and op == C.ReduceOp.AVERAGE and not dtype.is_floating_point:
        return buf, torch.float32           # divides with `/`, :2239-2240
    return buf, dtype


def _join_fill_value(ctype: CollectiveType, op: C.ReduceOp,
                     dtype: torch.dtype):
    """A joined rank's implicit contribution: the reduction's identity,
    so that it cannot change the peers' result (plain zeros would zero a
    ``Product`` or clamp a ``Max`` of negatives); zeros for the payload of
    a broadcast, allgather or alltoall."""
    if ctype not in (CollectiveType.ALLREDUCE,
                     CollectiveType.REDUCESCATTER):
        return 0
    if op == C.ReduceOp.PRODUCT:
        return 1
    if op in (C.ReduceOp.MIN, C.ReduceOp.MAX):
        hi = op == C.ReduceOp.MIN          # the identity of Min is the max
        if dtype == torch.bool:
            return hi
        info = (torch.finfo(dtype) if dtype.is_floating_point
                or dtype.is_complex else torch.iinfo(dtype))
        return info.max if hi else info.min
    return 0                               # Sum, Average (divides by world)


def _pairs(t: torch.Tensor) -> torch.Tensor:
    """A contiguous complex tensor as its flat float pairs."""
    return torch.view_as_real(t).reshape(-1)


def _rows(tensors, world: int) -> List[int]:
    """Each tensor's elements in one of ``world`` chunks of dim 0."""
    return [(t.shape[0] // world) * (t.numel() // t.shape[0])
            if t.shape[0] else 0 for t in tensors]


def _views(tensors, sizes: Sequence[int], world: int) -> List[torch.Tensor]:
    """World × N flat views, rank-major: view ``(q, i)`` is elements
    ``[q·n_i, (q+1)·n_i)`` of tensor i."""
    flat = [t.view(-1) for t in tensors]
    return [f[q * n:(q + 1) * n] for q in range(world)
            for f, n in zip(flat, sizes)]


def _dist_op(op: C.ReduceOp):
    import torch.distributed as dist
    ops = {C.ReduceOp.AVERAGE: dist.ReduceOp.SUM,
           C.ReduceOp.SUM: dist.ReduceOp.SUM,
           C.ReduceOp.MIN: dist.ReduceOp.MIN,
           C.ReduceOp.MAX: dist.ReduceOp.MAX,
           C.ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}
    if op not in ops:
        raise ValueError(f"Unsupported reduce op for the fused allreduce: "
                         f"{op!r}")
    return ops[op]


def _wire_view(t: torch.Tensor) -> torch.Tensor:
    """A bool buffer reduces (``Min``/``Max``) as bytes."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _chunk_bounds(n: int, count: int, itemsizes: Sequence[int]) -> List[int]:
    """The ``count + 1`` boundaries of ``count`` chunks of ``n`` elements
    (the JAX plan's count), each inner one rounded down to 16 bytes of
    every dtype in ``itemsizes`` (a chunk view that starts off a 16-byte
    boundary turns off the bulk copies); a chunk is empty only where
    ``n`` is under ``count`` × 16 bytes' worth."""
    g = max(1, 16 // min(itemsizes))
    return ([0] + [(i * n // count) // g * g for i in range(1, count)]
            + [n])


class _Stage:
    """A reusable staging buffer (raw bytes, grown to the largest use): a
    ping-pong slot's for one dtype group, or a fast-lane pin's."""

    __slots__ = ("buf",)

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Pin:
    """A fast-lane tensor's pinned plan: what its allreduce resolved (the
    buffer's dtype — the wire dtype under compression —, the divisor, the
    chunk count) and its staging buffer, with what they were resolved
    from, compared on every use (JAX ``_execute_fast_lane``)."""
    fkey: Tuple
    shape: torch.Size
    dtype: torch.dtype
    chunk_knob: int
    hier: bool
    pack_dtype: torch.dtype
    divisor: int
    chunks: int
    stage: _Stage


# Fast-lane pins kept at most (the JAX engine bounds them by its program
# cache's capacity, 1024 by default).
_PIN_CAPACITY = 1024


@dataclasses.dataclass(frozen=True)
class _HierGroups:
    """This rank's groups of the two-level data plane: its slice's local
    group and the cross group of its local index, with their world ranks
    in group order."""
    topo: Any                        # parallel.topology.SliceTopology
    local: Any
    local_ranks: Tuple[int, ...]
    cross: Any
    cross_ranks: Tuple[int, ...]


class CollectiveEngine:
    """Background coordinator: queue → negotiate → fuse → execute.

    Without a controller (a world of one process) negotiation is local:
    everything submitted is ready.  Multi-process mode plugs a TCP
    controller in at ``self.controller`` so all processes agree on the
    response list before executing identical batches; the execution path
    below is shared by both modes.
    """

    def __init__(self, state):
        self._state = state
        cfg = state.config
        self.queue = TensorQueue()
        self.stall = StallInspector(cfg.stall_check_time_s,
                                    cfg.stall_shutdown_time_s,
                                    cfg.stall_check_disable)
        # Opt-in runtime collective sanitizer (HVD_TPU_SANITIZER=1):
        # records the per-rank submission ledger and stamps entries with
        # seq/call-site tags the controller sends beside its negotiation
        # digest, so cross-rank order divergence fails fast with call-site
        # attribution (analysis/runtime_sanitizer.py).  May replace
        # self.stall with a tightened, ledger-reporting inspector.
        from ..analysis import runtime_sanitizer as _rts
        self.sanitizer = _rts.maybe_install(self)
        self.cycle_time_s = cfg.cycle_time_ms / 1000.0
        self.inline_kick = cfg.inline_kick
        self.fusion_threshold = cfg.fusion_threshold_bytes
        self.max_inflight = cfg.max_inflight
        self._inflight: Optional[InflightRing] = None
        self._backlog: List[tuple] = []       # heap: (lane, -prio, seq, batch)
        self._backlog_seq = itertools.count()
        # Chunked pipelining (HOROVOD_PIPELINE_CHUNK, a local knob the
        # autotuner walks): chunks dispatched (a batch's plan total, 1 for
        # an unchunked batch), and the last cycle's (the timeline's
        # "pipeline" track).
        self.pipeline_chunk_bytes = cfg.pipeline_chunk_bytes
        self.pipeline_chunks_total = 0
        self.last_cycle_chunks = 0
        # Data-plane observability: fused batches dispatched, and dtype
        # groups among them — each is one pack launch, one collective (at
        # a set size above 1) and one unpack launch a chunk.
        self.pipeline_dispatches = 0
        self.fused_groups = 0
        # The latency war: fast_lane_threshold — ungrouped allreduces below
        # it skip the fusion batching, single-tensor batches with pinned
        # plans (_fast_pins: slot id, or name without a slot -> _Pin,
        # invalidated via the controller's slot_drop_hook);
        # partition_threshold — tensors above it split at enqueue into
        # priority-inheriting parts, so that a small high-priority gradient
        # preempts a huge transfer between parts.  The dispatch backlog
        # (ring mode only) is what makes preemption real.
        self.fast_lane_threshold = cfg.fast_lane_threshold_bytes
        self.partition_threshold = cfg.partition_threshold_bytes
        self._fast_pins: Dict[Any, _Pin] = {}
        self.fast_lane_dispatches = 0         # fast-lane batches dispatched
        self.fast_lane_hits = 0               # ... served by a valid pin
        self.partition_splits = 0             # parents split at enqueue
        # Ping-pong staging (made with the in-flight ring): the tokens of
        # each dispatched batch (by id), and each slot's buffer by (dtype
        # key, slot); the executing group's stage.
        self._pingpong: Optional[PingPongBuffers] = None
        self._staging_tokens: Dict[int, Dict[str, Any]] = {}
        self._staging: Dict[Tuple[str, int], _Stage] = {}
        self._stage: Optional[_Stage] = None
        self._batch_chunks = 0          # the executing batch's chunk count
        # The checkpoint lane: items staged by submitting threads (own
        # lock; the cycle thread folds them into the backlog, its only
        # mutator), run at each cycle's tail after every gradient batch.
        self._ckpt_staging: List = []
        self._ckpt_staging_lock = threading.Lock()
        self.ckpt_lane_budget = max(1, int(cfg.ckpt_lane_budget))
        self.ckpt_chunks_dispatched = 0
        self.stateplane = None
        if cfg.ckpt_dir:
            # One plane per directory per PROCESS (stateplane.obtain): it
            # survives elastic re-init — a survivor's in-memory epoch is
            # exactly what a re-joining rank restores from, so it must
            # outlive the generation.  It submits the lane's items.
            from ..elastic.stateplane import obtain as _obtain_plane
            self.stateplane = _obtain_plane(
                cfg.ckpt_dir, rank=getattr(state, "rank", 0),
                world=getattr(state, "size", 1), engine=self,
                chunk_bytes=cfg.ckpt_chunk_bytes)
        # The two-level data plane's knobs (read by the verdicts on every
        # dispatch), its cached slice topology per process set, and its
        # groups (``_make_hier_groups``).
        self.hierarchical_allreduce = cfg.hierarchical_allreduce
        self.hierarchical_allgather = cfg.hierarchical_allgather
        self.hierarchical_broadcast = cfg.hierarchical_broadcast
        self._hier_local_size = cfg.hierarchical_local_size
        self.hier_threshold_bytes = cfg.hier_threshold_bytes
        self.slice_map = cfg.slice_map
        self._slice_topos: Dict[int, Any] = {}
        self._hier: Optional[_HierGroups] = None
        # Leg counters, per batch: one two-level allreduce = 2 local legs
        # (reduce-scatter + allgather) + 1 cross leg; one two-level
        # allgather = 1 local + 1 cross gather; one two-level broadcast =
        # 1 cross leg (the root to each slice) + 1 local fan-out.
        self.hier_dispatches = 0
        self.hier_intra_legs = 0
        self.hier_cross_legs = 0
        self.hier_ag_dispatches = 0
        self.hier_ag_intra_legs = 0
        self.hier_ag_cross_legs = 0
        self.hier_bcast_dispatches = 0
        self.hier_bcast_intra_legs = 0
        self.hier_bcast_cross_legs = 0
        # A rejected HOROVOD_SLICE_MAP, counted once per process set (the
        # probe is cached), so a fleet can see why it stayed flat.
        self.slice_map_fallbacks = 0
        # FSDP parameter prefetch: prefetch-lane batches dispatched, and
        # how many gathers the sharded optimizer dispatched while an
        # earlier bucket's gather was still outstanding (it counts those).
        self.prefetch_dispatches = 0
        self.prefetch_overlapped = 0
        self._streams: Dict[torch.device, Any] = {}
        self._handle_counter = itertools.count(1)
        self._handles: Dict[int, TensorTableEntry] = {}
        self._handles_lock = threading.Lock()
        self._cycle_lock = threading.Lock()  # serializes cycles (bg + kick)
        self._shutdown = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.controller = None       # multi-process TCP controller (optional)
        # Control-plane fault latch (HVD303): set by _abort_engine when a
        # ControlPlaneError (dead peer / round timeout) surfaces from
        # negotiation.  Once set, the engine is cleanly down — every
        # pending/in-flight waiter was settled with the error, and new
        # enqueues raise it immediately instead of queueing into a dead
        # world.
        self._fault: Optional[BaseException] = None
        # Clean world-membership change (protocol v6, NOT a fault): set
        # when the coordinator's leave notice names peers that departed
        # via clean LEAVE.  World-level (default-process-set) work fails
        # with it — the control plane's world shrank but the data-plane
        # world is still the old fixed size, so executing a shrunk-world
        # verdict would wedge the transport.
        self._world_changed: Optional[BaseException] = None
        # On the CPU the gloo collective blocks the cycle thread until it
        # completes; on the card the launches are asynchronous.
        self._serialize_launches = state.device.type == "cpu"
        # Control-plane observability: cumulative negotiation wall time and
        # round count (multi-process mode only); the timeline gets a
        # per-cycle counter track.
        self.negotiation_us_total = 0.0
        self.negotiation_cycles = 0
        self.last_negotiation_us = 0.0
        # Whole-cycle wall-time accounting (drain + negotiate + fuse +
        # dispatch), which the monitor aggregates into slowest-rank and
        # cycle-time-spread attribution.  `monitor` is a MonitorAgent that
        # init() installs when HOROVOD_MONITOR=1: None costs one attribute
        # check a cycle.
        self.cycle_us_total = 0.0
        self.cycle_count = 0
        self.last_cycle_ts = 0.0
        self._cycle_index = 0
        self.monitor = None
        # Collective tracing (HOROVOD_TRACE, trace/): per-tensor lifecycle
        # spans stamped through the cycle below.  None when disarmed —
        # every stamp site is then one attribute check.
        self.tracer = maybe_install(cfg, rank=getattr(state, "rank", 0))
        # The reduce phase's parts, summed over the timed batches (armed
        # only): the card's time on its stream on the card.
        self.reduce_pack_us_total = 0.0
        self.reduce_collective_us_total = 0.0
        self.reduce_unpack_us_total = 0.0
        # The three parts' sum less the batches' spans: what the chunks'
        # pack, collective and unpack overlapped (0 unchunked).
        self.reduce_overlap_us_total = 0.0
        self.timed_batches = 0
        self._timing: Optional[_Timing] = None    # the executing batch's
        self._unread: List[_Timing] = []          # inline, card unread
        # The thread running a cycle: a submission from inside a cycle
        # (the autotuner's agreement) wakes the cycle thread instead of
        # running a nested cycle inline.
        self._cycle_owner: Optional[int] = None
        # Online autotuning (reference N9 parameter manager): built at the
        # first cycle, once the controller (multi-process) has attached,
        # so that its coordinates see it.  Agreement handles settle where
        # their batch is dispatched (``_perform_operation``).
        self._autotune = cfg if cfg.autotune else None
        self.autotuner = None
        self._agreements: set = set()

    @property
    def _timeline(self):
        """The runtime's timeline (``basics``), or None."""
        return getattr(self._state, "timeline", None)

    def _armed(self) -> bool:
        """Whether batches record their reduce-phase marks."""
        tl = self._timeline
        return self.tracer is not None or (tl is not None and tl.enabled)

    # ------------------------------------------------------------- lifecycle
    def start(self):
        self._thread = threading.Thread(
            target=self._background_loop, name="hvd-torch-coordinator",
            daemon=True)
        self._thread.start()

    def quiesce(self, timeout: float = 10.0) -> bool:
        """Stop the cycle thread at a round boundary for a CLEAN departure.

        Sets the shutdown flag and joins the thread WITHOUT severing the
        controller socket first: in a healthy world the in-flight
        lock-step round completes in milliseconds and the thread exits at
        the loop check, leaving the socket quiet — the precondition for
        ``controller.leave()`` (the LEAVE frame must not interleave with a
        round in flight).  Returns True when the thread exited cleanly
        with no fault latched; False (thread wedged — a peer is already
        gone or the coordinator is stuck) tells the caller to fall back to
        the legacy ``interrupt()`` sever."""
        self._shutdown.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                return False
            self._thread = None
        return self._fault is None

    def stop(self):
        self._shutdown.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # The cycle thread is gone: this thread is now the backlog's sole
        # mutator, so staged checkpoint items can fold in safely.
        if self._fault is None:
            self._drain_ckpt_staging()
        if self._backlog and self._fault is None:
            # Undispatched ready batches (the backlog only defers dispatch
            # while the window is full): dispatch them now, before the
            # ring drains — their waiters must not outlive the engine
            # unsignalled.  Checkpoint-lane items run too (the shutdown
            # finishes the write instead of abandoning it).  The fault
            # path already settled both.
            while self._backlog:
                lane, _, _, item = heapq.heappop(self._backlog)
                if lane == CKPT_LANE:
                    self._run_ckpt_item(item)
                else:
                    self._perform_operation(item)
        if self._inflight is not None:
            # Settles every dispatched batch first: a waiter blocked in
            # synchronize() must never outlive the watcher unsignalled.
            self._inflight.stop()
            self._inflight = None
        if self._unread and self._fault is None:
            # Inline-settled batches whose card time is still unread: the
            # engine is going, so wait for them here (not after a fault:
            # the card may never finish a dead generation's work).
            self._read_timings(wait=True)
        if self.tracer is not None:
            # After the ring: settling commits spans, and the trace file
            # must hold them all before the final flush.
            self.tracer.close()
        if self.stateplane is not None:
            # After the backlog drain above: any in-flight durable write
            # has finished (or failed with attribution).  DETACH, never
            # close — the plane (its shard server + in-memory epoch)
            # survives the engine, so a re-joining rank can still restore
            # from this survivor while the world re-forms.  Commits
            # between generations write inline.
            if self.stateplane.engine is self:
                self.stateplane.engine = None
            self.stateplane = None

    def _abort_engine(self, exc: BaseException, busy: bool = False):
        """Clean engine shutdown on a control-plane fault (HVD303).

        Invariant restored here: NO waiter may hang.  Every entry still
        queued is settled with the error, the in-flight ring fails its
        window without blocking on device results that may never come
        (a collective whose participant died can block forever), and new
        enqueues raise immediately.  Runs on the cycle thread; idempotent.

        ``busy`` is the caller's hint that the failing cycle itself was
        carrying entries; together with the queue/ring state it picks the
        log severity — losing a peer with NO work outstanding is the
        shape of an ordinary staggered clean shutdown (the first rank to
        leave severs its socket and the server declares it dead; no wire
        protocol distinguishes that from a crash), so it must not put an
        ERROR in every clean run's logs."""
        if self._fault is not None:
            return
        self._fault = exc
        # Everything still waiting to negotiate fails now — the control
        # plane will never answer it.
        pending = self.queue.drain()
        idle = (not busy and not pending and not self._backlog
                and (self._inflight is None or len(self._inflight) == 0))
        if idle:
            log.warning(
                "control plane lost peer(s) with no work outstanding — a "
                "staggered clean shutdown looks exactly like this (a peer "
                "crash between bursts does too); shutting the engine down: "
                "%s", exc)
        else:
            log.error("control plane failed; shutting the engine down "
                      "cleanly: %s", exc)
        self._settle_queued(pending, exc)
        # Ready-but-undispatched batches parked in the backlog are waiters
        # too: settle them with the fault.  Checkpoint-lane items fail
        # their write instead (the previous durable write stays the
        # restore point), the staged ones too.
        self._drain_ckpt_staging()
        while self._backlog:
            lane, _, _, item = heapq.heappop(self._backlog)
            if lane == CKPT_LANE:
                try:
                    item.fail(exc)
                except Exception:  # noqa: BLE001 - keep the abort going
                    log.exception("checkpoint-lane abort settle failed")
            else:
                self._settle_batch(item, None, exc)
        if self._pingpong is not None:
            # Every staging slot settles exactly once: outstanding tokens
            # are released (a racing watcher settle is then a no-op) and
            # no dispatcher may block on a slot the wedged watcher will
            # never free.
            self._pingpong.abort()
        if self._inflight is not None:
            self._inflight.abort(exc)
        ctl = self.controller
        if ctl is not None:
            # Join waiters are part of the invariant too: the all-joined
            # verdict can never arrive from a dead control plane.
            try:
                ctl.fail_join(exc)
            except Exception:  # noqa: BLE001 - keep the abort going
                log.exception("failing join waiters failed")
        mon = self.monitor
        if mon is not None:
            try:
                mon.on_peer_failure(getattr(exc, "dead_ranks", []) or [],
                                    str(exc))
            except Exception:  # noqa: BLE001 - telemetry only
                log.exception("monitor peer-failure hook failed")
        # Stop cycling: further lock-step rounds against a stopped server
        # would only churn errors.  basics.shutdown() still runs the full
        # teardown (thread join, controller close) afterwards.
        self._shutdown.set()

    def _settle_queued(self, entries, exc: BaseException):
        """Settle queued-but-never-negotiated entries with a fault — THE
        one implementation of the no-waiter-may-hang invariant for the
        pre-negotiation stage (both _abort_engine's drain and the
        enqueue-vs-abort race path funnel through here)."""
        tl = self._timeline
        tr = self.tracer
        for e in entries:
            e.error = exc
            if tl is not None:
                tl.end_activity(e.name, "QUEUE")
            sp = _live_span(e) if tr is not None else None
            if sp is not None:
                # Requeued entries may already carry a claimed span: commit
                # it as aborted so the ring slot is reclaimable.
                sp.error = True
                tr.commit(sp)
            self.queue.mark_done(e)
            e.done.set()

    @property
    def fault(self) -> Optional[BaseException]:
        """The control-plane fault (HVD303) that shut this engine down, or
        ``None`` while healthy.  ``basics.shutdown`` keys its
        abrupt-teardown path off it."""
        return self._fault

    @property
    def world_changed(self) -> Optional[BaseException]:
        """The ``PeerLeftInterrupt`` latched when peers departed via clean
        LEAVE (protocol v6), or ``None``.  NOT a fault: world-level work
        fails with it until the world re-forms."""
        return self._world_changed

    # ------------------------------------------------------------- submit API
    def enqueue(self, name: str, ctype: CollectiveType, tensor,
                reduce_op=C.ReduceOp.AVERAGE, root_rank: int = 0,
                process_set_id: int = 0, prescale_factor=None,
                postscale_factor=None, group_id: int = -1,
                compression: Optional[str] = None, priority: int = 0,
                output=None, target=None,
                hierarchical: Optional[bool] = None, sharded: Any = False,
                prefetch: bool = False) -> int:
        return self.enqueue_group([dict(
            name=name, ctype=ctype, tensor=tensor, reduce_op=reduce_op,
            root_rank=root_rank, process_set_id=process_set_id,
            prescale_factor=prescale_factor, postscale_factor=postscale_factor,
            group_id=group_id, compression=compression, priority=priority,
            output=output, target=target, hierarchical=hierarchical,
            sharded=sharded, prefetch=prefetch)])[0]

    def enqueue_group(self, items: Sequence[dict]) -> List[int]:
        """Enqueue several entries atomically w.r.t. the drain — a cycle
        sees all of them or none, so grouped members always negotiate (and
        batch) together (reference: group_table N13).  On the card, one
        ready event is recorded on the caller's current stream for them
        all: the engine stream waits on it before packing."""
        if self._fault is not None:
            # The control plane is down (dead peer / round timeout): fail
            # fast with the original HVD303 error instead of queueing work
            # no negotiation round will ever answer.
            raise self._fault
        if self._world_changed is not None and any(
                int(kw.get("process_set_id", 0) or 0) == 0 for kw in items):
            # Peers departed via clean LEAVE (protocol v6): world-level
            # work cannot run until the world re-forms.
            raise self._world_changed
        entries = []
        for kw in items:
            handle = next(self._handle_counter)
            e = TensorTableEntry(handle=handle, **kw)
            # Refused here, never from the cycle thread: what the JAX
            # engine refuses too.
            self._check_entry(e)
            if e.output is None:
                e.output = self._make_output(e)
            entries.append(e)
        cuda = [e.tensor.device for e in entries
                if e.tensor is not None and e.tensor.device.type == "cuda"]
        if cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cuda[0]))
            for e in entries:
                e.ready = ready
        # ByteScheduler partitioning: tensors above the threshold split
        # into priority-inheriting parts HERE, before the queue — the parts
        # are what negotiate (under sub-names every rank derives alike);
        # the parent stays handle-registered and synchronize waits on its
        # parts, invisibly to the caller.
        queued = self._maybe_partition(entries)
        if self.sanitizer is not None:
            # BEFORE the push: the cycle thread may drain a pushed entry
            # within microseconds, and an untagged digest racing a tagged
            # peer announce would be a false mismatch.
            self.sanitizer.observe(queued)
        with self._handles_lock:
            for e in entries:
                self._handles[e.handle] = e
        try:
            self.queue.push_many(queued)
        except ValueError:
            with self._handles_lock:
                for e in entries:
                    self._handles.pop(e.handle, None)
            if self.sanitizer is not None:
                # Duplicate-name rejection is rank-local: peers never see
                # these entries, so the advanced seq counters must be
                # rolled back or every later tag skews cross-rank.
                self.sanitizer.rollback(queued)
            raise
        tl = self._timeline
        if tl is not None:
            for e in queued:
                tl.start_activity(e.name, "QUEUE")
        fault = self._fault
        if fault is not None:
            # Lost the race with _abort_engine (the fault landed between
            # the guard above and the push).  Drain-as-claim: the queue pop
            # is atomic, so only entries still queued are ours to settle.
            self._settle_queued(self.queue.drain(), fault)
        self._wake.set()
        return [e.handle for e in entries]

    def _check_entry(self, e: TensorTableEntry) -> None:
        """Raise for a submission the JAX engine refuses: a complex
        ``Average``/``Min``/``Max``; an ``Adasum`` reducescatter; a 0-d
        tensor to a collective along
        dim 0; a ``Sum``/``Average`` reducescatter or an alltoall whose dim
        0 does not divide by the set's size."""
        t, ct = e.tensor, e.ctype
        if ct in (CollectiveType.ALLREDUCE, CollectiveType.REDUCESCATTER):
            reduce_dtypes(ct, t.dtype, e.reduce_op)
        if ct not in (CollectiveType.ALLGATHER, CollectiveType.ALLTOALL,
                      CollectiveType.REDUCESCATTER):
            return
        if t.dim() == 0:
            raise ValueError(f"{ct.value} of {e.name!r} runs along dim 0 "
                             f"and takes no 0-d tensor")
        world = self._state.process_set_table.get(e.process_set_id).size()
        even = ct == CollectiveType.ALLTOALL or e.reduce_op in (
            C.ReduceOp.SUM, C.ReduceOp.AVERAGE)
        if ct != CollectiveType.ALLGATHER and even and t.shape[0] % world:
            raise ValueError(f"{ct.value} of {e.name!r} needs dim 0 "
                             f"divisible by the set's size {world}, got "
                             f"{tuple(t.shape)}")

    def _maybe_partition(
            self, entries: List[TensorTableEntry]) -> List[TensorTableEntry]:
        """Split oversized allreduce entries into parts (ByteScheduler
        partitioning): returns the queue-facing entry list, parents
        replaced by their parts.  Eligibility and the plan are pure
        functions of the negotiated (shape, dtype) and the fleet-wide
        threshold, so every rank derives the same sub-names and shapes.
        Adasum is excluded (its dot products span the whole vector:
        splitting changes the math); grouped members stay whole (groups
        are atomic).  A part is a view of the parent's flattened input
        and of its output: no split copy before, no join copy after."""
        thr = self.partition_threshold
        if thr <= 0:
            return list(entries)
        out: List[TensorTableEntry] = []
        for e in entries:
            if (e.ctype != CollectiveType.ALLREDUCE or e.group_id >= 0
                    or e.tensor is None
                    or e.reduce_op == C.ReduceOp.ADASUM
                    or self._global_nbytes(e) <= thr):
                out.append(e)
                continue
            # The threshold counts global bytes (the fusion threshold's
            # convention, and the gate's above); the plan runs over this
            # rank's flat tensor, so scale it down by the set's size —
            # the gate and the plan never disagree about a split.
            world = self._state.process_set_table.get(
                e.process_set_id).size()
            plan = partition_plan(e.tensor.numel(), e.tensor.element_size(),
                                  max(1, thr // max(1, world)))
            if len(plan) <= 1:
                out.append(e)
                continue
            src, dst = e.tensor.view(-1), e.output.view(-1)
            k = len(plan)
            subs = []
            for i, (off, ln) in enumerate(plan):
                sub = TensorTableEntry(
                    handle=next(self._handle_counter),
                    name=partition_name(e.name, i, k), ctype=e.ctype,
                    tensor=src[off:off + ln], reduce_op=e.reduce_op,
                    root_rank=e.root_rank, process_set_id=e.process_set_id,
                    prescale_factor=e.prescale_factor,
                    postscale_factor=e.postscale_factor,
                    compression=e.compression,
                    hierarchical=e.hierarchical,
                    priority=e.priority,          # priority inheritance
                    output=dst[off:off + ln], ready=e.ready)
                sub.partition = (e.name, i, k)
                sub.parent = e
                subs.append(sub)
            e.parts = subs
            out.extend(subs)
            self.partition_splits += 1
        return out

    def _make_output(self, e: TensorTableEntry):
        """The result's tensor on the tensor's device: an allgather's is
        world× longer in dim 0, a reducescatter's a world-th (the rows
        past ``world × (S0 // world)`` of a ``Min``/``Max``/``Product``
        are dropped, as the JAX engine drops them)."""
        t = e.tensor
        if t is None:
            return None
        world = self._state.process_set_table.get(e.process_set_id).size()
        shape, dt = tuple(t.shape), t.dtype
        if e.ctype in (CollectiveType.ALLREDUCE,
                       CollectiveType.REDUCESCATTER):
            dt = reduce_dtypes(e.ctype, dt, e.reduce_op)[1]
        if e.ctype == CollectiveType.ALLGATHER:
            shape = (world * shape[0],) + shape[1:]
        elif e.ctype == CollectiveType.REDUCESCATTER:
            shape = (shape[0] // world,) + shape[1:]
        return torch.empty(shape, dtype=dt, device=t.device)

    def synchronize(self, handle: int, timeout: Optional[float] = None):
        """Block until the handle's collective completed; return its
        result, the output tensor (the caller's own tensor where the
        entry has a ``target``).  On the card the caller's current stream
        waits on the batch's done event: the host does not.

        Reference parity: ``horovod/torch/mpi_ops.py synchronize()``."""
        with self._handles_lock:
            e = self._handles.get(handle)
        if e is None:
            raise ValueError(f"Unknown handle {handle}")
        parts = e.parts
        if parts is not None:
            # A partitioned entry waits on every part; its output is
            # whole once they are (the parts wrote views of it).
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            for s in parts:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if not s.done.wait(left):
                    raise TimeoutError(
                        f"Collective {e.name!r} did not complete within "
                        f"{timeout}s ({sum(1 for p in parts if p.done.is_set())}"
                        f"/{len(parts)} parts settled)")
            with self._handles_lock:
                self._handles.pop(handle, None)
            # The parts point at the parent and it at them: drop its end,
            # so that the parent, its input and its output go with the
            # caller's last reference, not at the next cycle collection.
            e.parts = None
            err = next((s.error for s in parts if s.error is not None), None)
            if err is not None:
                raise err
            events = {id(s.done_event): s.done_event for s in parts
                      if s.done_event is not None}
            for ev in events.values():
                torch.cuda.current_stream(e.output.device).wait_event(ev)
            e.result = e.output
        else:
            if not e.done.wait(timeout):
                raise TimeoutError(f"Collective {e.name!r} did not complete "
                                   f"within {timeout}s")
            with self._handles_lock:
                self._handles.pop(handle, None)
            if e.error is not None:
                raise e.error
            if e.done_event is not None:
                torch.cuda.current_stream(e.result.device).wait_event(
                    e.done_event)
        t = e.target
        if t is None:
            if e.home is not None and e.result is not None:
                return e.result.to(e.home)
            return e.result
        if t.device != e.result.device or t.data_ptr() != e.result.data_ptr():
            with torch.no_grad():
                t.copy_(e.result)
        return t

    def poll(self, handle: int) -> bool:
        with self._handles_lock:
            e = self._handles.get(handle)
        if e is None:
            return True
        if e.parts is not None:
            return all(s.done.is_set() for s in e.parts)
        return e.done.is_set()

    # ------------------------------------------------------- checkpoint lane
    def submit_checkpoint_io(self, items: Sequence) -> None:
        """Queue checkpoint-lane work items (``CheckpointChunk``): local
        writes scheduled at ``CKPT_LANE`` — strictly after every gradient
        batch, popped by their own per-cycle budget
        (``HOROVOD_CKPT_LANE_BUDGET``).  Items are plain local-I/O
        callables, never negotiated: zero control-plane bytes, no
        cross-rank ordering requirement.  After a fault the lane is
        closed: items fail at once so the write job abandons its epoch
        instead of queueing into a dead engine."""
        # Stage, never touch the heap: this runs on the caller's thread,
        # and a heappush racing the cycle thread's heappop would corrupt
        # the backlog order every rank must share.  The cycle thread folds
        # the staging in at its next turn.  The fault/shutdown check lives
        # INSIDE the staging lock: _abort_engine latches the fault BEFORE
        # draining the staging under this same lock, so an item either
        # lands before that drain (and is failed there) or observes the
        # latched fault here — never neither.
        with self._ckpt_staging_lock:
            fault = self._fault
            stopped = fault is not None or self._shutdown.is_set()
            if not stopped:
                self._ckpt_staging.extend(items)
        if stopped:
            for it in items:
                try:
                    it.fail(fault or RuntimeError("engine stopped"))
                except Exception:  # noqa: BLE001 - settle the rest
                    log.exception("checkpoint item fail hook failed")
            return
        self._wake.set()

    def _drain_ckpt_staging(self) -> None:
        """Fold staged checkpoint items into the backlog heap — CYCLE
        THREAD ONLY (the heap has exactly one mutator)."""
        with self._ckpt_staging_lock:
            items, self._ckpt_staging = self._ckpt_staging, []
        for it in items:
            heapq.heappush(
                self._backlog,
                (CKPT_LANE, -int(getattr(it, "priority", 0)),
                 next(self._backlog_seq), it))

    def _run_ckpt_item(self, item) -> None:
        """Run one checkpoint-lane item on the cycle thread.  The item
        owns its own retries and failure attribution; the engine only
        guarantees that a raising item cannot kill the cycle loop."""
        try:
            item.run()
            self.ckpt_chunks_dispatched += 1
        except BaseException:  # noqa: BLE001 - the cycle must survive
            log.exception("checkpoint-lane item %r failed",
                          getattr(item, "name", item))

    # ------------------------------------------------------------- main loop
    def _background_loop(self):
        dev = self._state.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            while not self._shutdown.is_set():
                # Multi-process mode rounds every cycle (peers wait on this
                # rank's frame); alone, the thread sleeps until a submit.
                self._wake.wait(timeout=self.cycle_time_s
                                if self.controller is not None else None)
                self._wake.clear()
                try:
                    self.run_loop_once()
                except Exception:       # pragma: no cover - engine bug surface
                    log.exception("coordinator cycle failed")

    def kick(self):
        """Hint that a caller is about to block on a just-enqueued handle.

        Without a controller: run the cycle INLINE on the calling thread —
        the submit→wake→cycle-thread→done→waiter round trip costs two thread
        handoffs; executing the drain/fuse/dispatch pipeline here removes
        both while preserving fusion (a concurrent burst drains into the
        same cycle).  Multi-process mode: negotiation must stay on the
        lock-step cycle thread; just wake it.

        ``HOROVOD_INLINE_KICK=0`` disables the inline path (falling back to
        waking the cycle thread)."""
        if (self.controller is None and self.inline_kick
                and self._cycle_owner != threading.get_ident()):
            self.run_loop_once()
        else:
            self._wake.set()

    def run_loop_once(self):
        """One coordinator cycle (reference: RunLoopOnce, SURVEY.md §3.2).

        Serialized by ``_cycle_lock`` — the background thread and blocking
        submitters (``kick``) may race to run a cycle.

        Any failure during planning (negotiation error, stall-shutdown
        abort) must fail the drained entries — never drop them — or waiters
        in ``synchronize()`` would hang forever.
        """
        with self._cycle_lock, torch.no_grad():
            self._cycle_owner = threading.get_ident()
            try:
                self._run_cycle_locked()
            finally:
                self._cycle_owner = None

    def _run_cycle_locked(self):
        t_cycle0 = time.perf_counter()
        self._cycle_index += 1
        tl = self._timeline
        if tl is not None:
            tl.mark_cycle(self._cycle_index)
        if self._unread:
            self._read_timings()
        if self._autotune is not None:
            self._build_autotuner()
        self._drain_ckpt_staging()
        entries = self.queue.drain()
        if not entries and self.controller is None and not self._backlog:
            # (The backlog check keeps the checkpoint lane draining on
            # otherwise idle cycles at size 1.)
            return
        tr = self.tracer
        t_trace0 = t_drain = 0.0
        if tr is not None:
            t_drain = time.monotonic()
            t_trace0 = t_drain - (time.perf_counter() - t_cycle0)
            for e in entries:
                if e.span is None:
                    # The queue phase closes at this first drain; requeued
                    # entries keep their span (still in negotiation).  A
                    # dropped claim latches the sentinel: claim at most
                    # once per entry.
                    e.span = tr.begin(e.name, e.enqueue_time, t_drain) \
                        or _SPAN_DROPPED
        # Multi-process mode: every rank must complete a (possibly empty)
        # lock-step negotiation round each cycle, or peers with pending
        # tensors would block on this rank's missing frame.
        try:
            responses, not_ready = self._compute_response_list(entries)
        except BaseException as exc:  # noqa: BLE001 - propagate to waiters
            if isinstance(exc, ControlPlaneError):
                ctl = self.controller
                if ctl is not None and getattr(ctl, "interrupted", False):
                    # Expected teardown: basics.shutdown() severed the
                    # lock-step socket to unblock this thread, which makes
                    # the in-flight round fail exactly like a peer death.
                    # Not a fault — settle and exit quietly.
                    pass
                else:
                    # A dead peer / missed round deadline: the control
                    # plane cannot recover in place — shut the engine down
                    # cleanly, settling EVERY outstanding waiter with the
                    # error.  MUST run before this cycle's waiters are
                    # released below: a waiter that wakes first reads
                    # engine.fault in basics.shutdown() to pick the abrupt
                    # teardown.
                    self._abort_engine(exc, busy=bool(entries))
            for e in entries:
                e.error = exc
                sp = _live_span(e) if tr is not None else None
                if sp is not None:
                    sp.error = True
                    tr.commit(sp)
                self.queue.mark_done(e)
                e.done.set()
            return
        if not_ready:
            self.queue.requeue(not_ready)
        t_ready = 0.0
        if tr is not None and responses:
            # Globally-ready verdict: the negotiation phase closes.  The
            # cycle id is the cross-rank correlation key — the controller's
            # lock-step round counter, the same on every rank for the same
            # round; alone, the local cycle index.
            t_ready = time.monotonic()
            ctl = self.controller
            cyc_id = ctl.rounds if ctl is not None else self._cycle_index
            for batch in responses:
                for e in batch:
                    sp = _live_span(e)
                    if sp is None:
                        # ONLY synthesized join entries claim here (they
                        # never drained, so ready-time is their drain).  An
                        # ordinary entry whose drain-time claim was dropped
                        # stays untraced.
                        if e.span is not None or \
                                not getattr(e, "trace_synthesized", False):
                            continue
                        sp = tr.begin(e.name, e.enqueue_time, t_ready)
                        e.span = sp or _SPAN_DROPPED
                    if sp is not None:
                        sp.t_ready = t_ready
                        sp.cycle = cyc_id
                        if ctl is not None and sp.slot < 0:
                            sp.slot = ctl.slot_of(e)
        cycle_chunks = 0
        ring = self._inflight_ring()
        if ring is None:
            # Batches a window left in the backlog (the autotuner may close
            # it) go first, in the backlog's order, as on every rank.
            for batch in pop_gradient_batches(self._backlog,
                                              len(self._backlog)):
                cycle_chunks += self._perform_operation(batch)
            for batch in responses:
                cycle_chunks += self._perform_operation(batch)
        else:
            # Dispatch backlog: ready batches queue by (priority, arrival)
            # and each cycle dispatches up to `max_inflight` of them —
            # leftovers wait HERE, where a later cycle's higher-priority
            # batch overtakes them.  The budget is a pure function of knob
            # + heap state (never of local ring occupancy): every rank
            # pushes identical batches with identical keys, so every rank
            # pops — and therefore LAUNCHES — in the identical order, which
            # cross-process collectives require.  FSDP's parameter gathers
            # take the prefetch lane: before the fused lane and outside its
            # budget, so they launch ahead of the gradient stream without
            # reordering it.  Fast-lane batches lead every cycle, also
            # outside the budget.  Checkpoint-lane items sort after every
            # gradient lane and never touch the budget.
            for batch in responses:
                if batch[0].fast_lane:
                    lane = FAST_LANE
                elif batch[0].prefetch:
                    lane = PREFETCH_LANE
                    self.prefetch_dispatches += 1
                    for e in batch:
                        sp = _live_span(e)
                        if sp is not None:
                            sp.prefetch = True
                else:
                    lane = FUSED_LANE
                prio = max(e.priority for e in batch)
                heapq.heappush(self._backlog,
                               (lane, -prio, next(self._backlog_seq), batch))
            for batch in pop_gradient_batches(
                    self._backlog, max(1, int(self.max_inflight))):
                cycle_chunks += self._perform_operation(batch)
        # Checkpoint-lane tail (both dispatch modes): once no gradient
        # batch remains poppable this cycle, a bounded number of writes
        # ride the cycle's tail.
        for item in pop_checkpoint_items(self._backlog,
                                         self.ckpt_lane_budget):
            self._run_ckpt_item(item)
        if self._backlog:
            # Leftovers must not wait out a long cycle timer: run the next
            # cycle (and its negotiation round) immediately.
            self._wake.set()
        if responses:
            self.last_cycle_chunks = cycle_chunks
            if tl is not None and tl.enabled:
                tl.counter("pipeline", {
                    "chunks": cycle_chunks,
                    "inflight": len(self._inflight)
                    if self._inflight is not None else 0})
        if tr is not None and responses:
            ctl = self.controller
            tr.cycle(ctl.rounds if ctl is not None else self._cycle_index,
                     t_trace0, t_drain, t_ready, time.monotonic(),
                     sum(len(b) for b in responses),
                     self.last_negotiation_us if ctl is not None else 0.0)
        if self.autotuner is not None and self.autotuner.tuning:
            nbytes = sum(e.tensor.numel() * e.tensor.element_size()
                         for b in responses for e in b
                         if e.tensor is not None)
            self.autotuner.on_cycle(nbytes)
        dt_us = (time.perf_counter() - t_cycle0) * 1e6
        self.cycle_us_total += dt_us
        self.cycle_count += 1
        self.last_cycle_ts = time.time()
        if self.monitor is not None:
            self.monitor.on_cycle(dt_us)

    def _build_autotuner(self) -> None:
        """The parameter manager (``ops/autotune.py``), once: at the first
        cycle, so that a multi-process engine's controller has attached
        and the search takes its coordinates (cache capacity, chunk,
        in-flight depth, fast lane, round pipeline, speculation)."""
        from .autotune import ParameterManager
        cfg, self._autotune = self._autotune, None
        self.autotuner = ParameterManager(
            self, warmup_samples=cfg.autotune_warmup_samples,
            steps_per_sample=cfg.autotune_steps_per_sample,
            log_path=cfg.autotune_log, max_evals=cfg.autotune_max_evals)

    # --------------------------------------------------------- negotiation
    def _global_nbytes(self, e: TensorTableEntry) -> int:
        """The entry's bytes as the JAX engine counts them: the stacked
        ``[world, *S]`` array of its process set."""
        if e.tensor is None:
            return 0
        world = self._state.process_set_table.get(e.process_set_id).size()
        return e.tensor.numel() * e.tensor.element_size() * world

    def _compute_response_list(self, entries) -> List[List[TensorTableEntry]]:
        """Group ready entries into fused batches (reference: N2
        ``ComputeResponseList``).

        Local mode: all entries are ready.  Grouped entries (group_id >= 0)
        must land in one batch (reference: group_table N13).  Batches are
        split at the fusion threshold, never across fusion keys.

        Returns ``(batches, not_ready)``; not-ready entries (multi-process
        negotiation) are re-queued by the caller for the next cycle.
        """
        not_ready: List[TensorTableEntry] = []
        if self.controller is not None:
            # While this rank is joined, the controller builds its part of
            # every collective a peer submits through this hook.
            self.controller.synthesizer = self._synthesize_join_entry
            self.controller.slot_drop_hook = self._on_slot_drop
            # Zero-RTT dispatch-safety gate (protocol v7): a speculative
            # verdict is dispatched before peers have its real verdict,
            # so this thread must stay free to keep serving them rounds —
            # only the async in-flight window qualifies.  A blocking CPU
            # collective (gloo) would starve the peer of the very frame it
            # needs, deadlocking the fleet.
            self.controller.spec_dispatch_ok = (
                not self._serialize_launches and self.max_inflight > 1)
            t0 = time.perf_counter()
            ready, errored = self.controller.negotiate(entries)
            dt_us = (time.perf_counter() - t0) * 1e6
            self.negotiation_us_total += dt_us
            self.negotiation_cycles += 1
            self.last_negotiation_us = dt_us
            tl0 = self._timeline
            if tl0 is not None and tl0.enabled:
                st = self.controller.cache_stats
                ctl0 = self.controller
                tl0.counter("negotiation", {
                    "us": round(dt_us, 1), "cache_hits": st.hits,
                    "cache_misses": st.misses,
                    "cache_invalidations": st.invalidations,
                    "spec_hits": getattr(ctl0, "spec_hits", 0),
                    "spec_mispredicts": getattr(ctl0, "spec_mispredicts",
                                                0),
                    "inflight_rounds": getattr(ctl0, "inflight_rounds",
                                               0)})
            # Per-tensor negotiation failures (shape/dtype divergence across
            # ranks): fail ONLY those waiters; the runtime stays up
            # (reference: per-tensor error Responses, SURVEY.md N2).
            from ..common.controller import NegotiationError
            # Grouped ops are atomic (reference N13): one member failing
            # negotiation fails every local member of its group.
            bad_groups = {e.group_id for e, _ in errored if e.group_id >= 0}
            if bad_groups:
                by_handle = {e.handle for e, _ in errored}
                for e in entries:
                    if e.group_id in bad_groups and e.handle not in by_handle:
                        errored.append((e, f"grouped collective aborted: a "
                                        f"member of group {e.group_id} failed "
                                        f"negotiation"))
                        # The member may still be mid-negotiation: clear the
                        # controller's announce bookkeeping so a retried op
                        # reusing the name renegotiates from scratch.
                        self.controller.forget(e)
            tl = self._timeline
            tr0 = self.tracer
            for e, msg in errored:
                e.error = NegotiationError(msg)
                if tl is not None:
                    tl.end_activity(e.name, "QUEUE")
                sp = _live_span(e) if tr0 is not None else None
                if sp is not None:
                    sp.error = True
                    tr0.commit(sp)
                self.queue.mark_done(e)
                # A failed entry is finished: clear the stall inspector's
                # live-stall state (and warn latch) like any completion.
                self.stall.progressed(e.name)
                e.done.set()
            errored_handles = {e.handle for e, _ in errored}
            done_handles = {e.handle for e in ready} | errored_handles
            not_ready = [e for e in entries if e.handle not in done_handles]
            entries = [e for e in ready if e.handle not in errored_handles]
            left = getattr(self.controller, "left_ranks", None)
            if left:
                # Clean world shrink (protocol v6 leave notice): world-level
                # verdicts were computed over the SHRUNK control-plane
                # world, but the data-plane world is still the old fixed
                # size — executing them would wedge the transport.  Fail
                # every default-process-set entry (ready AND still-pending)
                # with PeerLeftInterrupt.
                if self._world_changed is None:
                    from ..common.exceptions import PeerLeftInterrupt
                    self._world_changed = PeerLeftInterrupt(left)
                exc_left = self._world_changed
                keep_r: List[TensorTableEntry] = []
                keep_nr: List[TensorTableEntry] = []
                poisoned: List[TensorTableEntry] = []
                for src, kept in ((entries, keep_r), (not_ready, keep_nr)):
                    for e in src:
                        if getattr(e, "process_set_id", 0) == 0:
                            self.controller.forget(e)
                            poisoned.append(e)
                        else:
                            kept.append(e)
                self._settle_queued(poisoned, exc_left)
                for e in poisoned:
                    self.stall.progressed(e.name)
                entries, not_ready = keep_r, keep_nr
                # Zero-RTT race closure (protocol v7): a SPECULATIVE
                # dispatch may have preceded this notice by one round — a
                # world collective launched from a predicted verdict in
                # the very round the leaver departed was never dispatched
                # by the leaver and can never complete.  With speculation
                # armed, settle the in-flight window with the same
                # re-rendezvous interrupt instead of letting its waiters
                # wedge on a dead collective.
                ctl = self.controller
                if (self._inflight is not None and len(self._inflight)
                        and getattr(ctl, "spec_ready_after", 0) > 0
                        and getattr(ctl, "spec_dispatch_ok", False)):
                    self._inflight.abort(exc_left)
        tl = self._timeline
        if tl is not None:
            for e in entries:
                tl.end_activity(e.name, "QUEUE")
                tl.start_activity(e.name, f"NEGOTIATE_{e.ctype.name}")
        self.stall.check(entries + not_ready)

        # Batching must be a pure function of the NEGOTIATED entry order —
        # never of local handle/group counters, which differ across ranks
        # (every rank must build identical batches).  Grouped members are
        # pulled together at the first member's position.
        #
        # Latency fast lane: sub-threshold ungrouped allreduces skip the
        # fusion batching — each becomes its own single-tensor batch,
        # dispatched FIRST (the threshold is the same on every rank and
        # the bytes derive from the negotiated shape and dtype, so the
        # fork is the same fleet-wide).  Parts likewise stay single-entry
        # batches: the part, not a re-fused whole, is the preemption unit.
        fast: List[TensorTableEntry] = []
        thr = self.fast_lane_threshold
        if thr > 0:
            rest: List[TensorTableEntry] = []
            for e in entries:
                if (e.group_id < 0 and e.partition is None
                        and e.ctype == CollectiveType.ALLREDUCE
                        and e.tensor is not None
                        and self._global_nbytes(e) < thr):
                    e.fast_lane = True
                    fast.append(e)
                else:
                    rest.append(e)
            entries = rest
        batches: List[List[TensorTableEntry]] = [[e] for e in fast]
        clusters: List[List[TensorTableEntry]] = []
        seen_groups: set = set()
        for e in entries:
            if e.group_id >= 0:
                if e.group_id in seen_groups:
                    continue
                seen_groups.add(e.group_id)
                clusters.append([m for m in entries
                                 if m.group_id == e.group_id])
            else:
                clusters.append([e])

        by_key: Dict[Tuple, List[List[TensorTableEntry]]] = {}
        for members in clusters:
            if members[0].partition is not None:
                batches.append(members)       # one batch per part, never
                continue                      # re-fused past the split
            by_key.setdefault(_fusion_key(members[0]), []).append(members)
        for key, key_clusters in by_key.items():
            cur: List[TensorTableEntry] = []
            cur_bytes = 0
            for members in key_clusters:
                mbytes = sum(self._global_nbytes(m) for m in members)
                if cur and cur_bytes + mbytes > self.fusion_threshold:
                    batches.append(cur)
                    cur, cur_bytes = [], 0
                cur.extend(members)
                cur_bytes += mbytes
            if cur:
                batches.append(cur)
        return batches, not_ready

    # ----------------------------------------------------------- execution
    def _perform_operation(self, batch: List[TensorTableEntry]) -> int:
        """Dispatch one fused batch; returns its chunk count.

        With the in-flight window active (multi-process, MAX_INFLIGHT > 1)
        the entries are NOT settled here: the batch enters the bounded
        ring and the completion watcher settles ``e.done`` off this thread
        once the batch's done event has fired, so the cycle thread proceeds
        straight to negotiating the next round while the device executes
        this one.  An autotuner agreement settles here, once its done
        event has fired: every rank then applies the move at the end of
        this same cycle."""
        tl = self._timeline
        if tl is not None:
            for e in batch:
                tl.end_activity(e.name, f"NEGOTIATE_{e.ctype.name}")
                tl.start_activity(e.name, collective_lane(e.ctype))
        pp = self._pingpong
        if pp is not None and not batch[0].fast_lane:
            # Double-buffered fusion staging: claim one of the two slots
            # of each dtype group before launching, released at settle
            # (after the done event) — cycle N+1's pack may overlap cycle
            # N's reduce, N+2's may not.  Fast-lane batches stage into
            # their pins instead.
            keys = sorted({str(e.tensor.dtype) for e in batch
                           if e.tensor is not None})
            if keys:
                self._staging_tokens[id(batch)] = {k: pp.acquire(k)
                                                   for k in keys}
        try:
            results = self._execute_batch(batch)
        except BaseException as exc:  # noqa: BLE001 - propagate to waiters
            self._settle_batch(batch, None, exc)
            return 0
        timing, chunks = results[2], results[3]
        if timing is not None:
            # copy_in closes: on the card once the batch's work has been
            # handed to its stream, reduce running from there for the
            # card's time; on the CPU, where the work ran in the call,
            # at its first pack.  A fast-lane entry served by its pin was
            # stamped before the work: never restamp.
            timing.t_launch = (timing.marks[0] if timing.host
                               else time.monotonic())
            tr = self.tracer
            if tr is not None:
                for e in batch:
                    sp = _live_span(e)
                    if sp is not None and not sp.t_launch:
                        sp.t_launch = timing.t_launch
        self.pipeline_chunks_total += chunks
        self.pipeline_dispatches += 1
        if batch[0].fast_lane:
            self.fast_lane_dispatches += 1
        agreement = bool(self._agreements) and any(
            e.handle in self._agreements for e in batch)
        ring = self._inflight_ring()
        if agreement:
            self._agreements.difference_update(e.handle for e in batch)
            self._wait_done(results)
            self._settle_batch(batch, results)
        elif ring is None:
            self._settle_batch(batch, results)
        else:
            if tl is not None:
                for e in batch:
                    tl.start_activity(e.name, "INFLIGHT")
            ring.submit(batch, results)
        return chunks

    def _settle_batch(self, batch: List[TensorTableEntry], results,
                      error: Optional[BaseException] = None,
                      inflight: bool = False):
        """Completion epilogue (cycle thread inline, or the in-flight
        watcher): assign results/error, close timeline lanes, stamp the
        spans, release waiters.  Must never raise — a lost settle hangs
        synchronize().

        The spans' reduce phase: the host's on the CPU (the work is done
        when the dispatch returns), the card's CUDA-event time on the
        card, read here when the batch has completed (the watcher's
        settle); an inline settle on the card releases the waiters before
        the card is done, so its spans wait in ``_unread`` for a later
        cycle."""
        tokens = self._staging_tokens.pop(id(batch), None)
        if tokens is not None and self._pingpong is not None:
            # Hand the staging slots back FIRST: the cycle thread may be
            # blocked in acquire() waiting on exactly this settle.
            # Idempotent per token — an abort that already released them
            # makes this a no-op.
            for tok in tokens.values():
                self._pingpong.release(tok)
        tl = self._timeline
        tr = self.tracer
        t_seen = time.monotonic() if tr is not None else 0.0
        timing = results[2] if results is not None else None
        if error is None:
            outs, done_event = results[0], results[1]
            for e, r in zip(batch, outs):
                e.result = r
                e.done_event = done_event
        else:
            for e in batch:
                e.error = error
        ok = timing is not None and error is None
        card = ok and not timing.host
        complete = card and inflight and results[1].query()
        if ok and (timing.host or complete):
            self._add_parts(timing)
            # The reduce phase's end: the host's at the last unpack; the
            # card's time from the launch, but never past this settle.
            t_result = (timing.marks[-1] if timing.host else
                        min(timing.t_launch + timing.reduce_s(), t_seen))
        else:
            t_result = t_seen
        for e in batch:
            try:
                if tl is not None:
                    if inflight:
                        tl.end_activity(e.name, "INFLIGHT")
                    tl.end_activity(e.name, collective_lane(e.ctype))
                sp = _live_span(e) if tr is not None else None
                if sp is not None:
                    sp.error = error is not None
                    if card and not complete:
                        timing.pending.append(sp)
                        timing.recorder = tr
                    else:
                        sp.t_result = t_result
                        sp.t_done = time.monotonic()
                        tr.commit(sp)
                self.queue.mark_done(e)
                self.stall.progressed(e.name)
            except Exception:  # noqa: BLE001 - keep settling the rest
                log.exception("settle bookkeeping failed for %r", e.name)
            finally:
                e.done.set()
        if card and not complete:
            timing.t_settle = time.monotonic()
            self._unread.append(timing)

    def _add_parts(self, timing: _Timing) -> None:
        """Sum a completed batch's pack, collective and unpack times into
        the engine's counters and the timeline's ``reduce`` track."""
        pack, coll, unpack = timing.parts_us()
        self.reduce_pack_us_total += pack
        self.reduce_collective_us_total += coll
        self.reduce_unpack_us_total += unpack
        self.reduce_overlap_us_total += max(
            0.0, pack + coll + unpack - timing.reduce_s() * 1e6)
        self.timed_batches += 1
        tl = self._timeline
        if tl is not None and tl.enabled:
            tl.counter("reduce", {"pack_us": round(pack, 1),
                                  "collective_us": round(coll, 1),
                                  "unpack_us": round(unpack, 1)})

    def _read_timings(self, wait: bool = False) -> None:
        """Read the inline-settled batches whose card work has completed
        (all of them with ``wait``, at ``stop``) and commit their spans:
        reduce is the card's time from the launch, and the span ends when
        the waiters were released or, if later, when the card was done.
        In submission order: a batch still running stops the read."""
        while self._unread:
            timing = self._unread[0]
            last = timing.marks[-1]
            if wait:
                last.synchronize()
            elif not last.query():
                return
            self._unread.pop(0)
            self._add_parts(timing)
            red = timing.reduce_s()
            for sp in timing.pending:
                sp.t_result = timing.t_launch + red
                sp.t_done = max(timing.t_settle, sp.t_result)
                timing.recorder.commit(sp)

    @staticmethod
    def _wait_done(results):
        """The in-flight window's waiter: the batch's done event on the
        card; a CPU batch completed on the cycle thread."""
        done_event = results[1]
        if done_event is not None:
            done_event.synchronize()

    @staticmethod
    def _batch_done(results) -> bool:
        """The in-flight window's probe: whether the batch completed,
        without waiting.  An abort settles such a batch with its results."""
        done_event = results[1]
        return done_event is None or done_event.query()

    def _inflight_ring(self) -> Optional[InflightRing]:
        """The bounded dispatch window, or None for inline settling.

        Only the multi-process engine pipelines: single-process cycles
        have no negotiation to overlap, and the inline-kick latency path
        relies on same-thread settling.  (The controller attaches after
        construction, hence the lazy build.)"""
        if self.max_inflight <= 1 or self.controller is None:
            return None
        if self._inflight is None:
            self._inflight = InflightRing(
                self._wait_done,
                lambda b, r, err: self._settle_batch(b, r, err,
                                                     inflight=True),
                depth=self.max_inflight, probe=self._batch_done)
            # Double-buffered fusion staging rides the same lifecycle: the
            # ring's watcher is what hands the ping-pong slots back.
            self._pingpong = PingPongBuffers(slots=2)
        else:
            self._inflight.depth = max(1, int(self.max_inflight))
        return self._inflight

    def _synthesize_join_entry(self, name: str, digest: str,
                               group_id: int = -1) -> TensorTableEntry:
        """This rank's part, while it is joined, of a collective a peer
        submitted: the digest (``TCPController._digest``: collective,
        dtype, per-rank shape, op, root, factors, wire compression, and
        the sharded token where there is one) gives the same entry the
        peers batch, holding the identity of the reduction
        (``_join_fill_value``), and the echoed group id keeps grouped
        batching.  The prefetch flag is not in the digest: a joined
        rank's gather stays on the fused lane."""
        handle = next(self._handle_counter)
        now = time.monotonic()   # a fresh age: must not trip the stall check
        if digest == "barrier":
            e = TensorTableEntry(handle=handle, name=name,
                                 ctype=CollectiveType.BARRIER, tensor=None,
                                 enqueue_time=now)
            # Tracer marker: synthesized entries never drain, so their
            # span is claimed at the ready verdict instead.
            e.trace_synthesized = True
            if self.sanitizer is not None:
                # The peer advanced its per-set seq by submitting; advance
                # ours too or every post-join collective mismatches on seq.
                self.sanitizer.observe_synthesized(e)
            return e
        parts = digest.split("|")
        ctype = CollectiveType(parts[0])
        dtype = getattr(torch, parts[1])
        shape = tuple(ast.literal_eval(parts[2]))
        op = C.ReduceOp[parts[3]]
        pre = None if parts[5] == "None" else float(parts[5])
        post = None if parts[6] == "None" else float(parts[6])
        comp = parts[7] if len(parts) > 7 and parts[7] in WIRE_DTYPES \
            else None
        # The ZeRO token, appended only to sharded digests: without it the
        # entry's fusion key would differ from its peers' sharded entries.
        sharded: Any = False
        if len(parts) > 8:
            if parts[8] == "sharded":
                sharded = True
            elif parts[8] == "sharded-full":
                sharded = "full"
        dev = self._state.device
        fill = torch.full(shape, _join_fill_value(ctype, op, dtype),
                          dtype=dtype, device=dev)
        e = TensorTableEntry(
            handle=handle, name=name, ctype=ctype, tensor=fill,
            reduce_op=op, root_rank=int(parts[4]), prescale_factor=pre,
            postscale_factor=post, group_id=group_id, compression=comp,
            sharded=sharded, enqueue_time=now)
        e.output = self._make_output(e)
        e.trace_synthesized = True
        if dev.type == "cuda":
            e.ready = torch.cuda.Event()
            e.ready.record(torch.cuda.current_stream(dev))
        if self.sanitizer is not None:
            self.sanitizer.observe_synthesized(e)
        return e

    # --------------------------------------------------- two-level data plane
    def _slice_topology(self, ps_id: int):
        """The slice-level structure of this process set's world
        (``parallel/topology.py``), derived once and cached, or None.

        Precedence: ``HOROVOD_SLICE_MAP`` → ``HOROVOD_HIERARCHICAL_
        LOCAL_SIZE`` → the launcher's ranks per host, when uniform (GPU
        ranks carry no slice index).  Only the global process set is
        eligible: subgroup process sets keep the flat path, as in the JAX
        engine.  A malformed slice map logs once and falls back flat."""
        if ps_id != 0:
            return None
        if ps_id in self._slice_topos:
            return self._slice_topos[ps_id]
        from ..parallel import topology as slice_topo
        topo = getattr(self._state, "topology", None)
        world = self._state.process_set_table.get(ps_id).size()
        try:
            st = slice_topo.slice_topology(
                None, world=world, slice_map=self.slice_map,
                local_size=self._hier_local_size,
                local_counts=(topo.local_counts
                              if topo is not None else None))
        except ValueError as exc:
            self.slice_map_fallbacks += 1
            log.warning(
                "HOROVOD_SLICE_MAP rejected for process set %d (%s); "
                "hierarchical allreduce/allgather/broadcast stay FLAT on "
                "this fleet — fix the slice map to uniform sizes to "
                "re-enable two-level collectives", ps_id, exc)
            st = None
        self._slice_topos[ps_id] = st
        return st

    def _make_hier_groups(self) -> None:
        """Make the two-level data plane's groups, where the global set
        has a slice topology: one local group per slice, then one cross
        group per local index, on every rank (``dist.new_group`` is a
        collective: every rank makes every group, those it is not in
        included).  ``init()`` calls this on its own thread before the
        cycle thread starts, after the process sets given to ``init()``
        and before any later ``add_process_set``, so every rank makes its
        groups in the same order; made then, a per-call
        ``hierarchical=True`` finds them too.  Slices are contiguous,
        equal blocks of ranks (host-major)."""
        st = self._slice_topology(0)
        if st is None or self._state.size == 1:
            return
        from ..common.basics import _new_generation_group
        L, C = st.local_size, st.num_slices
        local = [tuple(range(s * L, (s + 1) * L)) for s in range(C)]
        cross = [tuple(c * L + i for c in range(C)) for i in range(L)]
        local_groups = [_new_generation_group(r) for r in local]
        cross_groups = [_new_generation_group(r) for r in cross]
        s, i = divmod(self._state.rank, L)
        self._hier = _HierGroups(st, local_groups[s], local[s],
                                 cross_groups[i], cross[i])

    def _groups(self) -> _HierGroups:
        if self._hier is None:
            raise RuntimeError("the two-level groups were not made: the "
                               "global set had no slice topology at init()")
        return self._hier

    def _legs(self):
        """``parallel.hierarchical.Legs`` bound to this rank's groups."""
        import torch.distributed as dist
        from ..parallel.hierarchical import Legs
        h = self._groups()
        ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}
        lg, cg = h.local, h.cross

        def reduce_scatter(out, inp, op):
            dist.reduce_scatter_tensor(_wire_view(out), _wire_view(inp),
                                       op=ops[op], group=lg)

        def all_reduce(t, op):
            dist.all_reduce(_wire_view(t), op=ops[op], group=cg)

        def gather(group):
            def run(out, inp):
                dist.all_gather_into_tensor(out.view(torch.uint8),
                                            inp.view(torch.uint8),
                                            group=group)
            return run

        def broadcast(group, ranks):
            def run(t, src):
                dist.broadcast(t.view(torch.uint8), src=ranks[src],
                               group=group)
            return run

        st = h.topo
        cross_index, local_index = divmod(self._state.rank, st.local_size)
        return Legs(st.local_size, st.num_slices, local_index, cross_index,
                    reduce_scatter, all_reduce, gather(lg), gather(cg),
                    broadcast(lg, h.local_ranks),
                    broadcast(cg, h.cross_ranks))

    def _hier_decision(self, e0: TensorTableEntry, nbytes: int) -> bool:
        """Per-batch flat-vs-two-level verdict for allreduce — a pure
        function of the negotiated batch (op, bytes), the knobs and the
        static slice topology, so every rank decides alike with no
        control-plane traffic.  ``nbytes`` counts per-rank payload bytes.
        Adasum needs power-of-two extents at both levels."""
        if e0.hierarchical is False:
            return False
        if e0.hierarchical is None and not self.hierarchical_allreduce:
            return False
        if e0.ctype != CollectiveType.ALLREDUCE:
            return False
        if e0.reduce_op not in (C.ReduceOp.SUM, C.ReduceOp.AVERAGE,
                                C.ReduceOp.MIN, C.ReduceOp.MAX,
                                C.ReduceOp.ADASUM):
            return False
        if e0.hierarchical is None and nbytes < self.hier_threshold_bytes:
            return False
        st = self._slice_topology(e0.process_set_id)
        if st is None:
            return False
        if e0.reduce_op == C.ReduceOp.ADASUM:
            from ..parallel.topology import hier_bit_orders
            if hier_bit_orders(st.local_size, st.num_slices) is None:
                return False
        return True

    def _hier_ag_decision(self, e0: TensorTableEntry) -> bool:
        """Allgather's verdict: the override, the knob and the topology; no
        payload crossover (a two-level gather moves the flat gather's
        bytes, only fewer of them over the cross links)."""
        if e0.ctype != CollectiveType.ALLGATHER:
            return False
        if e0.hierarchical is False:
            return False
        if e0.hierarchical is None and not self.hierarchical_allgather:
            return False
        return self._slice_topology(e0.process_set_id) is not None

    def _hier_bcast_decision(self, e0: TensorTableEntry) -> bool:
        """Broadcast's verdict, purely topological like allgather's."""
        if e0.ctype != CollectiveType.BROADCAST:
            return False
        if e0.hierarchical is False:
            return False
        if e0.hierarchical is None and not self.hierarchical_broadcast:
            return False
        return self._slice_topology(e0.process_set_id) is not None

    @staticmethod
    def _batch_payload_bytes(batch) -> int:
        """Per-rank payload bytes of a fused batch."""
        return sum(e.tensor.numel() * e.tensor.element_size()
                   for e in batch if e.tensor is not None)

    def _hier_verdict(self, batch: List[TensorTableEntry]) -> bool:
        """The batch's two-level verdict, counting its legs when it is
        taken."""
        e0 = batch[0]
        if e0.ctype == CollectiveType.ALLGATHER:
            hier = self._hier_ag_decision(e0)
            if hier:
                self.hier_ag_dispatches += 1
                self.hier_ag_intra_legs += 1
                self.hier_ag_cross_legs += 1
        elif e0.ctype == CollectiveType.BROADCAST:
            hier = self._hier_bcast_decision(e0)
            if hier:
                self.hier_bcast_dispatches += 1
                self.hier_bcast_cross_legs += 1
                self.hier_bcast_intra_legs += 1
        else:
            hier = self._hier_decision(e0, self._batch_payload_bytes(batch))
            if hier:
                self.hier_dispatches += 1
                self.hier_intra_legs += 2
                self.hier_cross_legs += 1
                if self.tracer is not None:
                    # The reduce phase's modelled cross-link share, which
                    # the recorder splits the measured reduce by (one
                    # launch sequence on the stream; the legs are not
                    # timed apart).
                    st = self._slice_topology(e0.process_set_id)
                    from ..parallel.topology import cross_fraction
                    frac = cross_fraction(self._batch_payload_bytes(batch),
                                          st.world, st.local_size)
                    for e in batch:
                        sp = _live_span(e)
                        if sp is not None:
                            sp.cross_frac = frac
        return hier

    def _stream(self, dev: torch.device):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(device=dev)
        return s

    def _execute_batch(self, batch: List[TensorTableEntry]):
        """Pack, collective and unpack per dtype group (and chunk) of one
        batch; returns ``(outputs, done_event, timing, chunks)`` — the done
        event (None on the CPU) fires once every output is written; the
        timing (None disarmed) holds the reduce phase's marks; chunks is
        the batch's chunk plan total (1 unchunked)."""
        e0 = batch[0]
        if e0.ctype == CollectiveType.BARRIER:
            # The negotiated verdict is the barrier: every rank announced.
            return [None for _ in batch], None, None, 0
        ps = self._state.process_set_table.get(e0.process_set_id)
        dev = e0.tensor.device
        timing = _Timing(dev.type != "cuda") if self._armed() else None
        if dev.type != "cuda":
            self._timing = timing
            try:
                self._mark()
                outs = self._run_groups(batch, ps)
                return outs, None, timing, self._batch_chunks
            finally:
                self._timing = None
                self._stage = None
        stream = self._stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            for ready in {id(e.ready): e.ready for e in batch}.values():
                if ready is not None:
                    stream.wait_event(ready)
            # The caching allocator must not hand these tensors' memory to
            # their own streams' later work until this stream is done (a
            # part's or a chunk's view records its whole storage).
            for e in batch:
                e.tensor.record_stream(stream)
                e.output.record_stream(stream)
            self._timing = timing
            try:
                self._mark()
                outs = self._run_groups(batch, ps)
            finally:
                self._timing = None
                self._stage = None
            done = torch.cuda.Event()
            done.record(stream)
        return outs, done, timing, self._batch_chunks

    def _mark(self) -> int:
        """A reduce-phase mark of the executing batch, when armed: a
        timing CUDA event on the current (engine) stream on the card, the
        host clock on the CPU.  Returns its index (-1 disarmed)."""
        t = self._timing
        return t.mark() if t is not None else -1

    def _staged(self, numel: int, dtype: torch.dtype,
                dev: torch.device) -> Optional[torch.Tensor]:
        """The executing group's staging buffer as ``numel`` elements of
        ``dtype`` — a ping-pong slot's or a fast-lane pin's, grown when
        too small — or None (a new buffer per batch) without one."""
        st = self._stage
        if st is None:
            return None
        nbytes = numel * dtype.itemsize
        if st.buf is None or st.buf.numel() < nbytes \
                or st.buf.device != dev:
            st.buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        return st.buf[:nbytes].view(dtype)

    def _pack(self, tensors, dtype, prescale=None,
              out=None) -> torch.Tensor:
        """``fusion.pack`` into ``out`` (the group's staging buffer when
        None), then the pack's end mark."""
        t = self._timing
        start = len(t.marks) - 1 if t is not None else -1
        if out is None:
            out = self._staged(sum(x.numel() for x in tensors), dtype,
                               tensors[0].device)
        buf = fusion.pack(tensors, dtype, prescale, out=out)
        if t is not None:
            t.parts.append((0, (start,), t.mark()))
        return buf

    def _unpack(self, buf, outs, *args, coll_from: Sequence[int] = (),
                **kwargs) -> None:
        """The collective's end mark (its part from the latest of
        ``coll_from``, the previous mark by default), ``fusion.unpack``,
        then the unpack's end mark."""
        t = self._timing
        if t is not None:
            end = t.mark()
            t.parts.append((1, tuple(coll_from) or (end - 1,), end))
        fusion.unpack(buf, outs, *args, **kwargs)
        if t is not None:
            t.parts.append((2, (end,), t.mark()))

    def _chunk_plan(self, ctype: CollectiveType, shapes, dtypes) -> Tuple:
        """Per-dtype-group chunk counts for a fused reduction.

        A pure function of (chunk knob, per-rank shapes, dtypes): every rank
        computes the same plan from the same negotiated batch.  Empty plan
        = chunking off or a non-reduction op (gathers and permutes have no
        cast/reduce/cast stages to overlap).

        Knob 0 is a true OFF, not "fusion-threshold-sized chunks": an
        atomic cluster (one grouped_allreduce of the whole model, or a
        single oversized tensor) is never split by the batch planner, so
        it can exceed the threshold — deriving chunks from it would
        silently chunk default-config workloads."""
        if ctype != CollectiveType.ALLREDUCE or self.pipeline_chunk_bytes <= 0:
            return ()
        chunk = max(1, int(self.pipeline_chunk_bytes))
        groups: Dict[torch.dtype, Tuple[int, int]] = {}  # -> (elems, bytes)
        for s, dt in zip(shapes, dtypes):
            n = math.prod(s)
            b = n * dt.itemsize
            e_, b_ = groups.get(dt, (0, 0))
            groups[dt] = (e_ + n, b_ + b)
        return tuple(min(max(1, -(-b // chunk)), max(1, e))
                     for e, b in groups.values())

    def _on_slot_drop(self, slot: int):
        """Controller invalidation hook: a response-cache slot this client
        dropped (eviction / forget / trim / id reuse) takes its fast-lane
        pin with it."""
        self._fast_pins.pop(slot, None)

    @staticmethod
    def _fast_pin_key(e: TensorTableEntry):
        """Fast-lane pin key: the server-assigned response-cache slot
        (digest-scoped, coordinated invalidation) when known, the tensor
        name in a world of one (no slots exist; the validity compare in
        ``_fast_pin`` keeps name reuse sound)."""
        return e.cache_slot if e.cache_slot >= 0 else e.name

    def _fast_pin(self, e: TensorTableEntry, hier: bool) -> _Pin:
        """The fast-lane entry's pin: its pinned plan when still valid —
        one dict probe and a few scalar compares, no planning — else a new
        plan pinned in its place.  A pin made under the tensor's name
        before its slot was learned moves to the slot (the JAX engine
        drops it and builds anew: here nothing was compiled, and the
        validity compare below still holds it to the same inputs).
        ``hier`` is the batch's two-level verdict: a pin resolved under
        the other verdict is dropped, as is one under another shape,
        dtype, fusion key or chunk knob."""
        key = self._fast_pin_key(e)
        pins = self._fast_pins
        pin = pins.get(key)
        if pin is None and key != e.name:
            # The cold start pinned under the NAME (the slot was still
            # unlearned at that dispatch): the slot now keys it.
            pin = pins.pop(e.name, None)
            if pin is not None:
                pins[key] = pin
        if pin is not None and (
                pin.shape != e.tensor.shape or pin.dtype != e.tensor.dtype
                or pin.chunk_knob != self.pipeline_chunk_bytes
                or pin.hier != hier or pin.fkey != _fusion_key(e)):
            # Stale pin (name reuse under new params, knob retune, ...).
            del pins[key]
            pin = None
        if pin is not None:
            self.fast_lane_hits += 1
            tr = self.tracer
            sp = _live_span(e) if tr is not None else None
            if sp is not None and not sp.t_launch:
                # copy_in closes HERE, before the work: the pin fetches no
                # plan — what follows belongs to the reduce phase.
                sp.t_launch = time.monotonic()
            return pin
        world = self._state.process_set_table.get(e.process_set_id).size()
        pack_dt, divisor = self._allreduce_plan(e, world)
        plan = self._chunk_plan(e.ctype, [e.tensor.shape], [e.tensor.dtype])
        pin = _Pin(_fusion_key(e), e.tensor.shape, e.tensor.dtype,
                   self.pipeline_chunk_bytes, hier, pack_dt, divisor,
                   plan[0] if plan else 1, _Stage())
        pins[key] = pin
        while len(pins) > _PIN_CAPACITY:
            pins.pop(next(iter(pins)))
        return pin

    def _run_groups(self, batch: List[TensorTableEntry], ps):
        """One buffer per dtype (first-occurrence order), each packed, run
        through its collective and unpacked, chunk by chunk under a chunk
        plan — the port of the JAX engine's builders, one dtype group at a
        time.  A fast-lane batch runs its one tensor on its pin.  Returns
        the outputs; the batch's chunk count is left in
        ``_batch_chunks``."""
        e0 = batch[0]
        hier = ps.size() > 1 and self._hier_verdict(batch)
        if e0.fast_lane and len(batch) == 1:
            pin = self._fast_pin(e0, hier)
            self._stage = pin.stage
            self._run_allreduce(batch, ps, hier, pin.chunks, pin)
            self.fused_groups += 1
            self._batch_chunks = pin.chunks
            return [e0.output]
        groups: Dict[torch.dtype, List[TensorTableEntry]] = {}
        for e in batch:
            groups.setdefault(e.tensor.dtype, []).append(e)
        run = {CollectiveType.ALLREDUCE: self._run_allreduce,
               CollectiveType.BROADCAST: self._run_broadcast,
               CollectiveType.ALLGATHER: self._run_allgather,
               CollectiveType.REDUCESCATTER: self._run_reducescatter,
               CollectiveType.ALLTOALL: self._run_alltoall}[e0.ctype]
        plan = self._chunk_plan(e0.ctype, [e.tensor.shape for e in batch],
                                [e.tensor.dtype for e in batch])
        tokens = self._staging_tokens.get(id(batch))
        for (dt, members), nch in zip(groups.items(),
                                      plan or [1] * len(groups)):
            tok = tokens.get(str(dt)) if tokens else None
            self._stage = (None if tok is None or tok._released else
                           self._staging.setdefault((tok.key, tok.slot),
                                                    _Stage()))
            if e0.ctype == CollectiveType.ALLREDUCE:
                run(members, ps, hier, nch)
            else:
                run(members, ps, hier)
            self.fused_groups += 1
        self._batch_chunks = sum(plan) if plan else 1
        return [e.output for e in batch]

    def _allreduce_plan(self, e0: TensorTableEntry,
                        world: int) -> Tuple[torch.dtype, int]:
        """An allreduce group's resolved plan: its buffer's dtype (the wire
        dtype of a compressed float group, ``reduce_dtypes``'s widening;
        float pairs for complex) and the unpack's divisor."""
        dt, op = e0.tensor.dtype, e0.reduce_op
        if op == C.ReduceOp.ADASUM:
            return fusion.buffer_dtype(dt, WIRE_DTYPES.get(e0.compression)), 1
        if dt.is_complex:
            buf_dt = _pairs(torch.empty(1, dtype=dt)).dtype
        else:
            buf_dt = fusion.buffer_dtype(
                reduce_dtypes(CollectiveType.ALLREDUCE, dt, op)[0],
                WIRE_DTYPES.get(e0.compression))
        return buf_dt, (world if op == C.ReduceOp.AVERAGE else 1)

    def _run_allreduce(self, members: List[TensorTableEntry], ps,
                       hier: bool = False, chunks: int = 1,
                       pin: Optional[_Pin] = None) -> None:
        """``_build_fused_reduce``/``_build_allreduce``: prescale in the
        source dtype, then the cast to the buffer's dtype (the wire dtype,
        or ``reduce_dtypes``'s widening); Average divides (floor division
        for integers, after narrowing); the cast back, then the
        postscale.  Two-level (``hier``): the same buffer through
        ``parallel/hierarchical.py``'s legs.  ``chunks`` > 1 pipelines the
        group chunk by chunk (``_run_chunks``); ``pin`` is a fast-lane
        entry's resolved plan."""
        e0, world = members[0], ps.size()
        dt, op = e0.tensor.dtype, e0.reduce_op
        if op == C.ReduceOp.ADASUM:
            return self._run_adasum(members, ps, hier)
        ins = [e.tensor for e in members]
        outs = [e.output for e in members]
        buf_dt, divisor = ((pin.pack_dtype, pin.divisor) if pin is not None
                           else self._allreduce_plan(e0, world))
        if dt.is_complex:
            ins, outs = [_pairs(t) for t in ins], [_pairs(o) for o in outs]
        u32 = outs[0].dtype == torch.uint32      # int32 products, same bits
        gathered = dt.is_complex and op == C.ReduceOp.PRODUCT
        if chunks > 1:
            return self._run_chunks(ins, outs, buf_dt, e0, ps, hier, chunks,
                                    divisor, u32, gathered)
        buf = self._pack(ins, buf_dt, e0.prescale_factor)
        if world > 1:
            buf = self._reduce_flat(buf, e0, ps, hier, gathered)
        if u32:
            buf = buf.view(torch.uint32)
        self._unpack(buf, outs, divisor, e0.postscale_factor)

    def _reduce_flat(self, buf: torch.Tensor, e0: TensorTableEntry, ps,
                     hier: bool, gathered: bool) -> torch.Tensor:
        """One group's (or chunk's) reduction at a set size above 1, in
        place where it can be: the complex Product gathered, the two-level
        legs, or the one allreduce."""
        op = e0.reduce_op
        if gathered:
            return self._complex_gathered(buf, op, ps)
        if hier:
            from ..parallel import hierarchical as H
            legs = self._legs()
            return (H.hierarchical_allreduce_minmax(buf, op.name.lower(), legs)
                    if op in (C.ReduceOp.MIN, C.ReduceOp.MAX)
                    else H.hierarchical_allreduce(buf, legs))
        self._all_reduce(buf, op, ps)
        return buf

    def _run_chunks(self, ins, outs, buf_dt, e0: TensorTableEntry, ps,
                    hier: bool, chunks: int, divisor: int, u32: bool,
                    gathered: bool) -> None:
        """A dtype group in ``chunks`` chunks: chunk i's views of the
        group (``fusion.span``) packed into its slice of the group's
        buffer on the engine stream, then its collective — flat, an
        asynchronous allreduce — and chunk i-1's unpack once its work is
        waited on (the engine stream waits; the host does not), so that
        pack i+1 and unpack i-1 overlap collective i.  Two-level legs and
        the complex Product's gather run a chunk at a time.  The same
        elements reduce alike, so the result is the unchunked one."""
        world = ps.size()
        n = sum(t.numel() for t in ins)
        bounds = _chunk_bounds(n, chunks, (ins[0].dtype.itemsize,
                                           buf_dt.itemsize))
        full = self._staged(n, buf_dt, ins[0].device)
        if full is None:
            full = torch.empty(n, dtype=buf_dt, device=ins[0].device)
        flat = world > 1 and not hier and not gathered
        t = self._timing
        prev_coll: Tuple[int, ...] = ()
        pending = None
        for a, b in zip(bounds, bounds[1:]):
            if a == b:
                continue
            buf = self._pack(fusion.span(ins, a, b), buf_dt,
                             e0.prescale_factor, out=full[a:b])
            packed = len(t.marks) - 1 if t is not None else -1
            work = None
            if flat:
                work = self._all_reduce(buf, e0.reduce_op, ps, async_op=True)
            elif world > 1:
                buf = self._reduce_flat(buf, e0, ps, hier, gathered)
            if pending is not None:
                prev_coll = self._finish_chunk(*pending, prev_coll, outs,
                                               divisor, u32, e0)
            pending = (buf, work, a, b, packed)
        if pending is not None:
            self._finish_chunk(*pending, prev_coll, outs, divisor, u32, e0)

    def _finish_chunk(self, buf, work, a: int, b: int, packed: int,
                      prev_coll: Tuple[int, ...], outs, divisor: int,
                      u32: bool, e0: TensorTableEntry) -> Tuple[int, ...]:
        """Wait on a chunk's collective (the engine stream waits on NCCL's)
        and unpack it into its views of the outputs; returns the mark of
        its collective's end, where the next chunk's collective can start
        at the earliest (NCCL runs them in order)."""
        if work is not None:
            work.wait()
        if u32:
            buf = buf.view(torch.uint32)
        t = self._timing
        coll_from = (packed,) + prev_coll if t is not None else ()
        self._unpack(buf, fusion.span(outs, a, b), divisor,
                     e0.postscale_factor, coll_from=coll_from)
        return (t.parts[-1][1][0],) if t is not None else ()

    def _run_adasum(self, members: List[TensorTableEntry], ps,
                    hier: bool) -> None:
        """``_build_allreduce``'s ``ADASUM`` (JAX :2045-2066) on the packed
        dtype-group buffer: prescale, the wire cast, Adasum in float32
        over the whole buffer and the cast back to the buffer's dtype,
        then the unpack's cast to the source and postscale (no divisor).
        Never chunked: its dot products span the whole buffer."""
        e0, world = members[0], ps.size()
        buf = self._pack([e.tensor for e in members],
                          fusion.buffer_dtype(e0.tensor.dtype,
                                              WIRE_DTYPES.get(e0.compression)),
                          e0.prescale_factor)
        if world > 1 and buf.numel():
            buf.copy_(self._adasum(buf, ps, hier))
        self._unpack(buf, [e.output for e in members], 1,
                      e0.postscale_factor)

    def _adasum(self, buf: torch.Tensor, ps, hier: bool) -> torch.Tensor:
        """The two-level VHD when ``hier``; the VHD over the set's group
        at a power-of-two size; else every rank's buffer gathered and the
        tree."""
        from ..parallel import adasum as A
        world = ps.size()
        if hier:
            h = self._groups()
            L, C = h.topo.local_size, h.topo.num_slices
            s, i = divmod(self._state.rank, L)
            return A.adasum_allreduce_hier(
                buf, (self._swapper(h.local, h.local_ranks), i, L),
                (self._swapper(h.cross, h.cross_ranks), s, C))
        if world & (world - 1) == 0:
            return A.adasum_allreduce_hd(
                buf, self._swapper(ps.group, ps.ranks),
                ps.rank_in_set(self._state.rank), world)
        return A.adasum_allreduce(buf, lambda x: self._gathered(x, ps))

    @staticmethod
    def _swapper(group, ranks: Sequence[int]):
        """``parallel.adasum``'s swap on ``group``: ``send`` to the rank at
        position ``peer`` of ``ranks``, its tensor into ``out``, as one
        ``batch_isend_irecv`` (the send and the receive cannot block each
        other)."""
        import torch.distributed as dist

        def swap(send, out, peer):
            r = ranks[peer]
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, send, r, group=group),
                     dist.P2POp(dist.irecv, out, r, group=group)]):
                req.wait()
        return swap

    @staticmethod
    def _gathered(x: torch.Tensor, ps) -> List[torch.Tensor]:
        """Every rank's ``x`` in rank order, by bytes."""
        import torch.distributed as dist
        g = torch.empty(ps.size() * x.numel(), dtype=x.dtype,
                        device=x.device)
        dist.all_gather_into_tensor(g.view(torch.uint8),
                                    x.view(torch.uint8), group=ps.group)
        return list(g.view(ps.size(), -1).unbind(0))

    def _run_broadcast(self, members: List[TensorTableEntry], ps,
                       hier: bool = False) -> None:
        """By bytes: a byte copy is bitwise root's tensor for every dtype;
        two-level (``hier``) as the root's cross leg, then the local
        fan-out."""
        e0 = members[0]
        buf = self._pack([e.tensor for e in members], e0.tensor.dtype)
        if hier:
            from ..parallel.hierarchical import hierarchical_broadcast
            hierarchical_broadcast(buf, e0.root_rank, self._legs())
        elif ps.size() > 1:
            import torch.distributed as dist
            dist.broadcast(buf.view(torch.uint8), src=ps.ranks[e0.root_rank],
                           group=ps.group)
        self._unpack(buf, [e.output for e in members])

    def _run_allgather(self, members: List[TensorTableEntry], ps,
                       hier: bool = False) -> None:
        """``_build_allgather`` (tiled on dim 0), by bytes: every rank's
        buffer lands rank-major in one gathered buffer, unpacked through
        world × N destination views; two-level (``hier``) as a local then
        a cross gather, which lands the same bytes in the same order."""
        world = ps.size()
        ins = [e.tensor for e in members]
        buf = self._pack(ins, ins[0].dtype)
        out = buf
        if hier:
            from ..parallel.hierarchical import hierarchical_allgather
            out = hierarchical_allgather(buf, self._legs())
        elif world > 1:
            import torch.distributed as dist
            out = torch.empty(world * buf.numel(), dtype=buf.dtype,
                              device=buf.device)
            dist.all_gather_into_tensor(out.view(torch.uint8),
                                        buf.view(torch.uint8),
                                        group=ps.group)
        self._unpack(out, _views([e.output for e in members],
                                  [t.numel() for t in ins], world))

    def _run_reducescatter(self, members: List[TensorTableEntry],
                           ps, hier: bool = False) -> None:
        """``_build_reducescatter``: world × N source views packed
        rank-major, one reduce-scatter (NCCL's own Min/Max/Product where
        the JAX program gathers, reduces and slices), and Average's
        division in the result's dtype (``/``: an integer input comes
        back float32).  The buffer is ``reduce_dtypes``'s: int16 travels
        as int32 and its sum wraps back to int16 in the unpack, before an
        ``Average``'s division; a complex group reduces its float pairs
        (``Sum``, ``Average``) or is gathered and reduced in rank order
        (``Min``/``Max`` lexicographic, ``Product``)."""
        e0, world = members[0], ps.size()
        op, dt = e0.reduce_op, e0.tensor.dtype
        ins = [e.tensor for e in members]
        outs = [e.output for e in members]
        sizes = _rows(ins, world)
        buf_dt, out_dt = reduce_dtypes(CollectiveType.REDUCESCATTER, dt, op)
        srcs = _views(ins, sizes, world)
        if dt.is_complex:
            srcs, outs = [_pairs(v) for v in srcs], [_pairs(o) for o in outs]
            sizes, buf_dt = [2 * n for n in sizes], srcs[0].dtype
        buf = self._pack(srcs, buf_dt)
        red = buf
        if world > 1:
            n = sum(sizes)
            if dt.is_complex and op not in (C.ReduceOp.SUM,
                                            C.ReduceOp.AVERAGE):
                q = ps.rank_in_set(self._state.rank)
                red = self._complex_gathered(buf, op, ps)[q * n:(q + 1) * n]
            else:
                import torch.distributed as dist
                red = torch.empty(n, dtype=buf_dt, device=buf.device)
                wire = torch.uint8 if buf_dt == torch.bool else buf_dt
                dist.reduce_scatter_tensor(red.view(wire), buf.view(wire),
                                           op=_dist_op(op), group=ps.group)
        if out_dt == torch.uint32:
            red = red.view(torch.uint32)
        divisor = world if op == C.ReduceOp.AVERAGE else 1
        narrow = (torch.int16 if dt == torch.int16
                  and out_dt == torch.float32 else None)
        self._unpack(red, outs, divisor, narrow=narrow)

    def _run_alltoall(self, members: List[TensorTableEntry], ps,
                      hier: bool = False) -> None:
        """``_build_alltoall`` (split and concatenated on dim 0), by
        bytes: chunk q of every tensor packed together for rank q, one
        all-to-all, and rank r's chunks unpacked to rows
        ``[r·S0_i/world, (r+1)·S0_i/world)`` of each output."""
        world = ps.size()
        ins = [e.tensor for e in members]
        sizes = _rows(ins, world)
        buf = self._pack(_views(ins, sizes, world), ins[0].dtype)
        out = buf
        if world > 1:
            import torch.distributed as dist
            out = torch.empty_like(buf)
            dist.all_to_all_single(out.view(torch.uint8),
                                   buf.view(torch.uint8), group=ps.group)
        self._unpack(out, _views([e.output for e in members], sizes,
                                  world))

    @staticmethod
    def _all_reduce(buf: torch.Tensor, op: C.ReduceOp, ps,
                    async_op: bool = False):
        """The group's (or chunk's) one allreduce (on the card on NCCL's
        stream, ordered after the pack; before the unpack of this stream,
        or, ``async_op``, once its work is waited on).  A bool buffer
        (``Min``/``Max``) reduces as bytes."""
        import torch.distributed as dist
        if buf.dtype == torch.bool:
            buf = buf.view(torch.uint8)
        if async_op:
            return dist.all_reduce(buf, op=_dist_op(op), group=ps.group,
                                   async_op=True)
        dist.all_reduce(buf, op=_dist_op(op), group=ps.group)
        return None

    @staticmethod
    def _complex_gathered(buf: torch.Tensor, op: C.ReduceOp,
                          ps) -> torch.Tensor:
        """A complex ``Product``, ``Min`` or ``Max`` (float pairs in
        ``buf``): every rank's buffer gathered and reduced in rank order,
        as the JAX program's ``jnp.prod``/``min``/``max`` over the gathered
        axis (``Min``/``Max`` order complex numbers by real part, then
        imaginary part, as XLA does)."""
        import torch.distributed as dist
        world = ps.size()
        g = torch.empty(world * buf.numel(), dtype=buf.dtype,
                        device=buf.device)
        dist.all_gather_into_tensor(g, buf, group=ps.group)
        c = torch.view_as_complex(g.view(world, -1, 2))
        acc = c[0]
        for r in range(1, world):
            if op == C.ReduceOp.PRODUCT:
                acc = acc * c[r]
                continue
            a, b = acc, c[r]
            past = torch.gt if op == C.ReduceOp.MAX else torch.lt
            acc = torch.where(past(b.real, a.real) | (
                (b.real == a.real) & past(b.imag, a.imag)), b, a)
        return _pairs(acc.contiguous())
