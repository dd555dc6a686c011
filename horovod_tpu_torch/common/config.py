# Copied from horovod_tpu/common/config.py:1-53, 109-200, 202-227, 381-404
# and the matching lines of from_env (:410-497): only the fields the engine
# and the controller read; the monitor (:146-154), timeline and trace
# (:184-196) fields, the launcher's cross rank and size (:403-404) and their
# parsing (:420-430, :495-496, :502-508); the sharded optimizer's fields
# (:276-299) with pipeline_chunk_bytes (:128), and their parsing (:416,
# :448-450); the fast lane's and partitioning's thresholds (:132-144), the
# checkpoint lane's chunk and budget (:272-273) and the autotuner's fields
# (:372-376), and their parsing (:418-419, :445-446, :477-481); ckpt_dir and
# elastic (:258-271, 407) and their parsing (:444, 497).
"""Environment-variable configuration surface.

TPU-native equivalent of the reference's env parser
(``horovod/common/utils/env_parser.cc``) and the ``HOROVOD_*`` config surface
described in SURVEY.md §5 ("Config/flag system").  Same two-layer pattern:
env vars are the core config; the launcher forwards CLI/YAML settings to
workers as env vars.

We accept both the reference's ``HOROVOD_*`` names (so existing user scripts /
run-books keep working) and ``HVD_TPU_*`` overrides.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, default: Optional[str] = None) -> Optional[str]:
    """Look up HVD_TPU_<name> then HOROVOD_<name>."""
    for prefix in ("HVD_TPU_", "HOROVOD_"):
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    return default


def _env_int(name: str, default: int) -> int:
    val = _env(name)
    if val is None or val == "":
        return default
    try:
        return int(val)
    except ValueError:
        raise ValueError(f"Invalid integer for HOROVOD_{name}: {val!r}")


def _env_float(name: str, default: float) -> float:
    val = _env(name)
    if val is None or val == "":
        return default
    try:
        return float(val)
    except ValueError:
        raise ValueError(f"Invalid float for HOROVOD_{name}: {val!r}")


def _env_bool(name: str, default: bool) -> bool:
    val = _env(name)
    if val is None or val == "":
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Config:
    """Runtime configuration, parsed once at ``init()``.

    - ``fusion_threshold_bytes``   <- HOROVOD_FUSION_THRESHOLD (default 64 MB)
    - ``cycle_time_ms``            <- HOROVOD_CYCLE_TIME
    - ``response_cache_capacity``  <- HOROVOD_RESPONSE_CACHE_CAPACITY
      (negotiation response cache: the steady-state bitvector fast path)
    - ``max_inflight``             <- HOROVOD_MAX_INFLIGHT (bounded window
      of dispatched-but-unsettled fused batches, multi-process mode)
    - ``stall_check_time_s``       <- HOROVOD_STALL_CHECK_TIME
    - ``stall_shutdown_time_s``    <- HOROVOD_STALL_SHUTDOWN_TIME
    - ``stall_check_disable``      <- HOROVOD_STALL_CHECK_DISABLE
    - ``hierarchical_allreduce``   <- HOROVOD_HIERARCHICAL_ALLREDUCE
    - ``hierarchical_allgather``   <- HOROVOD_HIERARCHICAL_ALLGATHER
    - ``hierarchical_broadcast``   <- HOROVOD_HIERARCHICAL_BROADCAST
    - ``hierarchical_local_size``  <- HOROVOD_HIERARCHICAL_LOCAL_SIZE
    - ``hier_threshold_bytes``     <- HOROVOD_HIER_THRESHOLD (flat-vs-
      two-level payload crossover; 0 = always two-level when armed)
    - ``slice_map``                <- HOROVOD_SLICE_MAP (explicit slice
      membership; see parallel/topology.py)
    - ``monitor``/``monitor_port``/``monitor_interval_s`` <-
      HOROVOD_MONITOR/_MONITOR_PORT/_MONITOR_INTERVAL
    - ``timeline_filename``/``timeline_mark_cycles`` <- HOROVOD_TIMELINE/
      _TIMELINE_MARK_CYCLES
    - ``trace``/``trace_filename`` <- HOROVOD_TRACE (a path or a boolean),
      ``trace_ring`` <- HOROVOD_TRACE_RING
    - ``cross_rank_env``/``cross_size_env`` <- HOROVOD_CROSS_RANK/
      HOROVOD_CROSS_SIZE (the launcher's)
    - ``sharded_optimizer``        <- HOROVOD_SHARDED_OPTIMIZER
    - ``sharded_params``           <- HOROVOD_SHARDED_PARAMS
    - ``prefetch_depth``           <- HOROVOD_PREFETCH_DEPTH
    - ``pipeline_chunk_bytes``     <- HOROVOD_PIPELINE_CHUNK (fused-reduce
      chunk size for pipelined pack/allreduce/unpack, 0 = single chunk;
      also the sharded optimizer's bucket size)
    - ``fast_lane_threshold_bytes``<- HOROVOD_FAST_LANE_THRESHOLD (latency
      fast lane: sub-threshold allreduces skip the fusion buffer; 0 = off)
    - ``partition_threshold_bytes``<- HOROVOD_PARTITION_THRESHOLD
      (ByteScheduler-style split of huge tensors into preemptible
      sub-tensors; 0 = off)
    - ``ckpt_chunk_bytes``/``ckpt_lane_budget`` <- HOROVOD_CKPT_CHUNK/
      HOROVOD_CKPT_LANE_BUDGET (the checkpoint lane)
    - ``autotune``                 <- HOROVOD_AUTOTUNE
    - ``autotune_log``             <- HOROVOD_AUTOTUNE_LOG
    - ``autotune_warmup_samples``  <- HOROVOD_AUTOTUNE_WARMUP_SAMPLES
    - ``autotune_steps_per_sample``<- HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE
    - ``autotune_max_evals``       <- HOROVOD_AUTOTUNE_MAX_EVALS
    - ``elastic``                  <- HOROVOD_ELASTIC (set by the elastic
      driver for its workers)
    - ``ckpt_dir``                 <- HOROVOD_CKPT_DIR (arms the state plane)
    """

    fusion_threshold_bytes: int = 64 * 1024 * 1024
    cycle_time_ms: float = 1.0
    # Negotiation response cache (HOROVOD_RESPONSE_CACHE_CAPACITY, upstream
    # HOROVOD_CACHE_CAPACITY's role): slot-table size for the steady-state
    # bitvector fast path, client-side AND server-side.  0 disables (every
    # cycle does full metadata negotiation).
    response_cache_capacity: int = 2048

    # max_inflight bounds the dispatched-but-unsettled window in
    # multi-process mode: >1 lets the cycle thread negotiate round N+1
    # while the device executes round N.
    max_inflight: int = 2

    # HOROVOD_PIPELINE_CHUNK: the engine splits each dtype group of a fused
    # allreduce into ceil(bytes / chunk) chunks, each packed, reduced and
    # unpacked on its own so that pack i+1 and unpack i-1 overlap the
    # collective of chunk i; 0 (default) = one chunk per fused batch.  The
    # sharded optimizer reads the engine's live value as the byte size of
    # its buckets (greedy, in registration order; 0 = one bucket a param
    # group).  An autotune coordinate when a controller exists.
    pipeline_chunk_bytes: int = 0

    # Small-message latency war (docs/performance.md "Latency fast lane").
    # fast_lane_threshold_bytes: ungrouped allreduces below this many bytes
    # skip the fusion-buffer batching entirely — single-tensor batches
    # dispatched first, each with a pinned plan and staging buffer (still
    # negotiated, still response-cache-slotted, bitwise-identical
    # results); 0 = off.  partition_threshold_bytes: tensors above this
    # many bytes split into priority-inheriting sub-tensors so a small
    # high-priority gradient preempts a huge transfer between parts
    # instead of queueing behind the whole of it (ByteScheduler, Peng et
    # al. SOSP 2019); reassembled transparently at synchronize; 0 = off.
    # Both must be identical on every rank (the launcher forwards them;
    # autotune broadcasts fast-lane moves).
    fast_lane_threshold_bytes: int = 0
    partition_threshold_bytes: int = 0

    # The checkpoint lane: HOROVOD_CKPT_CHUNK bounds one lane item's write
    # (the state plane's unit, which reads it), HOROVOD_CKPT_LANE_BUDGET
    # bounds the items the engine runs at the tail of one cycle.
    ckpt_chunk_bytes: int = 1 << 20
    ckpt_lane_budget: int = 2

    # Resilient state plane (elastic/stateplane.py).  HOROVOD_CKPT_DIR
    # arms overlap-scheduled sharded checkpoints: on every elastic-state
    # commit each rank streams its 1/N shard of the serialized state
    # through the engine's checkpoint lane (two-phase manifest) and serves
    # the committed epoch to re-joining ranks peer-to-peer (disk is the
    # fallback).
    ckpt_dir: str = ""

    # Elastic (HOROVOD_ELASTIC=1: init() takes its assignment from the
    # driver's rendezvous).
    elastic: bool = False

    # Online autotuning (ops/autotune.py): HOROVOD_AUTOTUNE arms the
    # parameter manager, HOROVOD_AUTOTUNE_LOG is its CSV log.
    autotune: bool = False
    autotune_log: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_max_evals: int = 48

    # ZeRO-sharded optimizer.  HOROVOD_SHARDED_OPTIMIZER=1 makes every
    # DistributedOptimizer built without an explicit ``sharded=`` a
    # ``sharded=True`` one: gradients reduce-scatter, optimizer state lives
    # 1/world per rank, the updated shards allgather.
    # HOROVOD_SHARDED_PARAMS=1 (which takes precedence) makes it
    # ``sharded="full"`` (ZeRO-3/FSDP): the parameters too live 1/world
    # per rank between steps, and ``gather_params`` rematerializes them
    # through prefetch allgathers, HOROVOD_PREFETCH_DEPTH buckets ahead.
    # The two flags must be the same on every rank (the sharded token is
    # part of the negotiation digest); the depth is a local knob.
    sharded_optimizer: bool = False
    sharded_params: bool = False
    prefetch_depth: int = 2

    # Control-plane fault tolerance (protocol v4, docs/fault_tolerance.md).
    # round_timeout_s: per-negotiation-round wall-clock deadline — the
    # server declares ranks that miss it dead and broadcasts a typed ABORT
    # to survivors; the client bounds its own response wait at 2x.  Must
    # exceed the worst legitimate inter-rank skew; 0 disables the deadlines
    # (dead-socket detection is always on).  connect_retries /
    # connect_backoff_ms: bounded controller-connect retries with
    # exponential backoff + jitter, so workers may start before the
    # coordinator.
    round_timeout_s: float = 0.0
    connect_retries: int = 3
    connect_backoff_ms: float = 500.0

    # Zero-RTT warm control plane (protocol v7, docs/performance.md
    # "Zero-RTT warm path").  spec_ready_after (HOROVOD_SPEC_READY_AFTER):
    # after a response-cache slot has been ready-on-first-announce for
    # this many consecutive rounds, the root piggybacks a predicted
    # next-round verdict and clients may dispatch it without waiting for
    # the response; 0 (default) = off, every round lock-step.
    # round_pipeline (HOROVOD_ROUND_PIPELINE): client-side in-flight
    # negotiation-round window — 1 (default) = lock-step, >1 sends round
    # N+1's request before round N's response is read.  Results are
    # bitwise-identical either way (a mispredict only delays a verdict by
    # one normal round).
    spec_ready_after: int = 0
    round_pipeline: int = 1

    # Cross-rank telemetry & health subsystem (horovod_tpu_torch.monitor).
    # HOROVOD_MONITOR=1 enables the per-rank metric registry + the
    # coordinator monitor side-channel (protocol v3); HOROVOD_MONITOR_PORT
    # > 0 additionally serves /metrics (Prometheus) + /health (JSON) over
    # HTTP on rank 0; HOROVOD_MONITOR_INTERVAL is the snapshot reporting
    # period in seconds.
    monitor: bool = False
    monitor_port: int = 0
    monitor_interval_s: float = 5.0

    timeline_filename: str = ""
    timeline_mark_cycles: bool = False

    # Distributed collective tracing (horovod_tpu_torch.trace).
    # HOROVOD_TRACE=<path> arms per-tensor lifecycle spans AND writes this
    # rank's trace file there (the launcher suffixes the base per rank;
    # merge with `python -m horovod_tpu_torch.trace`); HOROVOD_TRACE=1 arms
    # the in-memory recorder only.  Unset = strictly zero cost.
    # HOROVOD_TRACE_RING bounds the preallocated span ring.
    trace: bool = False
    trace_filename: str = ""
    trace_ring: int = 4096

    stall_check_time_s: float = 60.0
    stall_shutdown_time_s: float = 0.0
    stall_check_disable: bool = False

    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # Two-level broadcast on the same slice topology: the root's leader
    # exchange over the cross group, then the fan-out inside each slice,
    # bitwise the flat broadcast (pure data movement).  Like the allgather
    # knob, the decision is purely topological (no payload crossover) and
    # rides the fusion key only, never the negotiation digest.
    hierarchical_broadcast: bool = False
    # Local-axis extent for the two-level (cross x local) collectives; 0 =
    # derive from the launcher's ranks per host (HOROVOD_LOCAL_COUNTS).
    hierarchical_local_size: int = 0
    # Payload crossover for the two-level data plane: fused allreduce
    # batches whose per-rank payload is at least this many bytes take the
    # RS(local) -> AR(cross) -> AG(local) schedule; smaller batches stay
    # flat.  0 = every eligible batch goes two-level once the mode is
    # armed.  Not part of the negotiation digest.
    hier_threshold_bytes: int = 0
    # Explicit slice membership ("4" = uniform slice size, "4,4" =
    # per-slice sizes); empty = derive from hierarchical_local_size, then
    # from the ranks per host (parallel/topology.py precedence order).
    slice_map: str = ""

    # Run the coordinator cycle inline on the submitting thread for blocking
    # single-controller ops (HOROVOD_INLINE_KICK; the small-tensor latency
    # fast path — off = legacy wake-the-cycle-thread dispatch).
    inline_kick: bool = True

    # Control plane (multi-process mode). Set by the launcher.
    controller_addr: str = ""
    controller_port: int = 0
    controller_port2: int = 0
    # The launcher's host index and host count (-1 = unset).
    cross_rank_env: int = -1
    cross_size_env: int = -1

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls(
            fusion_threshold_bytes=_env_int("FUSION_THRESHOLD", 64 * 1024 * 1024),
            cycle_time_ms=_env_float("CYCLE_TIME", 1.0),
            response_cache_capacity=_env_int("RESPONSE_CACHE_CAPACITY", 2048),
            pipeline_chunk_bytes=_env_int("PIPELINE_CHUNK", 0),
            max_inflight=_env_int("MAX_INFLIGHT", 2),
            fast_lane_threshold_bytes=_env_int("FAST_LANE_THRESHOLD", 0),
            partition_threshold_bytes=_env_int("PARTITION_THRESHOLD", 0),
            ckpt_chunk_bytes=_env_int("CKPT_CHUNK", 1 << 20),
            ckpt_lane_budget=_env_int("CKPT_LANE_BUDGET", 2),
            ckpt_dir=_env("CKPT_DIR", "") or "",
            elastic=_env_bool("ELASTIC", False),
            autotune=_env_bool("AUTOTUNE", False),
            autotune_log=_env("AUTOTUNE_LOG", "") or "",
            autotune_warmup_samples=_env_int("AUTOTUNE_WARMUP_SAMPLES", 3),
            autotune_steps_per_sample=_env_int("AUTOTUNE_STEPS_PER_SAMPLE",
                                               10),
            autotune_max_evals=_env_int("AUTOTUNE_MAX_EVALS", 48),
            round_timeout_s=_env_float("ROUND_TIMEOUT_S", 0.0),
            connect_retries=_env_int("CONNECT_RETRIES", 3),
            connect_backoff_ms=_env_float("CONNECT_BACKOFF_MS", 500.0),
            spec_ready_after=_env_int("SPEC_READY_AFTER", 0),
            round_pipeline=_env_int("ROUND_PIPELINE", 1),
            monitor=_env_bool("MONITOR", False),
            monitor_port=_env_int("MONITOR_PORT", 0),
            monitor_interval_s=_env_float("MONITOR_INTERVAL", 5.0),
            timeline_filename=_env("TIMELINE", "") or "",
            timeline_mark_cycles=_env_bool("TIMELINE_MARK_CYCLES", False),
            trace_ring=_env_int("TRACE_RING", 4096),
            stall_check_time_s=_env_float("STALL_CHECK_TIME", 60.0),
            stall_shutdown_time_s=_env_float("STALL_SHUTDOWN_TIME", 0.0),
            stall_check_disable=_env_bool("STALL_CHECK_DISABLE", False),
            hierarchical_allreduce=_env_bool("HIERARCHICAL_ALLREDUCE", False),
            hierarchical_allgather=_env_bool("HIERARCHICAL_ALLGATHER", False),
            hierarchical_broadcast=_env_bool("HIERARCHICAL_BROADCAST", False),
            hierarchical_local_size=_env_int("HIERARCHICAL_LOCAL_SIZE", 0),
            hier_threshold_bytes=_env_int("HIER_THRESHOLD", 0),
            slice_map=_env("SLICE_MAP", "") or "",
            inline_kick=_env_bool("INLINE_KICK", True),
            controller_addr=_env("CONTROLLER_ADDR", "") or "",
            controller_port=_env_int("CONTROLLER_PORT", 0),
            controller_port2=_env_int("CONTROLLER_PORT2", 0),
            cross_rank_env=_env_int("CROSS_RANK", -1),
            cross_size_env=_env_int("CROSS_SIZE", -1),
            sharded_optimizer=_env_bool("SHARDED_OPTIMIZER", False),
            sharded_params=_env_bool("SHARDED_PARAMS", False),
            prefetch_depth=_env_int("PREFETCH_DEPTH", 2),
        )
        # HOROVOD_TRACE: a bool-ish value arms the in-memory recorder only;
        # anything else is the per-rank trace file path (and arms it).
        raw_trace = (_env("TRACE", "") or "").strip()
        if raw_trace:
            cfg.trace = raw_trace.lower() not in ("0", "false", "no", "off")
            if cfg.trace and raw_trace.lower() not in ("1", "true", "yes",
                                                       "on"):
                cfg.trace_filename = raw_trace
        return cfg
