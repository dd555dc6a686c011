# Ported from horovod_tpu/runner/run.py:1-650: HostSpec, parse_hosts,
# parse_hostfile, the argument surface, _apply_config_file, placement,
# tuning_env (with the --hierarchical-* switches of :175-182, 438-443),
# wait_and_reap, worker_envs, ssh_command, launch_workers and main; the
# observability flags (:121-137) and their forwarding (:409-427, :536-541);
# the sharded optimizer's flags (:155-175) and their forwarding (:433-437);
# the data-plane depth flags (:97-110, 153-154) and their forwarding
# (:398-402, 428-431); the elastic flags (:204-214) and the state plane's
# (:236-249), their forwarding (:415-422) and the route to the elastic
# driver (:302-307, 625-628); the hierarchical controller, autoscale,
# preemption and commit-age flags (:198-204, 216-235, 250-253), their
# forwarding (:417, 444-445) and the agent ports (:501-534, 577-593); the
# serving flags (:188-197) and their forwarding (:446-453).
# platform_worker_env (:359-388, JAX and XLA variables) is replaced by the
# card's counterpart; the flags of what the port lacks are refused.
"""The launcher's argument surface and launch orchestration.

Parity with the reference launcher (``horovod/runner/launch.py``, ``run.py``,
``gloo_run.py`` — SURVEY.md §2b P7, §3.3): parse ``-np``/``-H``/
``--hostfile`` and the tuning flags (plus ``--config-file`` YAML mirroring
them), compute the rank→host placement, and spawn one worker process per
rank, locally or over ssh, with the ``HOROVOD_*`` environment injected.
Rank 0's host serves the ``torch.distributed`` rendezvous at
``HOROVOD_CONTROLLER_PORT`` and the negotiation coordinator at
``HOROVOD_CONTROLLER_PORT2`` (``common/basics.py`` ``init``), and each
worker computes on ``cuda:{HOROVOD_LOCAL_RANK}``; the launcher sets no
``CUDA_VISIBLE_DEVICES``.  Every worker also gets ``HOROVOD_LOCAL_COUNTS``,
the ranks of each host entry in host order (the same list on every rank:
``common/topology.py`` derives the two-level slices from it), and
``--hierarchical-allreduce``/``-allgather``/``-broadcast`` reach it as
``HOROVOD_HIERARCHICAL_*=1``.  ``--timeline-filename`` and
``--trace-filename`` reach each worker as ``HOROVOD_TIMELINE`` and
``HOROVOD_TRACE`` with its rank appended (``utils/timeline.py``
``per_rank_filename``), ``--monitor`` (or ``--monitor-port``),
``--monitor-port``, ``--monitor-interval``, ``--trace-ring`` and
``--timeline-mark-cycles`` as ``HOROVOD_MONITOR``, ``_MONITOR_PORT``,
``_MONITOR_INTERVAL``, ``_TRACE_RING`` and ``_TIMELINE_MARK_CYCLES``;
``--sharded``, ``--sharded-params`` and ``--prefetch-depth`` as
``HOROVOD_SHARDED_OPTIMIZER=1``, ``HOROVOD_SHARDED_PARAMS=1`` and
``HOROVOD_PREFETCH_DEPTH``; ``--pipeline-chunk-mb``,
``--fast-lane-threshold-kb``, ``--partition-threshold-mb``, ``--autotune``
and ``--autotune-log-file`` as ``HOROVOD_PIPELINE_CHUNK``,
``_FAST_LANE_THRESHOLD``, ``_PARTITION_THRESHOLD`` (bytes),
``HOROVOD_AUTOTUNE=1`` and ``HOROVOD_AUTOTUNE_LOG``; ``--ckpt-dir``,
``--ckpt-chunk-mb`` and ``--ckpt-lane-budget`` as ``HOROVOD_CKPT_DIR``,
``_CKPT_CHUNK`` (bytes) and ``_CKPT_LANE_BUDGET``;
``--hierarchical-controller`` and ``--commit-max-age-s`` as
``HOROVOD_HIERARCHICAL_CONTROLLER=1`` and ``HOROVOD_COMMIT_MAX_AGE_S``,
and with the two-level control plane each local host entry's agent gets a
bind-probed port (``HOROVOD_AGENT_PORT``).

``--host-discovery-script`` (with ``--min-np``, ``--max-np`` and
``--slots-per-host``) starts an elastic job instead: the elastic driver
(``elastic/driver.py``; ``--autoscale``, ``--autoscale-interval``,
``--scale-command`` and ``--preempt-grace-s`` configure its autoscaler
and drains) polls the script, publishes each generation's
assignment on its rendezvous and spawns the workers, each with
``HOROVOD_ELASTIC=1`` and ``platform_worker_env``'s elastic form: the
card's variables keyed on the host entry's name, which outlives the
generation (its index does not), and ProcessGroupNCCL's error handling set
to abort the communicators and keep the process
(``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``).
Every entry that names this machine
(``common/net.is_local_host``: ``localhost``, ``127.0.0.2``, its name or
addresses) is spawned here; the others by ssh.

Every worker loads its CUDA kernels eagerly (``platform_worker_env``).
Where two ``-H`` entries are the same machine (``localhost:1,127.0.0.1:1``
on one card), each entry's ranks get their own ``NCCL_HOSTID``: NCCL refuses
two ranks of one host on one GPU and keys that check on the host, so the
ranks join over NCCL's socket transport instead (on the loopback device for
loopback entries).

A flag whose feature the port lacks is refused when it is parsed, naming
the ROADMAP item that brings it, rather than forwarded to workers that
would ignore it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shlex
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.timeline import per_rank_filename


@dataclasses.dataclass
class HostSpec:
    hostname: str
    slots: int


def parse_hosts(hosts: str) -> List[HostSpec]:
    """Parse ``-H host1:2,host2:4`` (reference: runner/common/util/hosts.py)."""
    specs = []
    for part in hosts.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            specs.append(HostSpec(name, int(slots)))
        else:
            specs.append(HostSpec(part, 1))
    return specs


def parse_hostfile(path: str) -> List[HostSpec]:
    """Parse a hostfile with ``hostname slots=N`` lines (reference format)."""
    specs = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            fields = line.split()
            name = fields[0]
            slots = 1
            for f in fields[1:]:
                if f.startswith("slots="):
                    slots = int(f.split("=", 1)[1])
            specs.append(HostSpec(name, slots))
    return specs


# The JAX launcher's flags whose feature the port lacks: flag → what brings
# it.  Each is parsed, then refused.
_TPU = "runner/tpu_vm.py has no GPU counterpart"
NOT_PORTED: Dict[str, str] = {
    "--tpu": _TPU, "--zone": _TPU, "--project": _TPU,
    "--tpu-topology-aware": _TPU, "--gke-jobset": _TPU,
    "--container-image": _TPU, "--gke-num-hosts": _TPU,
    "--gke-accelerator": _TPU, "--gke-topology": _TPU,
    "--gke-chips-per-host": _TPU,
    "--tpu-metadata-discovery": _TPU,
    "--cache-capacity": "the port compiles no fused programs to cache (the "
                        "negotiation response cache is "
                        "HOROVOD_RESPONSE_CACHE_CAPACITY)",
}
# Those of them that take no value.
_SWITCHES = {"--tpu-topology-aware", "--tpu-metadata-discovery"}

# Tuning flags forwarded to every worker as HOROVOD_* env: flag, variable,
# scale.  Each is read by the port's Config.from_env.
_TUNING = (("fusion_threshold_mb", "HOROVOD_FUSION_THRESHOLD", 1024 * 1024),
           ("cycle_time_ms", "HOROVOD_CYCLE_TIME", 1),
           ("max_inflight", "HOROVOD_MAX_INFLIGHT", 1),
           ("spec_ready_after", "HOROVOD_SPEC_READY_AFTER", 1),
           ("round_pipeline", "HOROVOD_ROUND_PIPELINE", 1),
           ("stall_check_time", "HOROVOD_STALL_CHECK_TIME", 1),
           ("stall_shutdown_time", "HOROVOD_STALL_SHUTDOWN_TIME", 1),
           ("round_timeout", "HOROVOD_ROUND_TIMEOUT_S", 1),
           ("connect_retries", "HOROVOD_CONNECT_RETRIES", 1),
           ("connect_backoff_ms", "HOROVOD_CONNECT_BACKOFF_MS", 1))
# The data-plane depth flags with a value, forwarded the same way.
_DEPTH = (("pipeline_chunk_mb", "HOROVOD_PIPELINE_CHUNK", 1024 * 1024),
          ("fast_lane_threshold_kb", "HOROVOD_FAST_LANE_THRESHOLD", 1024),
          ("partition_threshold_mb", "HOROVOD_PARTITION_THRESHOLD",
           1024 * 1024),
          ("ckpt_chunk_mb", "HOROVOD_CKPT_CHUNK", 1024 * 1024),
          ("ckpt_lane_budget", "HOROVOD_CKPT_LANE_BUDGET", 1),
          ("commit_max_age_s", "HOROVOD_COMMIT_MAX_AGE_S", 1))
# The observability flags with a value, forwarded the same way (the file
# names go per rank, in worker_envs).
_OBSERVE = (("monitor_port", "HOROVOD_MONITOR_PORT", 1),
            ("monitor_interval", "HOROVOD_MONITOR_INTERVAL", 1),
            ("trace_ring", "HOROVOD_TRACE_RING", 1))


# Two-level data-plane switches, forwarded as HOROVOD_<FLAG>=1.
_HIER_FLAGS = ("hierarchical_allreduce", "hierarchical_allgather",
               "hierarchical_broadcast")


def _dest(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


def parse_args(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner",
        description="Launch a horovod_tpu_torch distributed job",
        usage="python -m horovod_tpu_torch.runner -np NP [options] "
              "<command> [args...]")
    p.add_argument("-np", "--num-proc", type=int, dest="np",
                   help="Total number of worker processes")
    p.add_argument("-H", "--hosts", dest="hosts",
                   help="Comma-separated host:slots list")
    p.add_argument("--hostfile", dest="hostfile",
                   help="Hostfile with 'hostname slots=N' lines")
    p.add_argument("--network-interface", dest="nics",
                   help="Network interface(s) for the control plane")
    p.add_argument("--start-timeout", type=int, default=600)
    p.add_argument("--ssh-port", type=int, default=None)
    p.add_argument("--ssh-identity-file", default=None)
    p.add_argument("--verbose", "-v", action="count", default=0)
    p.add_argument("--config-file", dest="config_file",
                   help="YAML config mirroring the CLI flags")
    p.add_argument("--output-filename", dest="output_filename",
                   help="Redirect worker stdout/stderr to "
                        "<dir>/rank.<N>/stdout|stderr")
    # Tuning knobs forwarded as HOROVOD_* env (reference: launch.py does the
    # same forwarding).
    p.add_argument("--fusion-threshold-mb", type=int, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--max-inflight", type=int, default=None,
                   help="Bound on dispatched-but-unsettled fused batches "
                        "(1 = settle inline, no overlap)")
    p.add_argument("--spec-ready-after", type=int, default=None,
                   help="Zero-RTT warm path (protocol v7): after a "
                        "response-cache slot has been ready-on-first-"
                        "announce for this many consecutive rounds, the "
                        "coordinator predicts the next-round verdict and "
                        "clients dispatch it without waiting; 0 = off")
    p.add_argument("--round-pipeline", type=int, default=None,
                   help="In-flight negotiation-round window per client: "
                        "1 = lock-step (default), >1 sends round N+1's "
                        "request before round N's response is read")
    p.add_argument("--stall-check-time", type=float, default=None)
    p.add_argument("--stall-shutdown-time", type=float, default=None)
    p.add_argument("--round-timeout", type=float, default=None,
                   help="Per-negotiation-round wall-clock deadline in "
                        "seconds: ranks that miss it are declared dead and "
                        "survivors get a typed HVD303 abort; 0/unset "
                        "disables the deadline (dead-socket detection is "
                        "always on)")
    p.add_argument("--connect-retries", type=int, default=None,
                   help="Bounded controller-connect retries (workers may "
                        "start before the coordinator)")
    p.add_argument("--connect-backoff-ms", type=float, default=None,
                   help="Base backoff between connect retries "
                        "(exponential, jittered)")
    p.add_argument("--hierarchical-allreduce", action="store_true",
                   help="Two-level allreduce on the slice topology: "
                        "reduce-scatter inside each slice, allreduce "
                        "across slices, allgather inside; Adasum's "
                        "halving-doubling with its local rounds first "
                        "(HOROVOD_HIERARCHICAL_ALLREDUCE; slices from "
                        "HOROVOD_SLICE_MAP, HOROVOD_HIERARCHICAL_LOCAL_"
                        "SIZE or uniform hosts)")
    p.add_argument("--hierarchical-allgather", action="store_true",
                   help="Two-level allgather on the slice topology "
                        "(inside each slice, then across), bitwise the "
                        "flat one (HOROVOD_HIERARCHICAL_ALLGATHER)")
    p.add_argument("--hierarchical-controller", action="store_true",
                   help="Two-level control plane: a per-host agent "
                        "aggregates its ranks' warm-path negotiation "
                        "frames into one fixed-size uplink per round, so "
                        "the rank-0 coordinator's gather scales with "
                        "hosts, not ranks (HOROVOD_HIERARCHICAL_"
                        "CONTROLLER)")
    p.add_argument("--hierarchical-broadcast", action="store_true",
                   help="Two-level broadcast on the slice topology (the "
                        "root to each slice, then the fan-out inside), "
                        "bitwise the flat one "
                        "(HOROVOD_HIERARCHICAL_BROADCAST)")
    p.add_argument("--serve", action="store_true",
                   help="Serving plane (docs/serving.md): each rank runs "
                        "a continuous-batching front door and a replica's "
                        "forward loop instead of a training loop.  "
                        "Forwarded as HOROVOD_SERVE; knobs via "
                        "HOROVOD_SERVE_* (port, max batch, buckets, "
                        "deadline, inflight window, queue depth)")
    p.add_argument("--serve-port", type=int, default=None,
                   help="Front-door HTTP port base; rank r listens on "
                        "port+r (HOROVOD_SERVE_PORT; 0/unset = ephemeral)")
    p.add_argument("--timeline-filename", default=None,
                   help="Write a Chrome-trace timeline per rank at "
                        "<base>.<rank> (HOROVOD_TIMELINE)")
    p.add_argument("--timeline-mark-cycles", action="store_true",
                   help="Mark the coordinator's cycles in the timeline")
    p.add_argument("--trace-filename", default=None,
                   help="Arm collective tracing and write one trace file "
                        "per rank at <base>.<rank>; merge with `python -m "
                        "horovod_tpu_torch.trace`")
    p.add_argument("--trace-ring", type=int, default=None,
                   help="Preallocated trace span-ring capacity "
                        "(default 4096)")
    p.add_argument("--monitor", action="store_true",
                   help="Enable the cross-rank telemetry & health "
                        "subsystem")
    p.add_argument("--monitor-port", type=int, default=None,
                   help="Serve /metrics (Prometheus) + /health (JSON) "
                        "over HTTP on rank 0 at this port (implies "
                        "--monitor)")
    p.add_argument("--monitor-interval", type=float, default=None,
                   help="Telemetry snapshot period in seconds (default 5)")
    p.add_argument("--sharded", action="store_true",
                   help="ZeRO-sharded optimizer: DistributedOptimizer "
                        "defaults to sharded=True (reduce-scatter of "
                        "gradients, 1/N optimizer state a rank, allgather "
                        "of the updated shards); forwarded as "
                        "HOROVOD_SHARDED_OPTIMIZER so that every rank takes "
                        "the same data plane")
    p.add_argument("--sharded-params", action="store_true",
                   help="Full parameter sharding (ZeRO-3/FSDP): "
                        'DistributedOptimizer defaults to sharded="full" '
                        "(parameters live 1/N a rank between steps, "
                        "gather_params() rematerializes them through "
                        "prefetch allgathers, gradients reduce-scatter "
                        "into the owning shard); forwarded as "
                        "HOROVOD_SHARDED_PARAMS")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="FSDP parameter-gather buckets in flight ahead of "
                        "use (HOROVOD_PREFETCH_DEPTH; default 2)")
    p.add_argument("--pipeline-chunk-mb", type=float, default=None,
                   help="Chunk size (MB) for pipelined fused reductions "
                        "(HOROVOD_PIPELINE_CHUNK; also the sharded "
                        "optimizer's bucket size); 0 = one chunk per fused "
                        "batch (no chunking)")
    p.add_argument("--fast-lane-threshold-kb", type=float, default=None,
                   help="Latency fast lane: ungrouped allreduces below "
                        "this many KB skip the fusion batching (single-"
                        "tensor batches with pinned plans; "
                        "HOROVOD_FAST_LANE_THRESHOLD); 0 = off")
    p.add_argument("--partition-threshold-mb", type=float, default=None,
                   help="Split allreduces above this many MB into priority-"
                        "inheriting parts (ByteScheduler-style preemption; "
                        "HOROVOD_PARTITION_THRESHOLD); 0 = off")
    p.add_argument("--autotune", action="store_true",
                   help="Tune the engine's knobs online (HOROVOD_AUTOTUNE)")
    p.add_argument("--autotune-log-file", default=None,
                   help="The autotuner's CSV log (HOROVOD_AUTOTUNE_LOG)")
    # Elastic (reference: _run_elastic)
    p.add_argument("--min-np", type=int, default=None,
                   help="Elastic: the fewest ranks the job runs with")
    p.add_argument("--max-np", type=int, default=None,
                   help="Elastic: the most ranks the job runs with")
    p.add_argument("--host-discovery-script", default=None,
                   help="Elastic: a command printing the available hosts, "
                        "one 'hostname[:slots]' a line; polled by the "
                        "elastic driver, which re-forms the world when it "
                        "changes")
    p.add_argument("--slots-per-host", type=int, default=None,
                   help="Elastic: slots of a discovered host that names "
                        "none (default 1)")
    p.add_argument("--autoscale", action="store_true",
                   help="Elastic: closed-loop autoscaling — the driver "
                        "polls rank 0's monitor /health and scales the "
                        "world itself: out on rising load, straggler "
                        "drain-and-evict on monitor attribution, in when "
                        "idle.  Requires --monitor-port; knobs via "
                        "HOROVOD_AUTOSCALE_*")
    p.add_argument("--autoscale-interval", type=float, default=None,
                   help="Elastic: seconds between autoscale policy "
                        "observations (default 5)")
    p.add_argument("--scale-command", default=None,
                   help="Elastic: operator capacity hook run on scale "
                        "decisions with HVD_AUTOSCALE_ACTION/TARGET/HOST "
                        "in env; it changes what --host-discovery-script "
                        "reports (e.g. resizes an instance group)")
    p.add_argument("--preempt-grace-s", type=float, default=None,
                   help="Elastic: drain grace for preemption notices — a "
                        "noticed host's workers get this long to commit "
                        "and leave cleanly before the driver falls back to "
                        "termination (default 30)")
    p.add_argument("--ckpt-dir", default=None,
                   help="Resilient state plane: arm sharded checkpoints "
                        "under this directory — each rank streams its 1/N "
                        "state shard through the engine's checkpoint lane "
                        "on every elastic-state commit, and re-joining "
                        "ranks restore peer-to-peer from survivors "
                        "(HOROVOD_CKPT_DIR)")
    p.add_argument("--ckpt-chunk-mb", type=float, default=None,
                   help="Checkpoint-lane chunk size in MB (one bounded "
                        "write per lane dispatch; default 1; "
                        "HOROVOD_CKPT_CHUNK)")
    p.add_argument("--ckpt-lane-budget", type=int, default=None,
                   help="Checkpoint chunks dispatched per engine cycle "
                        "tail (default 2; HOROVOD_CKPT_LANE_BUDGET)")
    p.add_argument("--commit-max-age-s", type=float, default=None,
                   help="Autoscaler stale-state guard: refuse evict/"
                        "scale_in while the fleet's last state-plane "
                        "commit is older than this (0 = off; "
                        "HOROVOD_COMMIT_MAX_AGE_S)")
    for flag, why in NOT_PORTED.items():
        if flag in _SWITCHES:
            p.add_argument(flag, action="store_true", help=f"refused: {why}")
        else:
            p.add_argument(flag, default=None, help=f"refused: {why}")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="Training command")
    args = p.parse_args(list(argv))

    if args.config_file:
        _apply_config_file(args)
    for flag, why in NOT_PORTED.items():
        if getattr(args, _dest(flag)) not in (None, False):
            p.error(f"{flag} is not ported: {why}")
    if not args.command:
        p.error("no training command given")
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if args.np is None and args.host_discovery_script is None:
        p.error("-np is required (or elastic --host-discovery-script)")
    return args


def _apply_config_file(args: argparse.Namespace):
    """YAML config file mirroring flags (reference: --config-file)."""

    def parse_scalar(v: str):
        v = v.strip()
        if v.lower() in ("true", "yes"):
            return True
        if v.lower() in ("false", "no"):
            return False
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
        return v

    with open(args.config_file) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, val = line.split(":", 1)
            key = key.strip().replace("-", "_")
            if hasattr(args, key) and getattr(args, key) in (None, False):
                setattr(args, key, parse_scalar(val))


def placement(args) -> List[HostSpec]:
    if args.hostfile:
        hosts = parse_hostfile(args.hostfile)
    elif args.hosts:
        hosts = parse_hosts(args.hosts)
    else:
        hosts = [HostSpec("localhost", args.np)]
    total = sum(h.slots for h in hosts)
    if args.np is not None and total < args.np:
        raise ValueError(f"Requested -np {args.np} but hosts provide only "
                         f"{total} slots")
    return hosts


def _free_ports(n: int) -> List[int]:
    from ..common.net import free_ports
    return free_ports(n)


def _is_loopback(hostname: str) -> bool:
    return hostname == "localhost" or hostname.startswith("127.")


def platform_worker_env(hosts: List[HostSpec], cross_rank: int,
                        base: Optional[Dict[str, str]] = None,
                        elastic: bool = False) -> Dict[str, str]:
    """The card's env for the ranks of host entry ``cross_rank``.

    Every worker loads its CUDA kernels when its context is made
    (``CUDA_MODULE_LOADING=EAGER``): under CUDA's lazy loading a kernel's
    first launch may wait for the whole context to go idle, which a
    collective kernel spinning for a peer never does, and two ranks each
    loading a kernel beside such a kernel wait for each other for ever
    (the engine's allreduces beside the sequence-parallel exchanges of a
    first step did).  ``hvd.init()`` cannot do it alone: the driver reads
    the variable once, when it initialises, and a script usually calls
    ``torch.cuda.is_available()`` before ``init()``.  Where another entry
    is the same machine, the entry also gets its own ``NCCL_HOSTID`` (NCCL
    refuses two ranks of one host on one GPU, and checks by host), and a
    loopback entry NCCL's socket transport on the loopback device with
    InfiniBand off.  A variable already in ``base`` (the launcher's env)
    is the user's choice and stays.

    ``elastic=True`` is an elastic worker's env, fixed at its spawn while
    its host index and the other hosts change between generations: every
    entry naming this machine gets its ``NCCL_HOSTID``, keyed on the
    entry's name (which every generation keeps), so that two entries
    sharing a card stay apart in whichever generation brings them
    together; and ``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``, under which
    ProcessGroupNCCL's watchdog aborts the communicators of a failed or
    timed-out collective and keeps the process (torch's default ends it,
    and with it the survivor elastic recovery exists to save)."""
    from ..common.net import is_local_host
    base = os.environ if base is None else base
    out = {"CUDA_MODULE_LOADING": "EAGER"}
    local = [is_local_host(h.hostname) for h in hosts]
    h = hosts[cross_rank]
    if elastic:
        from ..elastic.worker import NCCL_ERROR_HANDLING
        out["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = NCCL_ERROR_HANDLING
        if local[cross_rank]:
            out["NCCL_HOSTID"] = f"hvd-{h.hostname}"
    elif local[cross_rank] and sum(local) >= 2:
        out["NCCL_HOSTID"] = f"hvd-{cross_rank}-{h.hostname}"
    if "NCCL_HOSTID" in out and _is_loopback(h.hostname):
        out.update(NCCL_SOCKET_IFNAME="lo", NCCL_IB_DISABLE="1")
    return {k: base.get(k, v) for k, v in out.items()}


def tuning_env(args) -> Dict[str, str]:
    """HOROVOD_* env derived from the launcher's tuning flags — shared by
    every launch path so a knob can never work on one path and silently
    vanish on another.  A flag the port has no feature for never gets
    here: ``parse_args`` refuses it."""
    env: Dict[str, str] = {}
    for flag, var, scale in _TUNING + _DEPTH + _OBSERVE:
        val = getattr(args, flag, None)
        if val is not None:
            env[var] = str(int(val * scale) if scale != 1 else val)
    for flag in _HIER_FLAGS:
        if getattr(args, flag, False):
            env[f"HOROVOD_{flag.upper()}"] = "1"
    if getattr(args, "monitor", False) \
            or getattr(args, "monitor_port", None):
        env["HOROVOD_MONITOR"] = "1"
    if getattr(args, "timeline_mark_cycles", False):
        env["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    if getattr(args, "autotune", False):
        env["HOROVOD_AUTOTUNE"] = "1"
        if getattr(args, "autotune_log_file", None):
            env["HOROVOD_AUTOTUNE_LOG"] = args.autotune_log_file
    if getattr(args, "sharded", False):
        env["HOROVOD_SHARDED_OPTIMIZER"] = "1"
    if getattr(args, "sharded_params", False):
        env["HOROVOD_SHARDED_PARAMS"] = "1"
    if getattr(args, "prefetch_depth", None) is not None:
        env["HOROVOD_PREFETCH_DEPTH"] = str(int(args.prefetch_depth))
    if getattr(args, "ckpt_dir", None):
        env["HOROVOD_CKPT_DIR"] = args.ckpt_dir
    if getattr(args, "hierarchical_controller", False):
        env["HOROVOD_HIERARCHICAL_CONTROLLER"] = "1"
    # The serving plane: the worker derives its own port, serve_port +
    # rank, from the base.
    if getattr(args, "serve", False):
        env["HOROVOD_SERVE"] = "1"
    if getattr(args, "serve_port", None) is not None:
        env["HOROVOD_SERVE_PORT"] = str(int(args.serve_port))
    return env


def wait_and_reap(procs: List[subprocess.Popen],
                  poll_interval_s: float = 0.2) -> int:
    """Wait for every worker, propagate the first failure, terminate
    stragglers.

    Polls ALL workers rather than waiting in list order: the moment any
    worker exits nonzero, the survivors are terminated — one crashed rank
    must not leave the rest running until their own timeouts fire (the
    reference launcher's safe_shell_exec kills the process group the same
    way).
    """
    import time
    rc = 0
    live = list(procs)
    try:
        while live:
            still = []
            for p in live:
                code = p.poll()
                if code is None:
                    still.append(p)
                elif code != 0 and rc == 0:
                    rc = code
            live = still
            if rc != 0:
                break
            if live:
                time.sleep(poll_interval_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    return rc


def worker_envs(args, hosts: List[HostSpec],
                coordinator: Tuple[str, int, int],
                agent_ports: Optional[List[Optional[int]]] = None
                ) -> List[Dict[str, str]]:
    """Compute the per-rank env injection (reference §3.3: HOROVOD_RANK,
    HOROVOD_SIZE, HOROVOD_LOCAL_RANK, HOROVOD_CROSS_RANK, rendezvous addr).

    ``agent_ports`` (hierarchical control plane): one launcher-allocated
    listen port per host for that host's aggregation agent, injected as
    HOROVOD_AGENT_PORT so every process on a host agrees where its agent
    lives.  A None entry means no injection for that host (remote hosts:
    a port bind-probed on the launcher proves nothing there — the
    config-side deterministic fallback derives one instead)."""
    np_total = args.np
    envs = []
    rank = 0
    # Ranks on each host entry, host-major: the same list for every rank,
    # from which each derives the slices (common/topology.py).
    counts, left = [], np_total
    for h in hosts:
        if left <= 0:
            break
        counts.append(min(h.slots, left))
        left -= counts[-1]
    for cross_rank, h in enumerate(hosts):
        for local_rank in range(h.slots):
            if rank >= np_total:
                break
            env = platform_worker_env(hosts, cross_rank)
            env |= {
                "HOROVOD_RANK": str(rank),
                "HOROVOD_SIZE": str(np_total),
                "HOROVOD_LOCAL_RANK": str(local_rank),
                "HOROVOD_LOCAL_SIZE": str(min(h.slots, np_total - rank + local_rank)),
                "HOROVOD_CROSS_RANK": str(cross_rank),
                "HOROVOD_CROSS_SIZE": str(len(hosts)),
                "HOROVOD_LOCAL_COUNTS": ",".join(map(str, counts)),
                "HOROVOD_CONTROLLER_ADDR": coordinator[0],
                "HOROVOD_CONTROLLER_PORT": str(coordinator[1]),
                "HOROVOD_CONTROLLER_PORT2": str(coordinator[2]),
                "HOROVOD_HOSTNAME": h.hostname,
            }
            if agent_ports is not None \
                    and agent_ports[cross_rank] is not None:
                env["HOROVOD_AGENT_PORT"] = str(agent_ports[cross_rank])
            env |= tuning_env(args)
            if args.timeline_filename:
                env["HOROVOD_TIMELINE"] = per_rank_filename(
                    args.timeline_filename, rank)
            if args.trace_filename:
                env["HOROVOD_TRACE"] = per_rank_filename(
                    args.trace_filename, rank)
            envs.append(env)
            rank += 1
    return envs


def ssh_command(host: str, env: Dict[str, str], command: List[str],
                ssh_port: Optional[int] = None,
                identity_file: Optional[str] = None) -> List[str]:
    """Build the remote spawn command (reference: gloo_run's ssh exec via
    safe_shell_exec; tested by asserting on the generated argv, like
    ``test/single/test_run.py``)."""
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in sorted(env.items()))
    remote = f"cd {shlex.quote(os.getcwd())} && env {exports} " + \
        " ".join(shlex.quote(c) for c in command)
    cmd = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        cmd += ["-p", str(ssh_port)]
    if identity_file:
        cmd += ["-i", identity_file]
    cmd += [host, remote]
    return cmd


def launch_workers(args, hosts: List[HostSpec],
                   addrs: Optional[Dict[str, str]] = None) -> int:
    """Spawn all workers, wait, propagate first failure (local + ssh).

    ``addrs`` (from the bootstrap probe phase) overrides the coordinator
    address with host 0's resolved control-plane address — this is what
    makes ``--network-interface`` actually select the control plane."""
    from ..common.net import is_local_host
    # Hierarchical control plane: one extra port per host for its
    # aggregation agent.  Bind-probed HERE only for local/loopback hosts
    # — a port free on the launcher proves nothing on a remote host, so
    # remote hosts get NO injection and derive their own from the
    # controller port and their host index (common/basics.py).
    agent_ports = None
    if getattr(args, "hierarchical_controller", False):
        local_hosts = [is_local_host(h.hostname) for h in hosts]
        probed = iter(_free_ports(2 + sum(local_hosts)))
        ports = [next(probed), next(probed)]
        agent_ports = [next(probed) if loc else None for loc in local_hosts]
    else:
        ports = _free_ports(2)
    if addrs:
        coord_host = addrs[hosts[0].hostname]
    else:
        coord_host = (hosts[0].hostname if hosts[0].hostname != "localhost"
                      else "127.0.0.1")
    coord = (coord_host, ports[0], ports[1])
    envs = worker_envs(args, hosts, coord, agent_ports=agent_ports)
    procs: List[subprocess.Popen] = []
    for rank, env in enumerate(envs):
        host = env["HOROVOD_HOSTNAME"]
        full_env = {**os.environ, **env}
        stdout = stderr = None
        if args.output_filename:
            d = os.path.join(args.output_filename, f"rank.{rank}")
            os.makedirs(d, exist_ok=True)
            stdout = open(os.path.join(d, "stdout"), "w")
            stderr = open(os.path.join(d, "stderr"), "w")
        if is_local_host(host):
            proc = subprocess.Popen(args.command, env=full_env,
                                    stdout=stdout, stderr=stderr)
        else:
            cmd = ssh_command(host, env, args.command, args.ssh_port,
                              args.ssh_identity_file)
            proc = subprocess.Popen(cmd, env=os.environ.copy(),
                                    stdout=stdout, stderr=stderr)
        procs.append(proc)
    return wait_and_reap(procs)


def main(argv: Sequence[str]) -> int:
    args = parse_args(argv)
    if args.host_discovery_script is not None:
        from ..elastic.driver import run_elastic
        return run_elastic(args)
    hosts = placement(args)
    if args.verbose:
        print(f"[horovod_tpu_torch.runner] launching np={args.np} over "
              f"{[(h.hostname, h.slots) for h in hosts]}", file=sys.stderr)
    # Pre-launch bootstrap (reference P8): probe NICs + mutual connectivity
    # whenever a host is remote or an explicit interface was requested —
    # refuse fast with the exact broken pair instead of spawning workers
    # that would hang in rendezvous.
    addrs = None
    from ..common.net import is_local_host
    if args.nics or any(not is_local_host(h.hostname) for h in hosts):
        from .bootstrap import bootstrap_hosts
        try:
            addrs = bootstrap_hosts(
                hosts, nic=args.nics, ssh_port=args.ssh_port,
                identity_file=args.ssh_identity_file,
                timeout_s=min(args.start_timeout, 120),
                verbose=args.verbose)
        except RuntimeError as exc:
            print(f"[horovod_tpu_torch.runner] {exc}", file=sys.stderr)
            return 1
    return launch_workers(args, hosts, addrs)
