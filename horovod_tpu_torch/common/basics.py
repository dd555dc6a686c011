"""Core runtime state and the ``init``/``rank``/``size`` API family.

Port of ``horovod_tpu/common/basics.py:77-200``, with the engine's start
(:92-97, 150-157, 228-247, 273) and shutdown order (:278-345), the
timeline (:146-148, 354-356), the monitor agent (:249-272, 318-320), the
host queries (:447-466), the capability probes (:494-515) and the
timeline and profiler controls (:522-570).  The world
contract:

- With no ``HOROVOD_*`` env the world is one process of size 1 and no
  process group is formed; the collective engine still runs (local
  negotiation, fusion, the pack and unpack kernels) and its collective is
  the identity.
- With ``HOROVOD_RANK``, ``HOROVOD_SIZE``, ``HOROVOD_LOCAL_RANK`` and
  ``HOROVOD_CONTROLLER_ADDR``/``HOROVOD_CONTROLLER_PORT`` set (the launcher
  contract of ``horovod_tpu/runner/run.py``) and a size above 1, ``init()``
  forms the ``torch.distributed`` world at that address (NCCL when the
  device is a card, gloo on the CPU) and connects the negotiation
  controller, the copied ``TCPController``, at
  ``HOROVOD_CONTROLLER_PORT2`` or else the next port up; rank 0 hosts the
  coordinator's server.

The device is ``cuda:{local_rank}`` unless the caller asks for the CPU
(``init(device="cpu")``, as the tests do).  At a size above 1 on a card
the process must load its CUDA kernels eagerly: under CUDA's lazy module
loading a kernel's first launch may wait for the context to go idle, which
a collective kernel spinning for a peer never lets it do, and two ranks
each loading a kernel beside one wait for each other for ever.  ``init()``
asks for eager loading (``CUDA_MODULE_LOADING=EAGER``) when the variable
is unset and the CUDA driver not yet initialised, and warns when the
driver reports lazy loading all the same: the driver reads the variable
once, at its initialisation, which ``torch.cuda.is_available()`` already
performs.  The port's launcher sets the variable for every worker.

With no card and no request for the CPU ``init()`` raises: the port
never carries on on the CPU by itself.

``init()`` builds the world's layout over hosts (``common/topology.py``,
from the launcher's ``HOROVOD_LOCAL_COUNTS``), as the JAX ``init()`` builds
its topology (:139), and has the engine make the two-level data plane's
groups where the global set has a slice topology
(``ops/engine.py`` ``_make_hier_groups``).

Observability: ``init()`` opens the Chrome timeline when
``HOROVOD_TIMELINE`` names a file (the launcher's
``--timeline-filename``, one file a rank) and, with ``HOROVOD_MONITOR=1``,
installs the ``MonitorAgent`` before the engine's first cycle, rank 0
serving ``/metrics``, ``/health`` and ``/snapshot`` at
``HOROVOD_MONITOR_PORT`` (a port it cannot bind only warns: telemetry is
best-effort, as in the JAX package).  The engine arms its tracer from
``HOROVOD_TRACE`` itself.  ``start_profile``/``profile_step`` trace the
card with ``torch.profiler`` into a Chrome trace, the counterpart of the
JAX package's ``jax.profiler`` trace.

Elastic membership (``HOROVOD_ELASTIC=1``, set by the elastic driver,
``elastic/driver.py``), as the JAX ``init()``/``shutdown()`` do it
(:96-98, 119-131, 321-370): ``init()`` first fetches the next generation's
assignment from the driver's rendezvous (``elastic/worker.py``
``elastic_bootstrap``, which sets the env read below), forms the world
with an explicit collective timeout, and seeds the controller with the
zero-RTT streak the last generation carried (``_elastic_carry``).
``shutdown()`` after a fault aborts every communicator of the generation
before it stops the engine (``worker.teardown_distributed``): a collective
kernel waiting for a dead peer keeps spinning on the card until its
communicator is aborted, and the engine's in-flight window waits on it.  A
clean LEAVE (ours, or a peer's) aborts the groups too; a whole world
ending together destroys them.  Either way every process group the
generation made (the global one, the subsets, the two-level groups) is
gone before the next ``init()``, process sets of the dead generation are
unregistered, and a mesh made in it refuses to run
(``parallel/mesh.py``).

A static world (launched without the elastic driver) is kept across
``shutdown()``, as the JAX package keeps its ``jax.distributed`` client
(``horovod_tpu/common/basics.py:109-110``, torn down only in an elastic
world, :357-371): ``shutdown()`` destroys the groups the generation made
beside the default one (the process sets', the two-level groups, every
mesh's) and keeps the default group and its store, and the next
``init()`` runs on them, with no second rendezvous at the same address.
The store orders each generation's control plane: rank 0 sets
``hvd/gen/<n>/coordinator`` once its coordinator listens, each host
agent's owner ``hvd/gen/<n>/agent/<host>`` once its agent does, and every
other rank waits for the key of the server it connects to, so that no
rank reaches a server of the last generation that is still closing.  A
world of another size or rank than the env gives is refused.  After a
peer fault the world's communicators are aborted and the world cannot
form again at its address: the next ``init()`` raises (the elastic
driver re-forms worlds).  At interpreter exit a process that formed a
kept world destroys it, once no generation is live.

The two-level control plane (``HOROVOD_HIERARCHICAL_CONTROLLER=1``), as
the JAX ``init()``/``shutdown()`` run it (:163-230, 342-353): every
rank's negotiation client connects to its host's ``HostAgent``
(``common/host_agent.py``), which the local_rank-0 process owns, and the
agent presents the host to the root coordinator as one connection; rank 0
still binds the root server while its own client goes through host 0's
agent.  Without the launcher's local and cross env the plane is flat, with
a warning, as in the JAX package.  An agent that cannot bind its port
raises out of ``init()``.  In an elastic world the agent outlives its
generation: ``shutdown()`` only ends its generation, and the next
``init()`` re-forms its links through ``new_generation`` on the same
stable port (the rendezvous assignment's ``agent_port``).
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import datetime
import os
import threading
import warnings
from typing import Optional, Sequence

import torch

from .config import Config
from .process_sets import ProcessSet, ProcessSetTable, global_process_set
from .topology import Topology, build_topology


class NotInitializedError(RuntimeError):
    def __init__(self):
        super().__init__(
            "horovod_tpu_torch has not been initialized; call hvd.init() "
            "first.")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v.strip() else default


class GlobalState:
    def __init__(self):
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.device: Optional[torch.device] = None
        self.topology: Optional[Topology] = None
        self.owns_process_group = False
        self.config: Optional[Config] = None
        self.engine = None           # ops.engine.CollectiveEngine
        self.controller = None       # common.controller.TCPController
        self.timeline = None         # utils.timeline.Timeline
        self.monitor = None          # monitor.agent.MonitorAgent
        # common.host_agent.HostAgent of this host, owned by the
        # local_rank-0 process; kept across elastic generations.
        self.host_agent = None
        self.process_set_table = ProcessSetTable()
        # Counts init()s: what a mesh made in an earlier generation of an
        # elastic world checks against.
        self.generation = 0
        # The device init() was asked for (None: the card of the local
        # rank); an elastic reset asks the same.
        self.requested_device = None
        self._lock = threading.Lock()


_state = GlobalState()

# Zero-RTT streak carryover across elastic generations (the JAX package's
# ``_elastic_carry``): the engagement hint a clean shutdown captures, which
# the next generation's controller starts from; a fault clears it.
_elastic_carry = {"spec_seed": 0}


class _StaticWorld:
    """The ``torch.distributed`` world of a static launch, kept across
    ``shutdown()``: whether this process formed it, the ``init()``s run on
    it (each generation's store keys carry the count), whether a peer
    fault ended it, and the groups the live generation made beside the
    default one, in the order every rank made them."""

    def __init__(self):
        self.owned = False
        self.generations = 0
        self.faulted = False
        self.groups: list = []
        self.exit_hook = False


_world = _StaticWorld()

# How long a rank waits for the server of its generation to listen: the
# controller's own connect budget (common/controller.py).
_SERVER_WAIT_S = 60.0
# How long a rank whose control link died waits for the peers' records of
# a clean leave before it takes the loss for a fault.
_LEAVE_WAIT_S = 5.0


def _new_generation_group(ranks):
    """``dist.new_group(ranks)``, kept with the generation's groups, which
    ``shutdown()`` destroys (a collective: every rank makes every group,
    those it is not in included, in one order)."""
    import torch.distributed as dist
    g = dist.new_group(list(ranks))
    if g is not None and g is not dist.GroupMember.NON_GROUP_MEMBER:
        _world.groups.append(g)
    return g


def _destroy_generation_group(g) -> None:
    """Destroy a group of the generation, once: a group that
    ``shutdown()``, a fault or an earlier call has already ended is
    left alone."""
    if any(x is g for x in _world.groups):
        _world.groups = [x for x in _world.groups if x is not g]
        import torch.distributed as dist
        dist.destroy_process_group(g)


def _destroy_kept_world() -> None:
    """At interpreter exit: destroy the kept world this process formed,
    unless a generation is still live."""
    if _world.owned and not _state.initialized:
        _world.owned = False
        from ..elastic.worker import teardown_distributed
        teardown_distributed()


def _default_store():
    from torch.distributed import distributed_c10d as c10d
    return c10d._get_default_store()


def _announce(key: str) -> None:
    """Tell the world's other ranks that this generation's server named by
    ``key`` listens."""
    _default_store().set(f"hvd/gen/{_world.generations}/{key}", "1")


def _await(key: str, what: str) -> None:
    """Wait until this generation's server named by ``key`` listens."""
    full = f"hvd/gen/{_world.generations}/{key}"
    try:
        _default_store().wait(
            [full], datetime.timedelta(seconds=_SERVER_WAIT_S))
    except Exception as exc:  # noqa: BLE001 - the store's timeout types
        raise RuntimeError(
            f"horovod_tpu_torch.init(): {what} of generation "
            f"{_world.generations} did not listen within {_SERVER_WAIT_S:.0f}"
            f" s (store key {full}): {exc}") from exc


def _mark_left(rank: int) -> None:
    """Record in the kept world's store that ``rank`` shuts this
    generation down cleanly."""
    try:
        _announce(f"left/{rank}")
    except Exception as exc:  # noqa: BLE001 - shutdown must go on
        from ..utils.logging import get_logger
        get_logger().warning("shutdown: could not record a clean leave in "
                             "the world's store: %s", exc)


def _fault_is_a_clean_departure(st: GlobalState, fault) -> bool:
    """Whether a control-plane fault in a static world is only a peer's
    clean shutdown: the ranks it names dead, or else the ranks this rank's
    control link runs through (rank 0's coordinator, and under the
    two-level plane this host's agent owner), all recorded a clean leave
    in this generation (``_mark_left``), or do within ``_LEAVE_WAIT_S``.
    Their collectives all completed before they left, so the world's
    communicators are sound.  A peer that died records nothing, and rank
    0's death takes the store with it."""
    dead = set(getattr(fault, "dead_ranks", None) or ())
    links = {0}
    if st.config is not None and st.config.hierarchical_controller:
        links.add(st.rank - st.local_rank)
    suspects = (dead or links) - {st.rank}
    if not suspects:
        return False
    prefix = f"hvd/gen/{_world.generations}/left/"
    try:
        # A peer that leaves cleanly records it before its link can die,
        # but this rank may read the store before the record lands.
        _default_store().wait([prefix + str(r) for r in sorted(suspects)],
                              datetime.timedelta(seconds=_LEAVE_WAIT_S))
        return True
    except Exception:  # noqa: BLE001 - no record in time, or no store
        return False


def _env_has_rendezvous() -> bool:
    return bool(os.environ.get("HOROVOD_RENDEZVOUS_ADDR"))


def _get_state() -> GlobalState:
    return _state


def _libcuda():
    try:
        return ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None


def _cuda_driver_initialized() -> bool:
    """Whether this process has initialised the CUDA driver (``cuInit``);
    False without a driver."""
    lib = _libcuda()
    if lib is None:
        return False
    count = ctypes.c_int()
    # CUDA_ERROR_NOT_INITIALIZED (3) until cuInit.
    return lib.cuDeviceGetCount(ctypes.byref(count)) != 3


def cuda_module_loading() -> Optional[str]:
    """The CUDA driver's module loading mode in this process, ``"EAGER"``
    or ``"LAZY"``; None without a driver or before its initialisation."""
    lib = _libcuda()
    if lib is None:
        return None
    mode = ctypes.c_int()
    if lib.cuModuleGetLoadingMode(ctypes.byref(mode)) != 0:
        return None
    return {1: "EAGER", 2: "LAZY"}.get(mode.value)


def _ask_eager_module_loading(size: int, device) -> None:
    """Ask for eager module loading before this process initialises the
    CUDA driver, where it will run collectives on a card and the user has
    not chosen a mode."""
    if size <= 1 or (device is not None
                     and torch.device(device).type != "cuda"):
        return
    if "CUDA_MODULE_LOADING" not in os.environ \
            and not _cuda_driver_initialized():
        os.environ["CUDA_MODULE_LOADING"] = "EAGER"


def _resolve_device(device, local_rank: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch.init(): no CUDA device is available; pass "
            "device='cpu' to run on the CPU explicitly")
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(
            f"horovod_tpu_torch.init(): local rank {local_rank} has no card: "
            f"this host has {count} CUDA device(s) visible; launch at most "
            f"{count} rank(s) a host (-H host:{count}), or give each rank "
            f"its own host entry with NCCL_HOSTID where ranks share a card")
    return torch.device(f"cuda:{local_rank}")


def init(process_sets: Optional[Sequence[ProcessSet]] = None,
         device=None) -> None:
    """Initialize the runtime.  Idempotent, like ``hvd.init()``."""
    st = _state
    with st._lock:
        if st.initialized:
            return
        # Elastic workers fetch rank, size and the controller's ports from
        # the driver's versioned rendezvous: the bootstrap writes them
        # into the env read below, and returns the config with this
        # rank's output file names.
        boot = None
        elastic = Config.from_env().elastic
        if elastic and _env_has_rendezvous():
            from ..elastic.worker import elastic_bootstrap
            boot = elastic_bootstrap()
        size = _env_int("HOROVOD_SIZE", 1)
        rank = _env_int("HOROVOD_RANK", 0)
        local_rank = _env_int("HOROVOD_LOCAL_RANK", 0)
        local_size = _env_int("HOROVOD_LOCAL_SIZE", size)
        _ask_eager_module_loading(size, device)
        dev = _resolve_device(device, local_rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            if size > 1 and cuda_module_loading() == "LAZY":
                warnings.warn(
                    "horovod_tpu_torch.init(): this process loads CUDA "
                    "kernels lazily (the driver was initialised before "
                    "init(), or CUDA_MODULE_LOADING says so); a kernel's "
                    "first launch beside a collective waiting for a peer "
                    "can deadlock the ranks.  Start the process with "
                    "CUDA_MODULE_LOADING=EAGER, as the port's launcher "
                    "does.", RuntimeWarning, stacklevel=2)
        st.requested_device = device
        st.owns_process_group = False
        if size > 1:
            import torch.distributed as dist
            if not elastic and _world.faulted and not dist.is_initialized():
                raise RuntimeError(
                    "horovod_tpu_torch.init(): a peer fault ended this "
                    "static world and aborted its communicators; a static "
                    "world cannot form again at its address after a peer "
                    "fault.  Restart the job, or run it under the elastic "
                    "driver (python -m horovod_tpu_torch.runner with "
                    "--min-np/--host-discovery-script), which re-forms "
                    "worlds")
            if dist.is_initialized():
                # The world kept from an earlier generation (or one the
                # caller formed): it must be the one the env describes.
                if (dist.get_world_size(), dist.get_rank()) != (size, rank):
                    raise RuntimeError(
                        f"horovod_tpu_torch.init(): the env gives rank "
                        f"{rank} of {size}, but this process is already "
                        f"rank {dist.get_rank()} of a world of "
                        f"{dist.get_world_size()}; a static world keeps its "
                        f"size and ranks across shutdown()")
                st.owns_process_group = _world.owned and not elastic
            else:
                addr = os.environ.get("HOROVOD_CONTROLLER_ADDR", "")
                port = os.environ.get("HOROVOD_CONTROLLER_PORT", "")
                if not addr or not port:
                    raise RuntimeError(
                        f"HOROVOD_SIZE={size} needs HOROVOD_CONTROLLER_ADDR "
                        f"and HOROVOD_CONTROLLER_PORT to form the world")
                backend = "nccl" if dev.type == "cuda" else "gloo"
                if boot is not None:
                    from ..elastic.worker import init_distributed_resilient
                    init_distributed_resilient(backend, addr, port, size,
                                               rank)
                else:
                    dist.init_process_group(
                        backend=backend, init_method=f"tcp://{addr}:{port}",
                        world_size=size, rank=rank)
                st.owns_process_group = True
                if not elastic:
                    _world.owned, _world.generations = True, 0
                    if not _world.exit_hook:
                        atexit.register(_destroy_kept_world)
                        _world.exit_hook = True
            if not elastic:
                _world.generations += 1
        st.rank, st.size = rank, size
        st.local_rank, st.local_size = local_rank, local_size
        st.device = dev
        st.topology = build_topology(size, rank)
        gs = st.process_set_table.initialize(size, _make_group,
                                             extra_sets=process_sets)
        # Rebind the module-level global_process_set singleton.
        global_process_set.__dict__.update(gs.__dict__)
        st.process_set_table._sets[0] = global_process_set
        cfg = st.config = boot if boot is not None else Config.from_env()
        from ..utils.timeline import Timeline
        st.timeline = Timeline(cfg.timeline_filename,
                               mark_cycles=cfg.timeline_mark_cycles)
        # Wire-visible auto-name counters restart with the runtime, so that
        # every rank's name sequence stays aligned.
        from ..ops import eager as _eager
        _eager.reset_name_counters()
        from ..ops.engine import CollectiveEngine
        st.engine = CollectiveEngine(st)
        st.engine._make_hier_groups()
        if size > 1:
            from .controller import TCPController
            if not cfg.controller_addr or not cfg.controller_port:
                raise RuntimeError(
                    f"HOROVOD_SIZE={size} needs HOROVOD_CONTROLLER_ADDR "
                    f"and HOROVOD_CONTROLLER_PORT for the negotiation "
                    f"controller")
            ctrl_port = cfg.controller_port2 or cfg.controller_port + 1
            connect_addr, connect_port = cfg.controller_addr, ctrl_port
            server_port = None
            # In a kept world the last generation's servers may still be
            # closing: connect only to this generation's.
            ordered = not cfg.elastic
            if ordered and rank != 0:
                _await("coordinator", "the coordinator (rank 0)")
            if cfg.hierarchical_controller:
                agent_at = _host_agent_for(st, cfg, rank, size, local_rank,
                                           local_size, ctrl_port)
                if agent_at is not None:
                    connect_addr, connect_port = "127.0.0.1", agent_at
                    if rank == 0:
                        server_port = ctrl_port
                    host = cfg.cross_rank_env
                    if ordered and local_rank == 0:
                        _announce(f"agent/{host}")
                    elif ordered:
                        _await(f"agent/{host}", f"host {host}'s agent")
            carry = _elastic_carry["spec_seed"] if cfg.elastic else 0
            st.controller = TCPController(
                connect_addr, connect_port,
                rank=rank, world=size, server_port=server_port,
                stall_warn_s=cfg.stall_check_time_s
                if not cfg.stall_check_disable else 1e18,
                cache_capacity=cfg.response_cache_capacity,
                round_timeout_s=cfg.round_timeout_s,
                connect_retries=cfg.connect_retries,
                connect_backoff_ms=cfg.connect_backoff_ms,
                spec_ready_after=cfg.spec_ready_after,
                round_pipeline=cfg.round_pipeline,
                spec_seed=carry, spec_streak_hint=carry)
            if ordered and rank == 0:
                _announce("coordinator")
            st.engine.controller = st.controller
        if cfg.monitor:
            # Installed before engine.start() so that the very first cycle
            # is observed.
            from ..monitor.agent import MonitorAgent
            st.monitor = MonitorAgent(
                engine=st.engine, controller=st.controller, rank=rank,
                world=size, interval_s=cfg.monitor_interval_s,
                timeline=st.timeline)
            if cfg.monitor_port > 0 and rank == 0:
                try:
                    st.monitor.serve_http(cfg.monitor_port)
                except OSError as exc:
                    # A taken port must not kill training: the telemetry
                    # plane is best-effort.
                    from ..utils.logging import get_logger
                    get_logger().warning(
                        "monitor: could not bind HTTP port %d (%s); "
                        "exporter disabled", cfg.monitor_port, exc)
        st.engine.start()
        st.generation += 1
        st.initialized = True


def _host_agent_for(st: GlobalState, cfg: Config, rank: int, size: int,
                    local_rank: int, local_size: int,
                    ctrl_port: int) -> Optional[int]:
    """Set up this host's agent for the two-level control plane and return
    the port this rank's client connects to; None (with a warning) when
    the launcher's local and cross env is missing, and the plane stays
    flat.  The local_rank-0 process owns the agent: in an elastic world
    the agent of the last generation serves the next through
    ``new_generation`` when it listens on the same port."""
    if ("HOROVOD_LOCAL_RANK" not in os.environ
            or "HOROVOD_LOCAL_SIZE" not in os.environ
            or cfg.cross_rank_env < 0):
        # Deriving a host layout from the defaults would give every process
        # local rank 0 on host 0, each binding its own agent on one port.
        from ..utils.logging import get_logger
        get_logger().warning(
            "HOROVOD_HIERARCHICAL_CONTROLLER=1 but HOROVOD_LOCAL_RANK/"
            "LOCAL_SIZE/CROSS_RANK are not set (launch through python -m "
            "horovod_tpu_torch.runner to get them); using the flat control "
            "plane")
        return None
    from .host_agent import HostAgent
    cross_rank = cfg.cross_rank_env
    agent_port = cfg.agent_port or ctrl_port + 1 + cross_rank
    if local_rank == 0:
        first = rank - local_rank
        ranks = list(range(first, min(size, first + local_size)))
        reused = False
        if (st.host_agent is not None and cfg.elastic
                and st.host_agent.port == agent_port):
            try:
                st.host_agent.new_generation(cfg.controller_addr, ctrl_port,
                                             ranks, host_index=cross_rank)
                reused = True
            except RuntimeError:
                # A wedged thread of the last generation: a fresh agent on
                # the same port (stop() closes the listener first).
                from ..utils.logging import get_logger
                get_logger().warning("host agent could not serve a new "
                                     "generation; replacing it")
        if not reused:
            if st.host_agent is not None:
                st.host_agent.stop()
            st.host_agent = HostAgent(agent_port, cfg.controller_addr,
                                      ctrl_port, ranks,
                                      host_index=cross_rank).start()
    return agent_port


def _make_group(ranks):
    """The process group of a set: none in a world of one process, the
    default group for the global set, a new group of the generation for a
    subset."""
    if _state.size == 1:
        return None
    import torch.distributed as dist
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return _new_generation_group(ranks)


def shutdown() -> None:
    """Stop the engine and the controller, then leave the world, in the
    JAX package's order (``horovod_tpu/common/basics.py:278-370``): quiesce
    the cycle thread at a round boundary, announce a clean LEAVE on the
    quiet socket, sever the socket, stop the engine (settling every
    waiter), close the controller, then tear the world down.  After a
    fault the world's communicators are aborted before the engine stops:
    its in-flight window waits on the card, where a collective of the dead
    generation spins until its communicator is aborted."""
    st = _state
    with st._lock:
        if not st.initialized:
            return
        eng, ctl = st.engine, st.controller
        # A control-plane fault (dead peer — HVD303) means no clean LEAVE.
        abrupt = eng is not None and eng.fault is not None
        # Peers that departed by a clean LEAVE: not a fault, but they will
        # take part in no teardown of the world.
        peers_left = bool(getattr(ctl, "left_ranks", None))
        leave_sent = False
        elastic = st.config is not None and st.config.elastic
        static = st.size > 1 and not elastic
        marked = False
        if ctl is not None and eng is not None and not abrupt:
            # A wedged thread (a peer already died) falls back to the sever
            # below; a healthy world's in-flight round completes first.
            if eng.quiesce(timeout=5.0) and eng.fault is None:
                if static:
                    # Before the LEAVE and before this rank's servers
                    # close: a peer whose link dies with them finds the
                    # record and keeps the world.
                    _mark_left(st.rank)
                    marked = True
                leave_sent = bool(ctl.leave())
            else:
                abrupt = eng.fault is not None
        if static:
            if not abrupt and not marked:
                _mark_left(st.rank)
            elif abrupt and _fault_is_a_clean_departure(st, eng.fault):
                abrupt = False
        if ctl is not None:
            # Unblock any lock-step round FIRST so the engine thread can't
            # be left inside the native client when we free it.
            ctl.interrupt()
        if st.owns_process_group and abrupt:
            from ..elastic.worker import teardown_distributed
            teardown_distributed(abrupt=True)
            if not elastic:
                _world.owned, _world.faulted = False, True
        if eng is not None:
            eng.stop()
            st.engine = None
        if st.monitor is not None:
            st.monitor.close()
            st.monitor = None
        if ctl is not None:
            if elastic:
                # The zero-RTT hint the next generation starts from; a
                # faulted generation carries nothing.
                try:
                    _elastic_carry["spec_seed"] = (
                        0 if abrupt else ctl.spec_carry_hint())
                except Exception:  # noqa: BLE001 - telemetry only
                    _elastic_carry["spec_seed"] = 0
            ctl.shutdown()
            st.controller = None
        if st.host_agent is not None:
            # After the controller: the agent outlives this process's own
            # client socket, so that its teardown EOF is observed and
            # reported upstream.  An elastic world only ends the
            # generation: the agent and its port serve the next one.
            if elastic:
                st.host_agent.end_generation()
            else:
                st.host_agent.stop()
                st.host_agent = None
        if st.timeline is not None:
            st.timeline.close()
            st.timeline = None
        if elastic and st.owns_process_group and not abrupt:
            from ..elastic.worker import teardown_distributed
            # In an elastic world a clean LEAVE, ours or a peer's, leaves
            # ranks that take no part in a destroy: abort, as after a
            # fault.  A world ending together destroys its groups.
            teardown_distributed(abrupt=leave_sent or peers_left)
        if abrupt or (elastic and st.owns_process_group):
            # Ended with the world, or not to be touched after a fault.
            _world.groups = []
        else:
            # A static world is kept; the generation's own groups go.
            for g in list(_world.groups):
                _destroy_generation_group(g)
        st.owns_process_group = False
        # Sets of this generation name groups that are gone: unregister
        # them, so that a later call with one raises instead of running on
        # a dead group (the global set is rebound at init()).
        for ps in st.process_set_table.all_sets():
            if ps.process_set_id not in (None, 0):
                ps.process_set_id = None
                ps.group = None
        st.process_set_table = ProcessSetTable()
        st.device = None
        st.topology = None
        st.initialized = False


def is_initialized() -> bool:
    return _state.initialized


def _checked() -> GlobalState:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def size() -> int:
    """Global number of ranks (one process per card)."""
    return _checked().size


def rank() -> int:
    return _checked().rank


def local_size() -> int:
    return _checked().local_size


def local_rank() -> int:
    return _checked().local_rank


def device() -> torch.device:
    """The device this process computes on (``cuda:{local_rank}`` unless
    ``init(device=...)`` said otherwise)."""
    return _checked().device


def add_process_set(ps_or_ranks) -> ProcessSet:
    st = _checked()
    ps = (ps_or_ranks if isinstance(ps_or_ranks, ProcessSet)
          else ProcessSet(ps_or_ranks))
    return st.process_set_table.add(ps, st.size, _make_group)


def remove_process_set(ps: ProcessSet):
    _checked().process_set_table.remove(ps)


def process_set_included(ps: ProcessSet) -> bool:
    return ps.included(rank())


def cross_size() -> int:
    """The number of hosts: the launcher's ``HOROVOD_CROSS_SIZE``, else the
    hosts of ``HOROVOD_LOCAL_COUNTS``, else one host a rank."""
    st = _checked()
    env = st.config.cross_size_env
    if env > 0:
        return env
    counts = st.topology.local_counts
    return len(counts) if counts is not None else st.size


def cross_rank() -> int:
    """This rank's host index: the launcher's ``HOROVOD_CROSS_RANK``, else
    its host in ``HOROVOD_LOCAL_COUNTS``, else its rank."""
    st = _checked()
    env = st.config.cross_rank_env
    if env >= 0:
        return env
    t = st.topology
    return t.my_host if t.local_counts is not None else st.rank


def is_homogeneous() -> bool:
    """Whether every host runs the same number of ranks (True when the
    launcher gave no layout: one rank a host)."""
    counts = _checked().topology.local_counts
    return counts is None or all(c == counts[0] for c in counts)


# Capability probes, for API parity with HorovodBasics (reference
# horovod/common/basics.py): the answers of this torch build.
def nccl_built() -> bool:
    import torch.distributed as dist
    return bool(dist.is_available() and dist.is_nccl_available())


def gloo_enabled() -> bool:
    import torch.distributed as dist
    return bool(dist.is_available() and dist.is_gloo_available())


def mpi_enabled() -> bool:
    import torch.distributed as dist
    return bool(dist.is_available() and dist.is_mpi_available())


def mpi_threads_supported() -> bool:
    return False


def cuda_built() -> bool:
    return bool(torch.backends.cuda.is_built())


def rocm_built() -> bool:
    return torch.version.hip is not None


def start_timeline(filename: str, mark_cycles: bool = False):
    """Begin writing a Chrome-trace timeline (reference: timeline.cc N10),
    replacing the current one."""
    st = _checked()
    from ..utils.timeline import Timeline
    if st.timeline is not None:
        st.timeline.close()
    st.timeline = Timeline(filename, mark_cycles=mark_cycles)


def stop_timeline():
    """Close the timeline; the engine goes on with a disabled one."""
    st = _checked()
    if st.timeline is not None:
        st.timeline.close()
    from ..utils.timeline import Timeline
    st.timeline = Timeline("", mark_cycles=False)


_profiler = None


def start_profile(logdir: str):
    """Start a device-level profiler trace: ``torch.profiler`` over the
    host and the card (the port's kernels, NCCL's and the library's by
    name), written as a Chrome trace into ``logdir`` by
    :func:`stop_profile`.  The coordinator's timeline (``start_timeline``)
    covers each tensor's negotiation and collective phases; this is the
    complementary device view.  One trace at a time."""
    global _profiler
    if _profiler is not None:
        raise RuntimeError("a profile is already running; stop_profile() "
                           "first")
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    _profiler = (prof, logdir)


def stop_profile():
    """Stop the trace started by :func:`start_profile` and write it to
    ``<logdir>/trace.<pid>.json``; returns the file's path."""
    global _profiler
    if _profiler is None:
        raise RuntimeError("no profile is running; start_profile() first")
    prof, logdir = _profiler
    _profiler = None
    prof.__exit__(None, None, None)
    path = os.path.join(logdir, f"trace.{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profile_step(logdir: str):
    """Context manager profiling one region (e.g. a train step)::

        with hvd.profile_step("/tmp/prof"):
            loss = train_step(...)
    """
    start_profile(logdir)
    try:
        yield
    finally:
        stop_profile()
