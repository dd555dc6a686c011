# Ported from horovod_tpu/elastic/worker.py: _current_version, _manager,
# _mark_draining, identity, WorkerNotificationService/Manager,
# attach_notification_manager and elastic_bootstrap (:52-281) are copied;
# init_distributed_resilient (:283-318) and teardown_distributed (:409-456)
# become the torch.distributed world's formation and teardown, without the
# parking and the exit guard (:27-50, 321-407) that a JAX world needs.
"""Worker-side elastic machinery: notification listener, re-rendezvous
bootstrap, and the world's formation and teardown.

Parity: reference ``horovod/runner/elastic/worker.py``
(``WorkerNotificationService``/``WorkerNotificationManager``) and the worker
half of §3.4's control flow: the driver pings registered workers on host
changes; ``state.commit()``/``check_host_updates()`` turns the ping into a
``HostsUpdatedInterrupt``; on reset the worker long-polls the rendezvous for
a strictly newer generation and re-forms the ``torch.distributed`` world.

A JAX world cannot be torn down once a peer died (its coordination
service's barrier never completes, and its heartbeat handlers abort the
process), so the JAX package parks it and guards the interpreter's exit.
A ``torch.distributed`` world can: ``teardown_distributed(abrupt=True)``
aborts every communicator of the generation
(``distributed_c10d._abort_process_group``), which ends a collective kernel
still waiting on the card for the dead peer and frees NCCL's buffers, and
clears every group, the global one, the subsets and the two-level groups
alike.  Nothing of the dead generation stays, so nothing needs parking and
the interpreter exits as usual.

The elastic world is formed with an explicit collective timeout
(``COLLECTIVE_TIMEOUT_S``, 300 s; gloo's own is 30 minutes) and with ``TORCH_NCCL_ASYNC_ERROR_HANDLING=2`` unless the user
chose otherwise: on an error or a timeout ProcessGroupNCCL's watchdog then
aborts the communicators and keeps the process (torch's default, 3, ends
the process: the survivors elastic recovery exists to save).  The dead
peer itself is found by the coordinator's control plane in milliseconds
(``PeerFailureError``), which is what the run wrapper recovers from.
"""

from __future__ import annotations

import datetime
import os
import socket
import threading
from typing import Optional

from . import rendezvous as rdv
from ..common.exceptions import DrainRequested, HostsUpdatedInterrupt
from ..utils.logging import get_logger

log = get_logger()

# ProcessGroupNCCL's error handling in elastic worlds: 2 (CleanUpOnly)
# aborts the communicators on an error or timeout and keeps the process.
NCCL_ERROR_HANDLING = "2"
COLLECTIVE_TIMEOUT_S = 300.0

# The generation this process is currently participating in; bootstrap
# requests strictly newer on re-init so a stale assignment can't be rejoined.
_current_version: Optional[int] = None
_manager: Optional["WorkerNotificationManager"] = None


def _mark_draining() -> None:
    """Flip this rank's monitor readiness to NotReady the moment a driver
    DRAIN ping lands (ISSUE 19: readiness split from liveness).

    The drain itself is consumed later — at the next ``state.commit()``
    via ``raise_if_updated()`` — but the load balancer must stop routing
    NEW requests to a cordoned replica immediately, not at the next
    commit boundary.  Lazy import + best-effort: worker.py stays
    importable jax-free, and a fleet without the monitor (or before
    ``init()``) simply has no readiness surface to flip."""
    try:
        from ..common import basics
        agent = basics._get_state().monitor
        if agent is not None:
            agent.set_ready(False, "draining: driver cordon ping received")
    except Exception:  # noqa: BLE001 - telemetry must never block a drain
        pass


def identity() -> str:
    host = os.environ.get("HOROVOD_HOSTNAME", socket.gethostname())
    local_rank = os.environ.get("HOROVOD_LOCAL_RANK", "0")
    return f"{host}:{local_rank}"


class WorkerNotificationService:
    """Tiny TCP listener; driver sends ``HOSTS_UPDATED <version>\\n``,
    the autoscaler's drain path ``DRAIN\\n``, or — checkpoint pacing
    (ISSUE 12) — ``COMMIT\\n``, the driver's request that the worker
    commit its elastic state NOW because a scale/preemption decision is
    imminent (committing on the timer would race the world change)."""

    def __init__(self, on_hosts_updated, on_drain=None, on_commit=None):
        self._on_hosts_updated = on_hosts_updated
        self._on_drain = on_drain
        self._on_commit = on_commit
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(8)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _serve(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                # A wedged/half-open driver connection must not block the
                # accept loop forever (timeouts surface as OSError below).
                conn.settimeout(5.0)
                data = conn.makefile().readline().strip()
                if data.startswith("HOSTS_UPDATED"):
                    version = int(data.split()[1]) if " " in data else 0
                    self._on_hosts_updated(version)
                elif data.startswith("DRAIN") and self._on_drain is not None:
                    self._on_drain()
                elif data.startswith("COMMIT") and \
                        self._on_commit is not None:
                    self._on_commit()
                    # Receipt ack (ISSUE 14 bugfix): the driver records
                    # WHICH workers took the paced-commit request and the
                    # preempt drain waits (grace-bounded) for these acks
                    # before cordoning — a drain can no longer race a
                    # commit ping that never arrived.  Old drivers close
                    # without reading; the failed send is harmless.
                    try:
                        conn.sendall(b"ACK\n")
                    except OSError:
                        pass
            except (OSError, ValueError):
                pass
            finally:
                # Close on EVERY path: timed-out connections would otherwise
                # leak an fd each until accept() itself fails with EMFILE.
                try:
                    conn.close()
                except OSError:
                    pass

    def stop(self):
        try:
            self._sock.close()
        except OSError:
            pass


class WorkerNotificationManager:
    """Registered on elastic ``State`` objects as ``_notification_manager``;
    ``State.commit()`` calls ``raise_if_updated()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending_version: Optional[int] = None
        self._drain_pending = False
        self._commit_pending = False
        self._service = WorkerNotificationService(
            self._notify, on_drain=self._notify_drain,
            on_commit=self._notify_commit)
        addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR")
        port = os.environ.get("HOROVOD_RENDEZVOUS_PORT")
        if addr and port:
            rdv.register_notification_port(addr, int(port), identity(),
                                           self._service.port)

    def _notify(self, version: int):
        with self._lock:
            self._pending_version = version

    def _notify_drain(self):
        with self._lock:
            self._drain_pending = True
        _mark_draining()

    def _notify_commit(self):
        with self._lock:
            self._commit_pending = True

    def consume_commit_request(self) -> bool:
        """True exactly once per driver ``COMMIT`` ping (checkpoint
        pacing, ISSUE 12): the driver is about to execute a scale or
        preemption decision and wants the elastic state committed NOW,
        not at the next timer tick.  Train loops with a periodic commit
        cadence consult ``state.should_commit()`` (which reads this)
        alongside their own schedule."""
        with self._lock:
            pending = self._commit_pending
            self._commit_pending = False
            return pending

    def raise_if_updated(self):
        with self._lock:
            drain = self._drain_pending
            v = self._pending_version
            if drain:
                # Drain outranks a host update: this worker is LEAVING —
                # re-rendezvousing into the next generation first would
                # just delay the departure the driver is waiting on.
                self._drain_pending = False
                self._pending_version = None
            elif v is None:
                return
            # A late ping for the generation we already joined is not news.
            elif _current_version is not None and v <= _current_version:
                self._pending_version = None
                return
            else:
                self._pending_version = None
        if drain:
            raise DrainRequested()
        raise HostsUpdatedInterrupt()


def attach_notification_manager(state):
    """Idempotently give ``state`` the process-wide notification manager."""
    global _manager
    if _manager is None:
        _manager = WorkerNotificationManager()
    state._notification_manager = _manager
    return _manager


def elastic_bootstrap():
    """Fetch this worker's assignment for the next generation and project it
    into the environment; returns the re-parsed Config.

    Called from ``basics.init()`` when ``HOROVOD_ELASTIC=1``.
    """
    global _current_version
    from ..common.config import Config

    addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR")
    port = os.environ.get("HOROVOD_RENDEZVOUS_PORT")
    if not addr or not port:
        raise RuntimeError(
            "HOROVOD_ELASTIC=1 but HOROVOD_RENDEZVOUS_ADDR/PORT are not set "
            "(elastic workers must be launched by torovodrun "
            "--host-discovery-script)")
    min_version = 0 if _current_version is None else _current_version + 1
    timeout = float(os.environ.get("HOROVOD_ELASTIC_TIMEOUT", "600"))
    a = rdv.fetch_assignment(addr, int(port), identity(),
                             min_version=min_version, timeout_s=timeout)
    _current_version = int(a["version"])
    log.info("elastic: joined generation %s as rank %s/%s",
             a["version"], a["rank"], a["size"])
    env = {
        "HOROVOD_RANK": str(a["rank"]),
        "HOROVOD_SIZE": str(a["size"]),
        "HOROVOD_LOCAL_RANK": str(a["local_rank"]),
        "HOROVOD_LOCAL_SIZE": str(a["local_size"]),
        "HOROVOD_CROSS_RANK": str(a["cross_rank"]),
        "HOROVOD_CROSS_SIZE": str(a["cross_size"]),
        "HOROVOD_CONTROLLER_ADDR": str(a["controller_addr"]),
        "HOROVOD_CONTROLLER_PORT": str(a["controller_port"]),
        "HOROVOD_CONTROLLER_PORT2": str(a["controller_port2"]),
    }
    # Hierarchical control plane × elastic (ISSUE 12): the driver
    # allocates ONE stable agent port per host and ships it with every
    # generation's assignment, so the generation-surviving HostAgent keeps
    # its listen socket across re-rendezvous.
    if a.get("agent_port"):
        env["HOROVOD_AGENT_PORT"] = str(a["agent_port"])
    os.environ.update(env)
    cfg = Config.from_env()
    # Per-rank output suffixing, unified with the static launch paths
    # (utils.timeline.per_rank_filename): the env carries the BASE name
    # (the driver can't know ranks before assignment, and re-suffixing an
    # already-suffixed env value across generations would compound), so
    # the assigned rank is applied to the parsed config only.
    from ..utils.timeline import per_rank_filename
    if cfg.timeline_filename:
        cfg.timeline_filename = per_rank_filename(cfg.timeline_filename,
                                                  a["rank"])
    if cfg.trace_filename:
        cfg.trace_filename = per_rank_filename(cfg.trace_filename,
                                               a["rank"])
    return cfg


def init_distributed_resilient(backend: str, addr: str, port,
                               world_size: int, rank: int) -> None:
    """Form the ``torch.distributed`` world of an ELASTIC generation: an
    explicit collective timeout, and ProcessGroupNCCL's error handling
    set to abort the communicators and keep the process (it is read when
    the group is made)."""
    import torch.distributed as dist
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING",
                          NCCL_ERROR_HANDLING)
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{addr}:{port}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=COLLECTIVE_TIMEOUT_S))


def teardown_distributed(abrupt: bool = False) -> None:
    """Tear the generation's world down so that ``init()`` can form the
    next one at another size.

    ``abrupt=True`` (a peer died, or left by a clean LEAVE and will take
    part in no teardown): abort every group's communicators, locally and
    at once — a collective of the dead generation still spinning on the
    card ends, and NCCL's buffers are freed — and forget every group.
    Otherwise the whole world ends together and ``destroy_process_group``
    destroys every group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return
    if abrupt:
        from torch.distributed import distributed_c10d as c10d
        try:
            c10d._abort_process_group()
            log.warning("elastic: aborted the generation's communicators")
            return
        except Exception as exc:  # noqa: BLE001 - fall back to destroy
            log.warning("elastic: aborting the process groups failed "
                        "(%s); destroying them", exc)
    try:
        dist.destroy_process_group()
    except Exception as exc:  # noqa: BLE001 - peers may already be gone
        log.warning("elastic: destroy_process_group failed: %s", exc)
