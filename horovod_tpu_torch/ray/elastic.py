# Ported from horovod_tpu/ray/elastic.py:1-225: RayHostDiscovery and the
# Ray elastic driver over the port's HostDiscovery and ElasticDriver; an
# actor gets the card's env of the port's elastic worker beside HOROVOD_*.
"""Elastic Ray executor (reference: ``horovod/ray/elastic_v2.py`` —
SURVEY.md §2b P12, VERDICT missing #7).

Bridges the port's elastic machinery (``horovod_tpu_torch/elastic/
driver.py``) to Ray actor lifecycles:

- **Discovery** = the Ray cluster's live node set (:class:`RayHostDiscovery`
  polls ``ray.nodes()``), so autoscaler node add/remove becomes host
  add/remove exactly like the reference's discovery-script polling;
- **Workers** = Ray actors instead of ssh-spawned processes: the driver's
  spawn hook creates an actor pinned to the assigned node and wraps the
  (actor, running ObjectRef) pair in a Popen-shaped adapter, so the
  driver's liveness/blacklist/regeneration loop works unchanged — a killed
  actor reads as a failed process, the node is blacklisted, and the world
  re-forms at reduced size;
- Workers long-poll the driver's versioned rendezvous for assignments, the
  same protocol the process-based elastic path uses.

Without Ray the executor degrades to a clear ImportError from
:func:`_require_ray`, and every Ray API touch goes through an injectable
handle so the orchestration is testable with fakes (the reference tests
elastic_v2 the same way — mock clusters).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

from .runner import _require_ray
from ..elastic.discovery import DiscoveredHost, HostDiscovery
from ..elastic.driver import ElasticDriver
from ..runner.run import HostSpec, platform_worker_env
from ..utils.logging import get_logger

log = get_logger()


class RayHostDiscovery(HostDiscovery):
    """Live Ray nodes → discovered hosts (reference:
    ``elastic_v2.RayHostDiscovery``).

    Slots per node: the accelerator count when ``use_accelerators`` (a
    TPU count first, as the JAX package reads it, then GPU), else
    ``CPU // cpus_per_worker``.
    """

    def __init__(self, use_accelerators: bool = True,
                 cpus_per_worker: int = 1, ray_api=None):
        self.use_accelerators = use_accelerators
        self.cpus_per_worker = max(1, cpus_per_worker)
        self._ray = ray_api

    def find_available_hosts_and_slots(self) -> List[DiscoveredHost]:
        ray = self._ray or _require_ray()
        hosts: List[DiscoveredHost] = []
        for n in ray.nodes():
            if not n.get("Alive"):
                continue
            res = n.get("Resources", {})
            slots = 0
            if self.use_accelerators:
                slots = int(res.get("TPU", res.get("GPU", 0)))
            if slots == 0:
                slots = int(res.get("CPU", 0)) // self.cpus_per_worker
            if slots > 0:
                hosts.append(DiscoveredHost(n["NodeManagerAddress"], slots))
        return hosts


class _ActorProc:
    """Popen-shaped adapter over a (Ray actor, running ObjectRef) pair so
    the elastic driver's reap/terminate loop treats actors as workers."""

    def __init__(self, ray_api, actor, ref):
        self._ray = ray_api
        self._actor = actor
        self._ref = ref
        self.returncode: Optional[int] = None
        self.pid = f"actor:{id(actor):x}"

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        done, _ = self._ray.wait([self._ref], timeout=0)
        if not done:
            return None
        try:
            self.result = self._ray.get(done[0])
            self.returncode = 0
        except Exception as exc:  # noqa: BLE001 - actor death / user error
            log.warning("ray elastic: worker actor failed: %s", exc)
            self.returncode = 1
        return self.returncode

    def terminate(self):
        try:
            self._ray.kill(self._actor)
        except Exception:  # noqa: BLE001 - already dead
            pass
        if self.returncode is None:
            self.returncode = -15

    kill = terminate


class _RayElasticDriver(ElasticDriver):
    """ElasticDriver whose spawn creates Ray actors instead of processes.

    Actors run ``train_fn`` as a one-shot closure with env baked at spawn,
    so they cannot re-rank in place when the world changes the way the
    process path's rendezvous long-poll allows — every generation therefore
    kills and respawns the full actor set (``respawn_on_generation``) with
    the complete world assignment in the environment.
    """

    respawn_on_generation = True

    def __init__(self, *args, executor: "ElasticRayExecutor", **kwargs):
        super().__init__(*args, **kwargs)
        self._executor = executor

    def _spawn(self, identity: str, assignment: dict):
        env = self._worker_env(identity, assignment["hostname"],
                               assignment["local_rank"])
        # One-shot actors see their whole world statically (no rendezvous
        # long-poll), so the full assignment rides the environment.
        env.update({
            "HOROVOD_RANK": str(assignment["rank"]),
            "HOROVOD_SIZE": str(assignment["size"]),
            "HOROVOD_LOCAL_SIZE": str(assignment["local_size"]),
            "HOROVOD_CROSS_RANK": str(assignment["cross_rank"]),
            "HOROVOD_CROSS_SIZE": str(assignment["cross_size"]),
            "HOROVOD_CONTROLLER_ADDR": assignment["controller_addr"],
            "HOROVOD_CONTROLLER_PORT": str(assignment["controller_port"]),
            "HOROVOD_CONTROLLER_PORT2": str(
                assignment["controller_port2"]),
        })
        # HOROVOD_* and the card's variables of an elastic worker (eager
        # module loading, NCCL's host id, its error handling), not the
        # driver's whole environment.
        card = platform_worker_env([HostSpec(assignment["hostname"], 1)], 0,
                                   env, elastic=True)
        hvd_env = {k: v for k, v in env.items()
                   if k.startswith("HOROVOD_") or k in card}
        proc = self._executor._make_actor(assignment["hostname"], hvd_env)
        self._procs[identity] = proc
        self.registry.record_ready(identity)
        if self.verbose:
            log.warning("ray elastic: spawned %s (%s)", identity, proc.pid)


class ElasticRayExecutor:
    """Reference-compatible elastic executor facade::

        executor = ElasticRayExecutor(min_workers=2, max_workers=8)
        executor.start()
        rc = executor.run(train_fn)     # train_fn uses @hvd.elastic.run

    ``train_fn`` runs inside each worker actor with the elastic HOROVOD_*
    environment set; host changes flow through the standard rendezvous /
    notification path.
    """

    def __init__(self, min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 use_accelerators: bool = True, cpus_per_worker: int = 1,
                 env_vars: Optional[Dict[str, str]] = None,
                 override_discovery: Optional[HostDiscovery] = None,
                 discovery_interval_s: float = 1.0,
                 start_timeout_s: float = 600.0, verbose: int = 0,
                 _ray_api=None):
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.use_accelerators = use_accelerators
        self.cpus_per_worker = cpus_per_worker
        self.env_vars = dict(env_vars or {})
        self.discovery = override_discovery or RayHostDiscovery(
            use_accelerators, cpus_per_worker, ray_api=_ray_api)
        self.discovery_interval_s = discovery_interval_s
        self.start_timeout_s = start_timeout_s
        self.verbose = verbose
        self._ray = _ray_api
        self._train_fn: Optional[Callable] = None
        self.driver: Optional[_RayElasticDriver] = None

    def start(self):
        """Validate Ray is importable/initialized (actors spawn lazily per
        elastic generation inside :meth:`run`)."""
        ray = self._ray or _require_ray()
        if hasattr(ray, "is_initialized") and not ray.is_initialized():
            ray.init(address="auto")

    # ------------------------------------------------------------- actors
    def _make_actor(self, hostname: str, env: Dict[str, str]) -> _ActorProc:
        ray = self._ray or _require_ray()
        full_env = {**self.env_vars, **env}

        @ray.remote(num_cpus=self.cpus_per_worker,
                    max_restarts=0)
        class _ElasticWorker:
            def execute(self, env, fn):
                os.environ.update(env)
                return fn()

        # Soft node pinning via Ray's per-node resource: the assignment's
        # env (HOSTNAME/LOCAL_RANK) is only valid on that node.
        actor = _ElasticWorker.options(
            resources={f"node:{hostname}": 0.001}).remote()
        ref = actor.execute.remote(full_env, self._train_fn)
        return _ActorProc(ray, actor, ref)

    # ---------------------------------------------------------------- run
    def run(self, train_fn: Callable[[], Any]) -> int:
        """Run ``train_fn`` elastically; returns the driver's exit code
        (0 = some rank finished training successfully)."""
        self._train_fn = train_fn
        self.driver = _RayElasticDriver(
            discovery=self.discovery, command=[],
            min_np=self.min_workers, max_np=self.max_workers,
            env=self.env_vars,
            discovery_interval_s=self.discovery_interval_s,
            start_timeout_s=self.start_timeout_s,
            verbose=self.verbose, executor=self)
        try:
            return self.driver.run()
        finally:
            self.driver.rendezvous.stop()

    def shutdown(self):
        if self.driver is not None:
            self.driver._shutdown_workers()
