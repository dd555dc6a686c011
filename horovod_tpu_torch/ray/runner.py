# Ported from horovod_tpu/ray/runner.py:1-153: worker_env (:67-90) gives a
# worker the env the port's launcher gives it (horovod_tpu_torch/runner/
# run.py worker_envs); the rest as it is.
"""``RayExecutor``: run horovod_tpu_torch jobs as Ray actors.

Parity: reference ``horovod/ray/runner.py`` (SURVEY.md §2b P12) —
``RayExecutor(settings, num_workers=..., use_gpu=...)`` with
``start() / run(fn) / run_remote(fn) / execute(fn) / shutdown()``.

Placement (pack/spread over the cluster's node inventory) is computed by
the pure strategies in ``strategy.py``; this module only does the thin Ray
actor orchestration, and degrades to a clear ImportError when Ray is not
installed (the API surface is kept so Ray-based codebases can port
unchanged).  Each actor exports the env the port's launcher gives a worker
(``runner/run.py`` ``worker_envs``), so ``hvd.init()`` in it forms the
port's world: ``cuda:<local rank>`` and NCCL, or ``init(device="cpu")``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

from . import strategy as _strategy


def _require_ray():
    try:
        import ray  # noqa: F401
        return ray
    except ImportError as exc:
        raise ImportError(
            "horovod_tpu_torch.ray requires the `ray` package, which is not "
            "installed in this environment. The placement strategies "
            "(horovod_tpu_torch.ray.strategy) work standalone; install ray "
            "to launch actors.") from exc


class RayExecutor:
    """Reference-compatible executor facade.

    Example (with ray installed)::

        executor = RayExecutor(num_workers=8, use_accelerators=True)
        executor.start()
        results = executor.run(train_fn, args=(cfg,))
        executor.shutdown()
    """

    def __init__(self, settings: Optional[dict] = None,
                 num_workers: int = 1, cpus_per_worker: int = 1,
                 use_accelerators: bool = True,
                 placement: str = "pack", env_vars: Optional[Dict] = None):
        if placement not in ("pack", "spread"):
            raise ValueError("placement must be 'pack' or 'spread'")
        self.settings = settings or {}
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        self.use_accelerators = use_accelerators
        self.placement = placement
        self.env_vars = dict(env_vars or {})
        self.workers: List[Any] = []
        self._allocations: List[_strategy.Allocation] = []

    # ------------------------------------------------------------ placement
    def compute_placement(self, nodes) -> List[_strategy.Allocation]:
        fn = _strategy.pack if self.placement == "pack" else _strategy.spread
        self._allocations = fn(nodes, self.num_workers,
                               self.use_accelerators)
        return self._allocations

    def worker_env(self, alloc: _strategy.Allocation,
                   coordinator: tuple) -> Dict[str, str]:
        """The env one worker actor exports before ``hvd.init()``: what the
        port's launcher gives the worker of this rank on these hosts
        (``runner/run.py`` ``worker_envs`` and ``platform_worker_env``),
        then ``env_vars``."""
        from ..runner.run import HostSpec, platform_worker_env
        hosts: List[str] = []
        for a in self._allocations:
            if a.hostname not in hosts:
                hosts.append(a.hostname)
        counts = [sum(1 for a in self._allocations if a.hostname == h)
                  for h in hosts]
        cross_rank = hosts.index(alloc.hostname)
        env = platform_worker_env(
            [HostSpec(h, c) for h, c in zip(hosts, counts)], cross_rank, {})
        env.update({
            "HOROVOD_RANK": str(alloc.rank),
            "HOROVOD_SIZE": str(len(self._allocations)),
            "HOROVOD_LOCAL_RANK": str(alloc.local_rank),
            "HOROVOD_LOCAL_SIZE": str(counts[cross_rank]),
            "HOROVOD_CROSS_RANK": str(cross_rank),
            "HOROVOD_CROSS_SIZE": str(len(hosts)),
            "HOROVOD_LOCAL_COUNTS": ",".join(map(str, counts)),
            "HOROVOD_CONTROLLER_ADDR": coordinator[0],
            "HOROVOD_CONTROLLER_PORT": str(coordinator[1]),
            "HOROVOD_CONTROLLER_PORT2": str(coordinator[2]),
            "HOROVOD_HOSTNAME": alloc.hostname,
        })
        env.update({k: str(v) for k, v in self.env_vars.items()})
        return env

    # ------------------------------------------------------------ lifecycle
    def start(self):
        ray = _require_ray()
        from ray.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        from ..common.net import free_ports, is_local_host, remote_ports

        live = [n for n in ray.nodes() if n.get("Alive")]
        nodes = [
            _strategy.NodeResources(
                hostname=n["NodeManagerAddress"],
                cpus=int(n["Resources"].get("CPU", 0)),
                accelerators=int(n["Resources"].get(
                    "TPU", n["Resources"].get("GPU", 0))))
            for n in live]
        node_ids = {n["NodeManagerAddress"]: n["NodeID"] for n in live}
        allocations = self.compute_placement(nodes)
        # Ports must be free on the COORDINATOR node, not the driver; when
        # it is a different machine bind-probing here proves nothing.
        coord_host = allocations[0].hostname
        ports = (free_ports(2) if is_local_host(coord_host)
                 else remote_ports(2, os.getpid()))
        coord = (coord_host, *ports)

        @ray.remote(num_cpus=self.cpus_per_worker)
        class _Worker:
            def __init__(self, env):
                os.environ.update(env)

            def execute(self, fn, *args, **kwargs):
                return fn(*args, **kwargs)

        # Pin each actor to the node its assignment names — the env
        # (HOSTNAME/LOCAL_RANK/controller address) is only valid there.
        self.workers = [
            _Worker.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=node_ids[a.hostname], soft=False),
            ).remote(self.worker_env(a, coord))
            for a in allocations]

    def run(self, fn: Callable, args=(), kwargs=None) -> List[Any]:
        """Run ``fn`` on every worker; block for all results."""
        ray = _require_ray()
        return ray.get(self.run_remote(fn, args, kwargs))

    def run_remote(self, fn: Callable, args=(), kwargs=None) -> List[Any]:
        _require_ray()
        kwargs = kwargs or {}
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn: Callable) -> List[Any]:
        """Apply ``fn(worker)`` on each actor (reference API)."""
        ray = _require_ray()
        return ray.get([w.execute.remote(fn) for w in self.workers])

    def shutdown(self):
        if not self.workers:
            return
        ray = _require_ray()
        for w in self.workers:
            ray.kill(w)
        self.workers = []
