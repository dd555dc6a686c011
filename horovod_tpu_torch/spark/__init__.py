# Ported from horovod_tpu/spark/__init__.py:1-106: _task_env (:47-79)
# gives a task the env the port's launcher gives a worker (horovod_tpu_torch/
# runner/run.py worker_envs); there is no JaxEstimator.
"""Spark integration (reference: ``horovod/spark`` — SURVEY.md §2b P11).

``horovod_tpu_torch.spark.run(fn, ...)`` executes ``fn`` on ``num_proc``
Spark executors with the port's world formed across them, mirroring
``horovod.spark.run``.  It uses Spark **barrier execution mode**: all tasks
are scheduled together and ``BarrierTaskContext.getTaskInfos()`` gives every
task the same ordered view of participant addresses, so each task derives
its rank/local_rank/controller address from the SAME gang — no cross-job
placement race (the reference achieves this with its own driver/task probe
services, §3.3; barrier mode is Spark's native equivalent).

Without PySpark the entry point degrades to a clear ImportError; the
``Store`` abstraction (``horovod_tpu_torch.spark.store``) is fully
functional standalone and is what estimator-style checkpoint/log plumbing
builds on.  Each task exports the env the port's launcher gives a worker,
so ``hvd.init()`` in ``fn`` forms the port's world (``cuda:<local rank>``
and NCCL, or ``init(device="cpu")``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from .store import (  # noqa: F401
    GCSStore, HDFSStore, LocalStore, RemoteStore, S3Store, Store)
from .estimator import (  # noqa: F401
    KerasEstimator, KerasModel, TorchEstimator, TorchModel,
)


def run(fn: Callable, args=(), kwargs=None, num_proc: Optional[int] = None,
        start_timeout: Optional[int] = None, env=None,
        verbose: int = 1) -> List[Any]:
    """Run ``fn`` on each Spark executor with hvd initialized.

    Reference: ``horovod.spark.run`` (``horovod/spark/__init__.py``).
    """
    try:
        import pyspark  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "horovod_tpu_torch.spark.run requires pyspark, which is not "
            "installed in this environment. Use the port's launcher "
            "(python -m horovod_tpu_torch.runner) for direct launches, or "
            "install pyspark on a Spark cluster.") from exc
    return _run_with_spark(fn, args, kwargs or {}, num_proc, env)


def _task_env(task_id: int, addresses: List[str], port_seed: int,
              extra_env: dict) -> dict:
    """Per-task env from the barrier gang's shared address list: what the
    port's launcher gives the worker of this rank on these hosts
    (``runner/run.py`` ``worker_envs`` and ``platform_worker_env``), then
    ``extra_env``.  ``HOROVOD_LOCAL_COUNTS`` is set where the gang lists
    each host's tasks together (host-major, as the launcher numbers them);
    otherwise the world's ranks per host are left unknown and its data
    plane flat.

    Pure function of (task_id, addresses, seed) so every task computes a
    consistent world without further coordination; split out for testing
    without pyspark.
    """
    from ..common.net import remote_ports
    from ..runner.run import HostSpec, platform_worker_env

    hosts = [a.rsplit(":", 1)[0] for a in addresses]
    ordered: List[str] = []
    for h in hosts:
        if h not in ordered:
            ordered.append(h)
    my_host = hosts[task_id]
    local_rank = hosts[:task_id].count(my_host)
    counts = [hosts.count(h) for h in ordered]
    p1, p2 = remote_ports(2, port_seed)
    env = platform_worker_env(
        [HostSpec(h, c) for h, c in zip(ordered, counts)],
        ordered.index(my_host), {})
    env.update({
        "HOROVOD_RANK": str(task_id),
        "HOROVOD_SIZE": str(len(hosts)),
        "HOROVOD_LOCAL_RANK": str(local_rank),
        "HOROVOD_LOCAL_SIZE": str(hosts.count(my_host)),
        "HOROVOD_CROSS_RANK": str(ordered.index(my_host)),
        "HOROVOD_CROSS_SIZE": str(len(ordered)),
        "HOROVOD_CONTROLLER_ADDR": hosts[0],
        "HOROVOD_CONTROLLER_PORT": str(p1),
        "HOROVOD_CONTROLLER_PORT2": str(p2),
        "HOROVOD_HOSTNAME": my_host,
    })
    if hosts == [h for h, c in zip(ordered, counts) for _ in range(c)]:
        env["HOROVOD_LOCAL_COUNTS"] = ",".join(map(str, counts))
    env.update({k: str(v) for k, v in (extra_env or {}).items()})
    return env


def _run_with_spark(fn, args, kwargs, num_proc,
                    env):
    import random

    from pyspark import SparkContext

    sc = SparkContext._active_spark_context
    if sc is None:
        raise RuntimeError("No active SparkContext; create one before "
                           "calling horovod_tpu_torch.spark.run")
    num_proc = num_proc or sc.defaultParallelism
    port_seed = random.SystemRandom().randrange(1 << 30)
    extra_env = dict(env or {})

    def _task(_it):
        import os
        from pyspark import BarrierTaskContext
        ctx = BarrierTaskContext.get()
        addresses = [i.address for i in ctx.getTaskInfos()]
        os.environ.update(_task_env(ctx.partitionId(), addresses, port_seed,
                                    extra_env))
        ctx.barrier()  # everyone has the env before anyone inits
        yield fn(*args, **kwargs)

    rdd = sc.parallelize(range(num_proc), num_proc)
    return rdd.barrier().mapPartitions(_task).collect()
