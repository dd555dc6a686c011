# Copied from horovod_tpu/monitor/__init__.py:1-31 (the package's exports);
# jax-free, the port keeps its own copy; the CLI's name is the port's.
"""Cross-rank telemetry & health subsystem (no jax imports).

The first subsystem that can observe the whole fleet at once
(``docs/monitoring.md``): a per-rank :class:`MetricRegistry` the engine,
scheduler, response cache, in-flight ring and runtime sanitizer publish
into; a low-priority **monitor side-channel** through the coordinator
(``csrc/coordinator.cc`` protocol v3) that periodically ships each rank's
metric snapshot and sanitizer ledger tail to every peer; and export
surfaces — a rank-0 HTTP endpoint (``/metrics`` Prometheus + ``/health``
JSON + ``/snapshot``), a ``python -m horovod_tpu_torch.monitor`` CLI, and a
timeline ``monitor`` counter track.

Enable with ``HOROVOD_MONITOR=1``; ``HOROVOD_MONITOR_PORT`` starts the
rank-0 HTTP exporter; ``HOROVOD_MONITOR_INTERVAL`` sets the reporting
period (seconds, default 5).

This package must stay importable without jax (tier-1 purity guard in
``tests/test_monitor.py``): agents reach the engine only through
duck-typed attributes.
"""

from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricRegistry, DEFAULT_BUCKETS,
)
from .aggregator import RankAggregator  # noqa: F401
from .agent import MonitorAgent  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "DEFAULT_BUCKETS",
    "RankAggregator", "MonitorAgent",
]
