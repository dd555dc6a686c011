# Copied from horovod_tpu/monitor/registry.py:1-302 (jax-free; the port keeps its own copy).
"""Per-rank metric registry (no jax imports).

The local half of the telemetry subsystem (``docs/monitoring.md``): every
process owns one :class:`MetricRegistry` that the engine, the scheduler
primitives, the negotiation response cache, the in-flight ring and the
runtime sanitizer publish into.  The registry is deliberately dumb — three
metric kinds, a flat snapshot dict, and a Prometheus text rendering — so it
can be read by the controller side-channel, the rank-0 HTTP exporter, the
timeline counter track and ``bench.py`` without any of them knowing about
the publishers.

Reference mapping: the reference exposes per-rank state only through the
timeline and log lines; this registry is the missing queryable surface the
Horovod paper's operability story implies (stall warnings, autotune logs,
timeline) — SURVEY.md §5 "observability".

Publishers either own a metric handle (``registry.counter("x").inc()``) or
register a *collector* — a callback run at snapshot time that refreshes
gauges from live objects (``engine``/``scheduler`` state), keeping the hot
dispatch path free of per-event registry calls.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

Number = Union[int, float]

# Default histogram buckets: coordinator-cycle microseconds (spans the
# inline-kick fast path through a slow multi-host negotiation round).
DEFAULT_BUCKETS = (50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                   10000.0, 50000.0, 250000.0, 1000000.0)


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() or ch in "_:":
            out.append(ch)
        else:
            out.append("_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s or "_"


class Counter:
    """Monotonically increasing value."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value: float = 0

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        with self._lock:
            return self._value

    def set_total(self, total: Number) -> None:
        """Adopt an externally maintained cumulative total (collectors
        mirroring pre-existing engine counters).  Never moves backwards."""
        with self._lock:
            if total > self._value:
                self._value = total

    def snapshot_value(self):
        return self.value


class Gauge:
    """Point-in-time value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value: Number = 0

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: Number = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> Number:
        with self._lock:
            return self._value

    def snapshot_value(self):
        return self.value


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics: each bucket
    counts observations ``<= le``; ``+Inf`` is the total count)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # last = +Inf overflow
        self._sum: float = 0.0
        self._count: int = 0

    def observe(self, v: Number) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot_value(self) -> dict:
        with self._lock:
            cum, out = 0, {}
            for le, c in zip(self.buckets, self._counts):
                cum += c
                out[le] = cum
            return {"count": self._count, "sum": round(self._sum, 3),
                    "buckets": out}

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the q-th percentile (``q`` in [0, 1]) by linear
        interpolation inside the bucket that crosses it — the standard
        Prometheus ``histogram_quantile`` estimate, computed locally so
        ``/metrics`` can export p50/p99 without a query engine (serving
        latency SLOs are percentile targets, not means).  None
        until something was observed; observations past the last finite
        bucket clamp to that bound (the estimate cannot exceed what the
        buckets resolve)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"percentile wants q in [0, 1], got {q}")
        with self._lock:
            total = self._count
            if total == 0 or not self.buckets:
                return None
            target = q * total
            cum = 0
            lo = 0.0
            for le, c in zip(self.buckets, self._counts):
                if c and cum + c >= target:
                    frac = (target - cum) / c
                    return round(lo + (le - lo) * frac, 4)
                cum += c
                lo = le
            return self.buckets[-1]

    def set_cumulative(self, counts: Sequence[int], sum_: float,
                       count: int) -> None:
        """Adopt an externally maintained histogram (collectors mirroring
        a publisher's own per-bucket counts — e.g. the trace recorder's
        per-phase buckets — without per-event registry calls on the hot
        path).  ``counts`` are per-bucket non-cumulative counts aligned
        with ``self.buckets`` plus the +Inf overflow.  Never moves
        backwards, matching ``Counter.set_total`` semantics."""
        counts = list(counts)
        if len(counts) != len(self._counts):
            raise ValueError(
                f"histogram {self.name!r}: expected {len(self._counts)} "
                f"bucket counts, got {len(counts)}")
        with self._lock:
            if count >= self._count:
                self._counts = counts
                self._sum = float(sum_)
                self._count = int(count)


class MetricRegistry:
    """Thread-safe name → metric table with snapshot-time collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._collectors: List[Callable[["MetricRegistry"], None]] = []

    # -------------------------------------------------------- registration
    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def register_collector(self,
                           fn: Callable[["MetricRegistry"], None]) -> None:
        """``fn(registry)`` runs before every snapshot/render — the place
        to refresh gauges from live engine/scheduler objects without
        touching the hot path per event."""
        with self._lock:
            self._collectors.append(fn)

    # ------------------------------------------------------------- reading
    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 - telemetry must never raise
                pass

    def get(self, name: str) -> Optional[object]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, object]:
        """Flat ``name -> value`` dict (histograms become sub-dicts) —
        the payload the controller side-channel ships to rank 0."""
        self._run_collectors()
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot_value() for m in metrics}

    def to_prometheus(self, extra_label: str = "") -> str:
        """Prometheus text exposition format (served at ``/metrics``).

        ``extra_label`` is an optional pre-rendered label body (e.g.
        ``rank="0"``) applied to every series."""
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        lab = "{" + extra_label + "}" if extra_label else ""
        for m in metrics:
            name = _sanitize(m.name)
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                snap = m.snapshot_value()
                for le, c in snap["buckets"].items():
                    le_lab = f'le="{le:g}"'
                    body = (extra_label + "," + le_lab) if extra_label \
                        else le_lab
                    lines.append(f"{name}_bucket{{{body}}} {c}")
                inf_lab = 'le="+Inf"'
                body = (extra_label + "," + inf_lab) if extra_label \
                    else inf_lab
                lines.append(f"{name}_bucket{{{body}}} {snap['count']}")
                lines.append(f"{name}_sum{lab} {snap['sum']:g}")
                lines.append(f"{name}_count{lab} {snap['count']}")
                # Percentile export: pre-computed p50/p99
                # gauges so load balancers / autoscalers without a
                # histogram_quantile engine read latency SLOs directly.
                for q, suffix in ((0.5, "p50"), (0.99, "p99")):
                    v = m.percentile(q)
                    if v is not None:
                        lines.append(f"{name}_{suffix}{lab} {v:g}")
            else:
                lines.append(f"{name}{lab} {m.snapshot_value():g}")
        return "\n".join(lines) + "\n"
