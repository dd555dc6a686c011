# Copied from horovod_tpu/monitor/aggregator.py:1-443 (RankAggregator); jax-
# free, the port keeps its own copy; issue-number tags
# are dropped from the comments.
"""Rank-0 aggregation table for cross-rank telemetry (no jax imports).

Every rank periodically ships a snapshot blob (metrics + sanitizer ledger
tail + stall state) through the coordinator's low-priority monitor frames
(``csrc/coordinator.cc`` protocol v3, ``common/controller.py``); the server
re-broadcasts fresh blobs to every rank, so each process — most usefully
rank 0, which serves ``/metrics`` and ``/health`` — holds the same
fleet-wide table.

What the table answers that no per-rank view can:

- **skew / straggler attribution**: slowest rank id and the cycle-time
  spread across the fleet (the Horovod paper's "one slow rank gates the
  world" diagnosis, computed instead of guessed);
- **laggard ledger tails**: a stalling rank's HVD302 report can quote the
  *laggard's* last submissions (the ROADMAP ledger-exchange item) — see
  ``analysis/runtime_sanitizer.py``;
- **liveness**: a rank whose snapshots stopped arriving is dead or wedged
  even while the lock-step protocol technically still waits on it.

A join epoch flushes the table (``controller.on_join_epoch``): snapshots
captured while the world was uneven must not survive into the resumed
world (mirrors the response-cache slot flush at the same boundary).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


# Fleet commit age reported for a rank whose state plane is armed but
# has never committed: effectively-infinitely stale, but a
# FINITE float — float('inf') would serialize into /health as the
# non-standard JSON token `Infinity` and break strict parsers (jq,
# JSON.parse, Go) exactly when operators look during startup/rejoin.
NEVER_COMMITTED_AGE_S = 1e12


class EwmaTrend:
    """Windowed EWMA trend of a scalar series: fast EWMA minus slow EWMA.

    Positive = the series is rising, negative = falling, ~0 = flat; the
    magnitude is in the series' own units, so thresholds stay intuitive
    (a ``queue_depth_trend`` of 3 means the backlog is ~3 entries above
    its recent baseline).  ``trend`` is ``None`` until ``min_samples``
    observations arrived — the autoscale policy treats nulls as
    "window not filled, hold" — and ``reset()`` re-empties the window
    (join-epoch flush: samples from an uneven world must not steer
    scaling decisions into the resumed one)."""

    def __init__(self, fast: float = 0.5, slow: float = 0.1,
                 min_samples: int = 5):
        self.fast_alpha = float(fast)
        self.slow_alpha = float(slow)
        self.min_samples = max(1, int(min_samples))
        self._fast: Optional[float] = None
        self._slow: Optional[float] = None
        self._n = 0

    def update(self, value: float) -> None:
        v = float(value)
        self._fast = v if self._fast is None else (
            self.fast_alpha * v + (1 - self.fast_alpha) * self._fast)
        self._slow = v if self._slow is None else (
            self.slow_alpha * v + (1 - self.slow_alpha) * self._slow)
        self._n += 1

    @property
    def trend(self) -> Optional[float]:
        if self._n < self.min_samples:
            return None
        return round(self._fast - self._slow, 4)

    @property
    def level(self) -> Optional[float]:
        """Smoothed current value (the fast EWMA), null until the window
        fills — the serving summary's ``request_rate``/``latency_p99_ms``
        read this so one noisy sample never steers a scale decision."""
        if self._n < self.min_samples:
            return None
        return round(self._fast, 4)

    def reset(self) -> None:
        self._fast = None
        self._slow = None
        self._n = 0


def merged_percentile(hists, q: float) -> Optional[float]:
    """Percentile of the UNION of per-rank histogram snapshots (the
    ``{"count", "sum", "buckets": {le: cum}}`` shape the registry ships
    over the side-channel).  Buckets merge by upper bound — every rank
    publishes the same serving-latency buckets, so the cumulative counts
    add directly; interpolation inside the crossing bucket matches
    ``registry.Histogram.percentile``.  None until anything observed.

    The empty contract is AUDITED to match the local path exactly
    (the front door's hedging delay reads a p99 at startup,
    before any traffic, through either path): no snapshots, all-empty
    snapshots, and count-without-finite-buckets snapshots all return
    ``None`` here and from ``Histogram.percentile`` alike — never 0.0,
    never a crash."""
    merged: Dict[float, int] = {}
    total = 0
    for h in hists:
        if not h:
            continue
        total += int(h.get("count") or 0)
        for le, cum in (h.get("buckets") or {}).items():
            le = float(le)
            merged[le] = merged.get(le, 0) + int(cum)
    if total == 0 or not merged:
        return None
    target = q * total
    lo = 0.0
    prev_cum = 0
    for le in sorted(merged):
        cum = merged[le]
        if cum > prev_cum and cum >= target:
            frac = (target - prev_cum) / (cum - prev_cum)
            return round(lo + (le - lo) * frac, 4)
        prev_cum = max(prev_cum, cum)
        lo = le
    return max(merged)


class RankAggregator:
    """Per-rank snapshot table + fleet-level derived views."""

    def __init__(self, world: int):
        self.world = max(1, int(world))
        self._lock = threading.Lock()
        # rank -> {"snap": dict, "received_at": monotonic}
        self._table: Dict[int, dict] = {}
        # Ranks that departed via clean LEAVE (protocol v6): excluded from
        # liveness/degraded accounting — an orderly departure must not
        # flip /health — and reported under "left_ranks".  NOT cleared by
        # flush(): the departure outlives any join epoch; only a new
        # controller generation (fresh aggregator) forgets it.
        self._left: set = set()
        # Windowed trend gauges (autoscale policy inputs — docs/elastic.md
        # "Closed-loop autoscaling"): nulls until the window fills,
        # flushed on join epoch like the rest of the table.
        self._spread_trend = EwmaTrend()
        self._queue_trend = EwmaTrend()
        # Serving instruments (docs/serving.md): fleet request
        # rate from the summed per-rank request counters differenced at
        # snapshot cadence, and fleet p99 latency from the merged serving
        # histograms — both EWMA-smoothed, nulls until the window fills.
        self._rate_trend = EwmaTrend(min_samples=3)
        self._latency_trend = EwmaTrend(min_samples=3)
        self._serve_last: Optional[tuple] = None   # (requests_total, mono)
        self.flushes = 0
        self.updates = 0

    # ------------------------------------------------------------- writing
    def update(self, rank: int, snap: dict) -> None:
        with self._lock:
            self._table[int(rank)] = {"snap": snap,
                                      "received_at": time.monotonic()}
            self.updates += 1
            # Feed the trend windows at snapshot cadence: spread needs two
            # reporting ranks; queue depth sums every rank's pending count.
            per_rank = [rec["snap"].get("cycle_us_avg")
                        for r, rec in self._table.items()
                        if r not in self._left
                        and rec["snap"].get("cycle_us_avg") is not None]
            if len(per_rank) >= 2:
                self._spread_trend.update(max(per_rank) - min(per_rank))
            q = self._queue_depth_locked()
            if q is not None:
                self._queue_trend.update(q)
            self._update_serving_locked()

    def _update_serving_locked(self) -> None:
        """Feed the serving trends at snapshot cadence: the fleet request
        counter's first derivative (offered QPS) and the merged-histogram
        p99.  No serving metrics reported → no samples → the summary
        fields stay null and the policy's serving mode stays inert."""
        totals = []
        hists = []
        for r, rec in self._table.items():
            if r in self._left:
                continue
            m = rec["snap"].get("metrics") or {}
            v = m.get("hvd_serve_requests_total")
            if v is not None:
                totals.append(float(v))
            h = m.get("hvd_serve_latency_ms")
            if isinstance(h, dict):
                hists.append(h)
        if totals:
            total = sum(totals)
            now = time.monotonic()
            if self._serve_last is not None:
                last_total, last_t = self._serve_last
                dt = now - last_t
                if dt > 1e-3:
                    self._rate_trend.update(
                        max(0.0, total - last_total) / dt)
                    self._serve_last = (total, now)
            else:
                self._serve_last = (total, now)
        p99 = merged_percentile(hists, 0.99)
        if p99 is not None:
            self._latency_trend.update(p99)

    def mark_left(self, rank: int) -> None:
        """Record a clean departure (protocol v6 leave notice): the rank
        stops counting toward liveness — ``/health`` stays ok — and its
        stale snapshot is dropped."""
        with self._lock:
            self._left.add(int(rank))
            self._table.pop(int(rank), None)

    def flush(self) -> None:
        """Drop every snapshot (join-epoch boundary / elastic re-init).
        Trend windows flush with the table; clean-leave records persist
        (the departed rank is still gone in the resumed world)."""
        with self._lock:
            self._table.clear()
            self._spread_trend.reset()
            self._queue_trend.reset()
            self._rate_trend.reset()
            self._latency_trend.reset()
            self._serve_last = None
            self.flushes += 1

    @staticmethod
    def is_alive(age_s: float, interval_s: float) -> bool:
        """THE liveness rule, shared by /health and the /metrics
        ``hvd_rank_alive`` series: a rank is alive while its last snapshot
        is younger than three reporting intervals."""
        return age_s <= max(1.0, 3.0 * interval_s)

    # ------------------------------------------------------------- reading
    def ranks(self) -> List[int]:
        with self._lock:
            return sorted(self._table)

    def snapshot_of(self, rank: int) -> Optional[dict]:
        with self._lock:
            rec = self._table.get(int(rank))
            return rec["snap"] if rec else None

    def table(self) -> Dict[int, dict]:
        """``rank -> {"snap": ..., "age_s": ...}`` copy for exporters."""
        now = time.monotonic()
        with self._lock:
            return {r: {"snap": rec["snap"],
                        "age_s": round(now - rec["received_at"], 3)}
                    for r, rec in self._table.items()}

    def left_ranks(self) -> List[int]:
        with self._lock:
            return sorted(self._left)

    def _queue_depth_locked(self) -> Optional[int]:
        """Fleet queue depth: sum of every reporting rank's
        ``hvd_queue_pending`` gauge; None until someone reports it."""
        vals = []
        for r, rec in self._table.items():
            if r in self._left:
                continue
            v = (rec["snap"].get("metrics") or {}).get("hvd_queue_pending")
            if v is not None:
                vals.append(int(v))
        return sum(vals) if vals else None

    def skew(self) -> dict:
        """Straggler attribution from per-rank cycle timings.

        Each snapshot carries ``cycle_us_avg`` (mean coordinator-cycle
        wall microseconds on that rank).  Returns the slowest rank id and
        the max-min spread; nulls until at least two ranks reported."""
        with self._lock:
            per_rank = {r: rec["snap"].get("cycle_us_avg")
                        for r, rec in self._table.items()
                        if r not in self._left
                        and rec["snap"].get("cycle_us_avg") is not None}
        if len(per_rank) < 2:
            return {"slowest_rank": None, "cycle_us_spread": None,
                    "per_rank_cycle_us": per_rank or None}
        slowest = max(per_rank, key=lambda r: per_rank[r])
        spread = round(max(per_rank.values()) - min(per_rank.values()), 2)
        return {"slowest_rank": slowest, "cycle_us_spread": spread,
                "per_rank_cycle_us": per_rank}

    def summary(self) -> dict:
        """The autoscale policy's observation record (docs/elastic.md):
        straggler attribution plus the windowed trend gauges and fleet
        load figures, so policy inputs are observable standalone — the
        same numbers ride ``/health`` and ``/metrics``.  Trend fields are
        null until their EWMA window fills."""
        out = self.skew()
        with self._lock:
            out["queue_depth"] = self._queue_depth_locked()
            out["cycle_us_spread_trend"] = self._spread_trend.trend
            out["queue_depth_trend"] = self._queue_trend.trend
            # Serving instruments: fleet offered QPS (EWMA
            # level of the summed request-counter derivative), its trend
            # (the policy's "offered load rising" input), and fleet p99
            # serving latency — nulls-until-filled like the queue trends,
            # and null forever on fleets that never serve.
            out["request_rate"] = self._rate_trend.level
            out["request_rate_trend"] = self._rate_trend.trend
            out["latency_p99_ms"] = self._latency_trend.level
            out["ranks_reporting"] = len(
                [r for r in self._table if r not in self._left])
            out["left_ranks"] = sorted(self._left)
            # Fleet WORK-progress counter (the autoscale idle detector's
            # input): dispatched batches, NOT coordinator cycles — the
            # engine's cycle index advances on idle ticks too, so an idle
            # fleet would never read as idle through it.  Falls back to
            # the cycle counter for snapshot sources without the dispatch
            # metric.
            prog = []
            for r, rec in self._table.items():
                if r in self._left:
                    continue
                m = rec["snap"].get("metrics") or {}
                v = m.get("hvd_pipeline_dispatches_total")
                if v is None:
                    v = rec["snap"].get("cycle")
                if v is not None:
                    prog.append(v)
            out["progress_total"] = sum(prog) if prog else None
            # Fleet commit age (the autoscaler's stale-state
            # guard input): the STALEST reporting rank's state-plane
            # commit age — one rank with an old restore point makes the
            # whole fleet's shrink unsafe.  A rank whose plane is ARMED
            # but has never committed counts as effectively-infinitely
            # stale (NEVER_COMMITTED_AGE_S — finite, so /health stays
            # strict JSON), not invisible: scaling in before its first
            # commit is exactly the lost-work case the guard refuses.
            # Null only when NO rank reports a checkpoint block at all
            # (state plane not armed: guard stays off).
            ages = []
            for r, rec in self._table.items():
                if r in self._left:
                    continue
                ck = rec["snap"].get("checkpoint")
                if ck is None:
                    continue
                age = ck.get("last_commit_age_s")
                ages.append(NEVER_COMMITTED_AGE_S if age is None
                            else float(age))
            out["last_commit_age_s"] = (round(max(ages), 3) if ages
                                        else None)
        return out

    def peer_ledger_tails(self,
                          exclude_rank: Optional[int] = None
                          ) -> Dict[int, List[str]]:
        """rank -> rendered ledger-tail lines, for HVD302 enrichment."""
        out: Dict[int, List[str]] = {}
        with self._lock:
            for r, rec in self._table.items():
                if exclude_rank is not None and r == exclude_rank:
                    continue
                tail = rec["snap"].get("ledger") or []
                if tail:
                    out[r] = list(tail)
        return out

    def health(self, interval_s: float = 5.0) -> dict:
        """The ``/health`` JSON body: per-rank liveness, last-cycle age,
        stall state, plus fleet status and straggler attribution.

        A rank is *alive* while its last snapshot is younger than three
        reporting intervals.  Status: ``stalled`` when any rank reports a
        stalled collective, ``degraded`` when a rank is missing or its
        snapshots aged out, else ``ok``."""
        now = time.monotonic()
        ranks: Dict[str, dict] = {}
        any_stalled = False
        missing = 0
        with self._lock:
            table = dict(self._table)
            left = set(self._left)
        for r in range(self.world):
            if r in left:
                # Clean departure (protocol v6): the rank is GONE by
                # design, not degraded — reported separately, never as
                # missing.
                ranks[str(r)] = {"alive": False, "left": True,
                                 "last_seen_s": None, "cycle": None,
                                 "last_cycle_age_s": None, "stalled": []}
                continue
            rec = table.get(r)
            if rec is None:
                ranks[str(r)] = {"alive": False, "last_seen_s": None,
                                 "cycle": None, "last_cycle_age_s": None,
                                 "stalled": []}
                missing += 1
                continue
            snap = rec["snap"]
            age = now - rec["received_at"]
            alive = self.is_alive(age, interval_s)
            stalled = list(snap.get("stalled") or [])
            any_stalled = any_stalled or bool(stalled)
            missing += 0 if alive else 1
            ranks[str(r)] = {
                "alive": alive,
                "last_seen_s": round(age, 3),
                "cycle": snap.get("cycle"),
                "last_cycle_age_s": snap.get("last_cycle_age_s"),
                "stalled": stalled,
            }
        status = ("stalled" if any_stalled
                  else "degraded" if missing else "ok")
        out = {"status": status, "world": self.world,
               "monitor_interval_s": interval_s, "ranks": ranks}
        out.update(self.summary())
        # Checkpoint block: the state plane's fleet view — the
        # per-rank epochs an operator reads to see WHO lags, plus the
        # fleet commit age the stale-state guard consumes (also mirrored
        # flat in the summary above).  Present only when some rank runs
        # the plane.
        ck_ranks = {}
        for r, rec in table.items():
            if r in left:
                continue
            ck = rec["snap"].get("checkpoint")
            if ck:
                ck_ranks[str(r)] = {
                    "epoch": ck.get("epoch"),
                    "durable_epoch": ck.get("durable_epoch"),
                    "last_commit_age_s": ck.get("last_commit_age_s"),
                    "write_failures": ck.get("write_failures"),
                    "last_restore_source": ck.get("last_restore_source"),
                }
        if ck_ranks:
            out["checkpoint"] = {
                "last_commit_age_s": out.get("last_commit_age_s"),
                "min_durable_epoch": min(
                    (v["durable_epoch"] for v in ck_ranks.values()
                     if v["durable_epoch"] is not None), default=None),
                "ranks": ck_ranks,
            }
        return out
