# Copied from horovod_tpu/elastic/autoscale.py:1-331; issue and PR
# references are dropped from the comments.
"""Closed-loop elastic autoscaling: the policy engine (no jax imports).

The monitor computes cycle-time spread and names stragglers, the control
plane can lose and cleanly release ranks, the elastic driver can
re-rendezvous a resized world — and this module decides WHEN.  Sergeev & Del Balso's operability stance
(PAPERS.md — stall warnings and autotuning as built-in operator tooling,
not runbooks) is the template: the system scales itself.

Shape: :class:`ScalePolicy` is a pure, clock-injected decision function —
``observe(summary, size, now)`` consumes one
:meth:`~..monitor.aggregator.RankAggregator.summary` record (cycle-time
spread + windowed EWMA trends + fleet queue depth + cycle counters) and
returns a typed :class:`ScaleDecision`.  No I/O, no threads, no wall
clock: the driver's orchestration loop (``elastic/driver.py``) owns
polling the rank-0 monitor endpoint and executing decisions
(``scale_out`` → the operator's scale command, ``evict``/``scale_in`` →
drain ping → clean LEAVE → discovery update), and tests drive the policy
with scripted summaries and a scripted clock.

Decision table (first match wins; see docs/elastic.md "Closed-loop
autoscaling" for the knob table):

=============  ======================================================
``preempt``    the discovery source posted a preemption notice for an
               assigned host (``observe(preempt_hosts=...)``): the
               hardware is going away on the platform's schedule, so
               the decision OUTRANKS every load signal AND the cooldown
               window — waiting is not an option — and opens a fresh
               cooldown so the shrink isn't immediately second-guessed
               by a queue-depth scale-out
``evict``      the SAME rank has been the slowest for ``persistence``
               consecutive observations AND its mean cycle time is ≥
               ``straggler_factor`` × the median of the other ranks —
               a persistent straggler gates the whole fleet (the
               Horovod paper's diagnosis), so drain it and let the
               world heal without it
``scale_out``  fleet queue depth trends up (``queue_depth_trend`` >
               ``queue_trend_up``) or sits above ``queue_high`` for
               ``persistence`` observations, and the world is below
               ``max_np`` — load is arriving faster than it drains.
               Serving mode feeds the SAME persistence
               counter from two more triggers: per-replica request rate
               above ``rate_high`` req/s, or fleet p99 latency above
               ``latency_target_ms``
``scale_in``   the fleet has been idle (zero queued work, no cycle
               progress — or, with ``idle_qps`` set, fleet request rate
               below that floor) for ``idle_s`` seconds and the world
               is above ``min_np``
``hold``       anything else — including the ``cooldown_s`` window
               after every non-hold decision, any observation whose
               trend windows have not filled (nulls never scale), and
               the stale-state guard: an evict/scale_in that
               would otherwise fire is REFUSED while the fleet's last
               state-plane commit is older than ``commit_max_age_s``
               (``HOROVOD_COMMIT_MAX_AGE_S``; preemption exempt — the
               hardware is leaving either way)
=============  ======================================================

Hysteresis is everywhere deliberate: trends must PERSIST (the
``persistence`` counter), every action opens a cooldown window, and the
idle timer resets on any sign of progress — a discovery flap or one
transient stall must not thrash the world.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

HOLD = "hold"
SCALE_OUT = "scale_out"
SCALE_IN = "scale_in"
EVICT = "evict"
PREEMPT = "preempt"


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One typed policy verdict.

    ``action`` is one of ``hold``/``scale_out``/``scale_in``/``evict``/
    ``preempt``; ``target_size`` rides the scale actions, ``evict_rank``
    the evict one, ``hosts`` the preempt one, and ``reason`` carries the
    human-readable attribution the driver logs (and the straggler's
    monitor evidence)."""

    action: str
    reason: str = ""
    target_size: Optional[int] = None
    evict_rank: Optional[int] = None
    hosts: tuple = ()

    @property
    def is_hold(self) -> bool:
        return self.action == HOLD


class ScalePolicy:
    """Hysteresis-damped scaling decisions from monitor summaries.

    All thresholds are constructor knobs (wired from ``HOROVOD_AUTOSCALE_*``
    by the driver — docs/elastic.md); the clock is injected through
    ``observe(now=...)`` so tests are deterministic."""

    def __init__(self, min_np: int, max_np: Optional[int] = None,
                 queue_high: float = 16.0, queue_trend_up: float = 4.0,
                 straggler_factor: float = 3.0, persistence: int = 3,
                 cooldown_s: float = 30.0, idle_s: float = 60.0,
                 scale_step: int = 1, commit_max_age_s: float = 0.0,
                 rate_high: float = 0.0, latency_target_ms: float = 0.0,
                 idle_qps: float = 0.0):
        self.min_np = max(1, int(min_np))
        self.max_np = int(max_np) if max_np else None
        self.queue_high = float(queue_high)
        self.queue_trend_up = float(queue_trend_up)
        self.straggler_factor = max(1.0, float(straggler_factor))
        self.persistence = max(1, int(persistence))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.idle_s = max(0.0, float(idle_s))
        self.scale_step = max(1, int(scale_step))
        # Stale-state guard (HOROVOD_COMMIT_MAX_AGE_S): while
        # the fleet's last state-plane commit is older than this, the
        # policy REFUSES evict and scale_in — shrinking a world whose
        # restore point is stale converts an orderly drain into lost
        # work.  0 = off; a summary with no checkpoint telemetry is
        # unknown, never stale (fleets without the state plane keep the
        # old behavior).  Preemption is exempt: the hardware is going
        # away on the platform's schedule either way.
        self.commit_max_age_s = max(0.0, float(commit_max_age_s))
        # Serving mode (HOROVOD_AUTOSCALE_{RATE_HIGH,
        # LATENCY_TARGET_MS,IDLE_QPS}): when the fleet runs the serving
        # plane, the load signals are request rate and tail latency, not
        # training queue depth.  ``rate_high`` is a PER-REPLICA request
        # rate (req/s) above which the fleet scales out;
        # ``latency_target_ms`` a fleet p99 SLO that triggers scale-out
        # when breached; ``idle_qps`` a fleet rate floor below which the
        # idle timer may accrue (serving replicas make no training
        # progress, so the progress-based idle test would drain a busy
        # serving fleet).  All default 0 = off: training-only fleets are
        # byte-for-byte unaffected.
        self.rate_high = max(0.0, float(rate_high))
        self.latency_target_ms = max(0.0, float(latency_target_ms))
        self.idle_qps = max(0.0, float(idle_qps))
        self.stale_holds = 0
        # Hysteresis state.
        self._last_action_ts: Optional[float] = None
        self._up_hits = 0
        self._straggler_rank: Optional[int] = None
        self._straggler_hits = 0
        self._idle_since: Optional[float] = None
        self._last_progress_total: Optional[float] = None
        self.decisions = 0             # observability: non-hold verdicts

    # ------------------------------------------------------------ helpers
    def _acted(self, now: float, decision: ScaleDecision) -> ScaleDecision:
        self._last_action_ts = now
        self._up_hits = 0
        self._straggler_hits = 0
        self._straggler_rank = None
        self._idle_since = None
        self.decisions += 1
        return decision

    def _straggler(self, summary: dict, size: int) -> Optional[tuple]:
        """(rank, evidence) when a persistent straggler gates the fleet."""
        slowest = summary.get("slowest_rank")
        # int-normalize: summaries fetched over HTTP round-trip through
        # JSON, which stringifies the per-rank dict's keys.
        per_rank = {int(r): v for r, v in
                    (summary.get("per_rank_cycle_us") or {}).items()}
        if slowest is not None:
            slowest = int(slowest)
        if slowest is None or len(per_rank) < 2 or size - 1 < self.min_np:
            self._straggler_hits = 0
            self._straggler_rank = None
            return None
        others = sorted(v for r, v in per_rank.items() if r != slowest)
        median = others[len(others) // 2]
        worst = per_rank[slowest]
        if median <= 0 or worst < self.straggler_factor * median:
            self._straggler_hits = 0
            self._straggler_rank = None
            return None
        if slowest == self._straggler_rank:
            self._straggler_hits += 1
        else:
            self._straggler_rank = slowest
            self._straggler_hits = 1
        if self._straggler_hits < self.persistence:
            return None
        evidence = (f"monitor attribution: rank {slowest} slowest for "
                    f"{self._straggler_hits} consecutive observations, "
                    f"cycle {worst:g}us vs peer median {median:g}us "
                    f"({worst / median:.1f}x, threshold "
                    f"{self.straggler_factor:g}x), "
                    f"spread {summary.get('cycle_us_spread')}us")
        return slowest, evidence

    # ------------------------------------------------------------ observe
    def observe(self, summary: dict, size: int,
                now: Optional[float] = None,
                preempt_hosts=()) -> ScaleDecision:
        """One policy step.  ``summary`` is a
        :meth:`RankAggregator.summary` record (possibly fetched over
        HTTP), ``size`` the current world size, ``now`` the injected
        clock (defaults to ``time.monotonic()``), and ``preempt_hosts``
        the discovery source's active preemption notices."""
        if now is None:
            now = time.monotonic()
        size = max(0, int(size))

        # 0. Preemption notices outrank EVERYTHING — including the
        # cooldown window: the platform reclaims the hardware on its own
        # schedule, so holding would just convert an orderly drain into a
        # mid-collective crash.  The decision still OPENS a cooldown (via
        # _acted) so the shrink isn't immediately second-guessed by a
        # queue-depth scale-out.
        if preempt_hosts:
            hosts = tuple(sorted(str(h) for h in preempt_hosts))
            return self._acted(now, ScaleDecision(
                PREEMPT,
                reason=(f"preemption notice for host(s) "
                        f"{', '.join(hosts)} (discovery outranks "
                        f"queue/straggler signals)"),
                hosts=hosts))

        if (self._last_action_ts is not None
                and now - self._last_action_ts < self.cooldown_s):
            return ScaleDecision(HOLD, reason="cooldown")

        # Idle tracking feeds scale-in and resets on ANY progress.  Nulls
        # never scale here either: a summary with NO load telemetry at all
        # (both fields None — exporter up but the aggregation table still
        # empty, e.g. right after a join-epoch flush) is UNKNOWN, not
        # idle — the timer must not accrue toward draining a fleet whose
        # load was never observed.
        queue_depth = summary.get("queue_depth")
        progress_total = summary.get("progress_total")
        rate = summary.get("request_rate")
        p99 = summary.get("latency_p99_ms")
        observed = queue_depth is not None or progress_total is not None
        progressed = (progress_total is not None
                      and progress_total != self._last_progress_total)
        self._last_progress_total = progress_total
        busy = bool(queue_depth) or progressed
        if self.idle_qps > 0 and rate is not None:
            # Serving-idle: replicas make no training progress,
            # so idleness is "request rate below the floor", not "no cycle
            # progress" — otherwise a fleet serving at full tilt would
            # look idle and get drained.
            observed = True
            busy = rate >= self.idle_qps or bool(queue_depth)
        if busy or not observed:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now

        # Stale-state guard: evict/scale_in shrink the world,
        # and a shrink is only safe while the restore point is fresh —
        # compute it once, consult it at both shrink decisions below.
        commit_age = summary.get("last_commit_age_s")
        stale = (self.commit_max_age_s > 0 and commit_age is not None
                 and float(commit_age) > self.commit_max_age_s)

        # 1. Persistent straggler → drain-and-evict (attributed).
        straggler = self._straggler(summary, size)
        if straggler is not None:
            rank, evidence = straggler
            if stale:
                self.stale_holds += 1
                return ScaleDecision(HOLD, reason=(
                    f"stale-state guard: fleet commit age {commit_age:g}s"
                    f" > {self.commit_max_age_s:g}s "
                    f"(HOROVOD_COMMIT_MAX_AGE_S) — refusing evict of rank"
                    f" {rank} until the fleet commits"))
            return self._acted(now, ScaleDecision(
                EVICT, reason=f"persistent straggler; {evidence}",
                evict_rank=rank))

        # 2. Load trending up → scale out.  Serving mode adds
        # two more triggers to the same persistence counter: per-replica
        # request rate above ``rate_high``, or fleet p99 latency above
        # ``latency_target_ms`` — both null-safe (nulls never scale).
        trend = summary.get("queue_depth_trend")
        rate_hot = (self.rate_high > 0 and rate is not None and size > 0
                    and rate / size > self.rate_high)
        latency_hot = (self.latency_target_ms > 0 and p99 is not None
                       and p99 > self.latency_target_ms)
        high = ((trend is not None and trend > self.queue_trend_up)
                or (queue_depth is not None
                    and queue_depth > self.queue_high)
                or rate_hot or latency_hot)
        self._up_hits = self._up_hits + 1 if high else 0
        if (self._up_hits >= self.persistence
                and (self.max_np is None or size < self.max_np)):
            target = size + self.scale_step
            if self.max_np is not None:
                target = min(target, self.max_np)
            if rate_hot or latency_hot:
                reason = (f"serving load rising: "
                          f"request_rate={rate} ({size} replicas, "
                          f"per-replica high {self.rate_high:g}/s) "
                          f"p99={p99}ms (target "
                          f"{self.latency_target_ms:g}ms) for "
                          f"{self._up_hits} observations")
            else:
                reason = (f"load rising: queue_depth={queue_depth} "
                          f"trend={trend} for {self._up_hits} observations")
            return self._acted(now, ScaleDecision(
                SCALE_OUT, reason=reason, target_size=target))

        # 3. Idle → scale in (refused while the restore point is stale).
        if (size > self.min_np and self._idle_since is not None
                and now - self._idle_since >= self.idle_s):
            if stale:
                self.stale_holds += 1
                return ScaleDecision(HOLD, reason=(
                    f"stale-state guard: fleet commit age {commit_age:g}s"
                    f" > {self.commit_max_age_s:g}s "
                    f"(HOROVOD_COMMIT_MAX_AGE_S) — refusing scale_in "
                    f"until the fleet commits"))
            return self._acted(now, ScaleDecision(
                SCALE_IN,
                reason=(f"idle for {now - self._idle_since:.0f}s "
                        f"(no queued work, no cycle progress)"),
                target_size=max(self.min_np, size - self.scale_step)))

        return ScaleDecision(HOLD)
