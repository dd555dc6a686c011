# Copied from horovod_tpu/serve/resilience.py:1-169 (jax-free; the port keeps its own copy).
"""Circuit breaker for the serving front door (no jax, clock-injected).

While a replica is faulted — mid re-rendezvous after a peer death —
every admitted request is doomed to burn its whole deadline in retries.
The breaker converts that into a FAST 503 + ``Retry-After``: callers
learn immediately that the replica is recovering and when to come back,
instead of piling retry load onto a world that is busy healing.

Classic three-state machine, deliberately minimal:

- **closed** — requests flow; ``threshold`` CONSECUTIVE retryable
  failures trip to open (one success resets the streak, so a mixed
  workload never trips on sporadic faults).
- **open** — ``allow()`` refuses everything for ``reset_s`` seconds
  (the front door fast-fails 503 with ``Retry-After`` = the remaining
  window); the clock then half-opens it.
- **half-open** — up to ``probes`` requests are admitted as probes.
  ``probes`` consecutive successes close the breaker (the replica
  healed); ANY failure re-opens it for a fresh ``reset_s``.  A probe
  that terminates with NEITHER verdict (deadline blown, queue full,
  drain race, quarantine — the request's problem, not the replica's)
  must give its slot back via :meth:`~CircuitBreaker.release_probe`;
  as a backstop, probe slots idle for ``reset_s`` are reclaimed by the
  clock so an abandoned probe can never wedge the breaker half-open
  with ``allow()`` refusing forever.

State changes are observable: ``state_code()`` feeds the
``hvd_serve_breaker_state`` gauge (0=closed, 1=open, 2=half-open) and
trips are counted by the front door.  Everything is guarded by one lock
and driven by an injected monotonic clock so the jax-free unit tier can
walk the whole state diagram deterministically.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Gauge encoding for hvd_serve_breaker_state.
STATE_CODES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker guarding one replica's front door."""

    def __init__(self, threshold: int = 5, reset_s: float = 5.0,
                 probes: int = 2,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, int(threshold))
        self.reset_s = max(0.0, float(reset_s))
        self.probes = max(1, int(probes))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive, while closed
        self._successes = 0         # consecutive, while half-open
        self._opened_at = 0.0
        self._probes_out = 0        # admitted-but-unresolved half-open probes
        self._probe_activity_at = 0.0   # last half-open admit/resolve time
        self.trips = 0              # lifetime closed/half-open -> open count

    # ------------------------------------------------------------- queries
    @property
    def state(self) -> str:
        with self._lock:
            self._tick_locked()
            return self._state

    def state_code(self) -> int:
        return STATE_CODES[self.state]

    def retry_after_s(self) -> float:
        """Seconds until the breaker half-opens (0 when not open) — the
        front door's ``Retry-After`` while fast-failing."""
        with self._lock:
            self._tick_locked()
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._opened_at + self.reset_s - self._clock())

    # ------------------------------------------------------------ gatework
    def allow(self) -> bool:
        """May a request proceed right now?  Open → no.  Half-open → yes
        for at most ``probes`` unresolved probes at a time."""
        with self._lock:
            self._tick_locked()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return False
            if self._probes_out >= self.probes:
                return False
            self._probes_out += 1
            self._probe_activity_at = self._clock()
            return True

    def record_success(self) -> None:
        with self._lock:
            self._tick_locked()
            if self._state == HALF_OPEN:
                self._probes_out = max(0, self._probes_out - 1)
                self._probe_activity_at = self._clock()
                self._successes += 1
                if self._successes >= self.probes:
                    self._state = CLOSED
                    self._failures = 0
                    self._successes = 0
                    self._probes_out = 0
            else:
                self._failures = 0

    def record_failure(self) -> None:
        """Record one RETRYABLE failure (terminal per-request errors like
        quarantine or deadline are the request's problem, not the
        replica's — callers must not feed them here)."""
        with self._lock:
            self._tick_locked()
            if self._state == HALF_OPEN:
                self._trip_locked()
            elif self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.threshold:
                    self._trip_locked()
            # OPEN: late losers of an already-tripped window change nothing.

    def release_probe(self) -> None:
        """Give back a half-open probe slot whose request terminated with
        NEITHER verdict — deadline blown, queue full, drain race,
        quarantine: the request's problem, not the replica's, so it says
        nothing about heal.  Without the release, ``probes`` such
        outcomes would pin ``_probes_out`` at the cap and ``allow()``
        would refuse forever (504-on-probe is the COMMON case while the
        replica is still re-rendezvousing)."""
        with self._lock:
            self._tick_locked()
            if self._state == HALF_OPEN and self._probes_out > 0:
                self._probes_out -= 1
                self._probe_activity_at = self._clock()

    # ------------------------------------------------------------ internal
    def _trip_locked(self) -> None:
        self._state = OPEN
        self._opened_at = self._clock()
        self._failures = 0
        self._successes = 0
        self._probes_out = 0
        self.trips += 1

    def _tick_locked(self) -> None:
        now = self._clock()
        if self._state == OPEN and now - self._opened_at >= self.reset_s:
            self._state = HALF_OPEN
            self._successes = 0
            self._probes_out = 0
            self._probe_activity_at = now
        elif self._state == HALF_OPEN and self._probes_out > 0 and \
                self.reset_s > 0 and \
                now - self._probe_activity_at >= self.reset_s:
            # Backstop for a probe holder that died without releasing:
            # a slot idle past reset_s is reclaimed so half-open can
            # never wedge with allow() refusing forever.
            self._probes_out = 0
            self._successes = 0
            self._probe_activity_at = now
