# Copied from horovod_tpu/elastic/registration.py:1-73 (jax-free; the port keeps its own copy).
"""Worker result registry + host blacklist for the elastic driver.

Parity: reference ``horovod/runner/elastic/registration.py``
(``WorkerStateRegistry``) — records each worker's terminal state per
generation and blacklists hosts that produced failures so rank
re-assignment skips them (SURVEY.md §3.4 driver side).
"""

from __future__ import annotations

import threading
from typing import Dict, Set

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"
# Clean departure (drain → LEAVE → exit 0, or a driver-released identity):
# terminal like SUCCESS/FAILURE, but it is neither a job-completion signal
# nor a blacklisting failure — the host stays schedulable.
LEFT = "LEFT"


class WorkerStateRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._states: Dict[str, str] = {}       # identity -> state
        self._blacklist: Set[str] = set()       # hostnames
        self._failures: Dict[str, int] = {}     # hostname -> count

    def record_ready(self, identity: str):
        with self._lock:
            self._states[identity] = READY

    def record_success(self, identity: str):
        with self._lock:
            self._states[identity] = SUCCESS

    def record_failure(self, identity: str):
        host = identity.rsplit(":", 1)[0]
        with self._lock:
            self._states[identity] = FAILURE
            self._failures[host] = self._failures.get(host, 0) + 1
            self._blacklist.add(host)

    def record_left(self, identity: str):
        """Clean-exit classification: a worker that exited 0 because the
        driver drained it (autoscale scale-in / straggler evict → clean
        LEAVE) or released it (host removed from a generation).  NOT a
        success — it must not end the job — and NOT a failure: the host
        is never blacklisted for an orderly departure, so it stays
        eligible for a later scale-out."""
        with self._lock:
            self._states[identity] = LEFT

    def state_of(self, identity: str) -> str:
        with self._lock:
            return self._states.get(identity, "")

    def is_blacklisted(self, hostname: str) -> bool:
        with self._lock:
            return hostname in self._blacklist

    def blacklist(self) -> Set[str]:
        with self._lock:
            return set(self._blacklist)

    def failure_count(self, hostname: str) -> int:
        with self._lock:
            return self._failures.get(hostname, 0)

    def success_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._states.values() if s == SUCCESS)
