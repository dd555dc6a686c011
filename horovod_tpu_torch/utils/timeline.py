# Copied from horovod_tpu/utils/timeline.py:1-121 (Timeline, per_rank_filename
# :20); jax-free, the port keeps its own copy; issue-number tags
# are dropped from the comments.
"""Chrome-trace timeline writer.

TPU-native equivalent of the reference's ``horovod/common/timeline.cc``
(SURVEY.md §2a N10): one lane per tensor, with NEGOTIATE / QUEUE /
MEMCPY_IN_FUSION_BUFFER / XLA_ALLREDUCE / ... phase events, activated by
``HOROVOD_TIMELINE=<file>`` and optionally marking coordinator cycles
(``HOROVOD_TIMELINE_MARK_CYCLES``).  Output loads in ``chrome://tracing`` /
Perfetto exactly like the reference's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Union


def per_rank_filename(base: str, rank: Union[int, str]) -> str:
    """THE per-rank suffix scheme for trace/timeline output files.

    Every launch path must produce the same names for the same world —
    ``<base>.<global rank>`` — or the merge tool's glob (``<base>.*``) and
    the docs' examples break on one backend: ``runner/run.py`` suffixes
    with the worker's global rank, ``runner/tpu_vm.py`` with the pod
    worker id (the process's global rank in one-proc-per-host mode), and
    elastic workers suffix at rendezvous time with their assigned rank
    (the launcher cannot know ranks before assignment).
    """
    return f"{base}.{rank}"


class Timeline:
    """Thread-safe Chrome trace-event JSON writer.

    Phases mirror the reference's activity names so existing timeline
    tooling reads both: NEGOTIATE_ALLREDUCE, QUEUE, MEMCPY_IN_FUSION_BUFFER,
    XLA_ALLREDUCE (where the reference says NCCL_ALLREDUCE), etc.
    """

    def __init__(self, filename: str = "", mark_cycles: bool = False):
        self._filename = filename
        self._mark_cycles = mark_cycles
        self._fh = None
        self._lock = threading.Lock()
        self._tids: Dict[str, int] = {}
        self._next_tid = 1
        self._start = time.perf_counter()
        self._pending_first = True
        if filename:
            self._fh = open(filename, "w")
            self._fh.write("[\n")
            self._emit({"name": "process_name", "ph": "M", "pid": 0,
                        "args": {"name": "horovod_tpu coordinator"}})

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def _now_us(self) -> float:
        return (time.perf_counter() - self._start) * 1e6

    def _tid(self, tensor_name: str) -> int:
        tid = self._tids.get(tensor_name)
        if tid is None:
            tid = self._next_tid
            self._next_tid += 1
            self._tids[tensor_name] = tid
            self._emit({"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                        "args": {"name": tensor_name}})
        return tid

    def _emit(self, event: dict):
        if self._fh is None:
            return
        with self._lock:
            if not self._pending_first:
                self._fh.write(",\n")
            self._pending_first = False
            self._fh.write(json.dumps(event))

    def start_activity(self, tensor_name: str, activity: str):
        if self._fh is None:
            return
        self._emit({"name": activity, "ph": "B", "pid": 0,
                    "tid": self._tid(tensor_name), "ts": self._now_us()})

    def end_activity(self, tensor_name: str, activity: str = ""):
        if self._fh is None:
            return
        self._emit({"name": activity, "ph": "E", "pid": 0,
                    "tid": self._tid(tensor_name), "ts": self._now_us()})

    def instant(self, name: str, args: Optional[dict] = None):
        if self._fh is None:
            return
        self._emit({"name": name, "ph": "i", "pid": 0, "tid": 0,
                    "ts": self._now_us(), "s": "g", "args": args or {}})

    def counter(self, name: str, values: dict):
        """Chrome-trace counter track (ph="C"): per-cycle scalar series —
        negotiation microseconds, response-cache hit/miss/invalidation
        counts — rendered as stacked area lanes in Perfetto."""
        if self._fh is None:
            return
        self._emit({"name": name, "ph": "C", "pid": 0,
                    "ts": self._now_us(), "args": values})

    def mark_cycle(self, cycle_index: int):
        if self._fh is None or not self._mark_cycles:
            return
        self.instant("CYCLE_START", {"cycle": cycle_index})

    def close(self):
        if self._fh is None:
            return
        with self._lock:
            self._fh.write("\n]\n")
            self._fh.close()
            self._fh = None
