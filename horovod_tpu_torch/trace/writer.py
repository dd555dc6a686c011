# Copied from horovod_tpu/trace/writer.py:1-109 (TraceWriter); jax-free, the
# port keeps its own copy.
"""Per-rank trace file writer (no jax imports).

One JSONL file per rank (``HOROVOD_TRACE``; the launcher suffixes the base
with the rank, the same ``utils.timeline.per_rank_filename`` scheme the
chrome timeline uses).  Line kinds:

- header  ``{"k":"h","rank":r,"anchor_wall":...,"anchor_mono":...,"v":1}``
  — the wall/monotonic anchor pair the merge tool uses to put every rank's
  monotonic stamps on one shared time base;
- span    ``{"k":"s","n":name,"c":cycle,"slot":s,"e":...,"d":...,"r":...,
  "l":...,"x":...,"f":...,"err":0|1}`` — the six lifecycle stamps
  (enqueue, drain, ready, launch, result, finished), monotonic seconds;
- cycle   ``{"k":"c","c":cycle,"t0":...,"td":...,"tr":...,"tx":...,
  "n":count,"neg":us}``.

Writes are lock-guarded and flushed on a small line budget so a crashed
rank still leaves a usable file; ``close`` flushes the rest.  Every write
failure disables the writer (tracing must never take training down).
"""

from __future__ import annotations

import json
import threading

from ..utils.logging import get_logger

log = get_logger()

_FLUSH_EVERY = 64


class TraceWriter:
    """Append-only JSONL emitter for one rank's spans and cycles."""

    def __init__(self, filename: str, rank: int = 0):
        self.filename = filename
        self.rank = int(rank)
        self._lock = threading.Lock()
        self._pending = 0
        try:
            self._fh = open(filename, "w")
        except OSError as exc:
            log.warning("trace: cannot open %s (%s); file output disabled",
                        filename, exc)
            self._fh = None

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def _emit(self, obj: dict) -> None:
        with self._lock:
            if self._fh is None:
                return
            try:
                self._fh.write(json.dumps(obj, separators=(",", ":")) + "\n")
                self._pending += 1
                if self._pending >= _FLUSH_EVERY:
                    self._fh.flush()
                    self._pending = 0
            except OSError:
                log.exception("trace: write failed; disabling file output")
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def header(self, rank: int, anchor_wall: float,
               anchor_mono: float) -> None:
        self._emit({"k": "h", "v": 1, "rank": rank,
                    "anchor_wall": anchor_wall, "anchor_mono": anchor_mono})

    def span_record(self, name, cycle, slot, t_enqueue, t_drain, t_ready,
                    t_launch, t_result, t_done, error,
                    cross_frac: float = 0.0) -> None:
        """One span line from an already-snapshotted field tuple (the
        recorder snapshots under its lock BEFORE marking the ring slot
        reclaimable — passing the live span object here would race its
        recycling).  Stamp keys follow ``core.STAMPS`` order.  ``cf``
        (modeled DCN share of the reduce phase, two-level dispatches
        only) is omitted for flat spans — old readers never see it and
        flat trace files pay zero extra bytes."""
        obj = {"k": "s", "n": name, "c": cycle, "slot": slot,
               "e": round(t_enqueue, 7), "d": round(t_drain, 7),
               "r": round(t_ready, 7), "l": round(t_launch, 7),
               "x": round(t_result, 7), "f": round(t_done, 7),
               "err": 1 if error else 0}
        if cross_frac:
            obj["cf"] = round(cross_frac, 4)
        self._emit(obj)

    def cycle(self, rec) -> None:
        self._emit({"k": "c", "c": rec.cycle, "t0": round(rec.t0, 7),
                    "td": round(rec.t_drain, 7), "tr": round(rec.t_ready, 7),
                    "tx": round(rec.t_dispatch, 7), "n": rec.n_tensors,
                    "neg": round(rec.negotiation_us, 1)})

    def close(self) -> None:
        with self._lock:
            if self._fh is None:
                return
            try:
                self._fh.flush()
                self._fh.close()
            except OSError:
                pass
            self._fh = None
