# Copied from horovod_tpu/trace/merge.py:1-214 (load_trace_file, merge_traces,
# merge_snapshot); jax-free, the port keeps its own copy.
"""Cross-rank trace merge: per-rank JSONL files -> one perfetto/chrome
trace (no jax imports).

Replaces eyeballing N per-rank ``HOROVOD_TIMELINE`` files: the merged view
has **one lane (process group) per rank** — a ``cycles`` thread carrying the
coordinator cycles and one thread per tensor carrying its five lifecycle
phases — plus **flow arrows tying the same negotiation cycle across
ranks** (chrome ``ph:"s"/"t"/"f"`` flow events keyed on the cycle id, the
cross-rank correlation key the spans were stamped with).

Time base: each rank's file carries a (wall, monotonic) anchor pair; every
monotonic stamp is mapped to wall time and the fleet minimum is subtracted,
so skew between hosts is bounded by wall-clock sync (the flow arrows keep
cycles correlated regardless).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from .core import PHASES, STAMPS


class RankTrace:
    """One rank's parsed trace file."""

    def __init__(self, rank: int, anchor_wall: float, anchor_mono: float,
                 spans: List[dict], cycles: List[dict], path: str = ""):
        self.rank = rank
        self.anchor_wall = anchor_wall
        self.anchor_mono = anchor_mono
        self.spans = spans
        self.cycles = cycles
        self.path = path

    def to_wall(self, t_mono: float) -> float:
        return self.anchor_wall + (t_mono - self.anchor_mono)


def load_trace_file(path: str) -> RankTrace:
    """Parse one per-rank JSONL trace file (header + span/cycle lines)."""
    rank, aw, am = 0, 0.0, 0.0
    spans: List[dict] = []
    cycles: List[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            kind = obj.get("k")
            if kind == "h":
                rank = int(obj.get("rank", 0))
                aw = float(obj.get("anchor_wall", 0.0))
                am = float(obj.get("anchor_mono", 0.0))
            elif kind == "s":
                spans.append(obj)
            elif kind == "c":
                cycles.append(obj)
    return RankTrace(rank, aw, am, spans, cycles, path=path)


def expand_inputs(inputs: List[str]) -> List[str]:
    """Resolve CLI inputs: existing files pass through; anything else is
    treated as a per-rank filename base and globbed — strictly
    ``<base>.<rank>`` with a NUMERIC rank suffix (the launcher's scheme),
    so a previous merge's ``<base>.0.merged.json`` output sitting next to
    the per-rank files can never be swallowed as a rank trace."""
    out: List[str] = []
    for inp in inputs:
        if os.path.isfile(inp):
            out.append(inp)
            continue
        matches = [m for m in glob.glob(inp + ".*")
                   if os.path.isfile(m) and m[len(inp) + 1:].isdigit()]
        matches.sort(key=lambda m: int(m[len(inp) + 1:]))
        if not matches:
            raise FileNotFoundError(
                f"no trace file or per-rank files matching {inp!r} "
                f"(expected {inp} or {inp}.<rank>)")
        out.extend(matches)
    return out


def merge_traces(ranks: List[RankTrace]) -> dict:
    """Build the merged chrome-trace object from parsed rank traces."""
    events: List[dict] = []
    if not ranks:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    base = min(r.anchor_wall for r in ranks if r.anchor_wall) \
        if any(r.anchor_wall for r in ranks) else 0.0

    def ts(rt: RankTrace, t_mono: float) -> float:
        return max(0.0, (rt.to_wall(t_mono) - base) * 1e6)

    # cycle id -> [(rank, start_us)] for the flow arrows.
    cycle_sites: Dict[int, List[tuple]] = {}
    for rt in sorted(ranks, key=lambda r: r.rank):
        pid = rt.rank
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"rank {pid}"}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": "cycles"}})
        for c in rt.cycles:
            t0, tx = c.get("t0", 0.0), c.get("tx", 0.0)
            if not t0:
                continue
            start = ts(rt, t0)
            dur = max(0.1, (tx - t0) * 1e6) if tx else 0.1
            events.append({
                "name": f"cycle {c['c']}", "ph": "X", "pid": pid, "tid": 0,
                "ts": round(start, 3), "dur": round(dur, 3),
                "args": {"cycle": c["c"], "tensors": c.get("n", 0),
                         "negotiation_us": c.get("neg", 0)}})
            cycle_sites.setdefault(int(c["c"]), []).append((pid, start))
        tids: Dict[str, int] = {}
        for s in rt.spans:
            name = s.get("n", "?")
            tid = tids.get(name)
            if tid is None:
                tid = tids[name] = len(tids) + 1
                events.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": tid, "args": {"name": name}})
            stamps = [s.get(k, 0.0) for k in STAMPS]
            for i, phase in enumerate(PHASES):
                a, b = stamps[i], stamps[i + 1]
                if not a or not b or b < a:
                    continue
                events.append({
                    "name": phase.upper(), "ph": "X", "pid": pid, "tid": tid,
                    "ts": round(ts(rt, a), 3),
                    "dur": round(max(0.1, (b - a) * 1e6), 3),
                    "args": {"cycle": s.get("c", -1),
                             "slot": s.get("slot", -1)}})

    _emit_cycle_flows(events, cycle_sites)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _emit_cycle_flows(events: List[dict],
                      cycle_sites: Dict[int, List[tuple]]) -> None:
    """Flow arrows tying one cycle id across rank lanes: chained in rank
    order (``s`` -> ``t``... -> ``f``), anchored just inside each rank's
    cycle slice.  Shared by the span-level and digest-level mergers so
    the flow semantics cannot drift between them."""
    for cid, sites in sorted(cycle_sites.items()):
        if len(sites) < 2:
            continue
        sites.sort()
        for i, (pid, start) in enumerate(sites):
            ph = "s" if i == 0 else ("f" if i == len(sites) - 1 else "t")
            ev = {"name": "cycle", "cat": "cycle", "ph": ph, "id": cid,
                  "pid": pid, "tid": 0, "ts": round(start + 0.05, 3)}
            if ph == "f":
                ev["bp"] = "e"
            events.append(ev)


def merge_snapshot(dump: dict) -> dict:
    """Digest-level merge from a monitor ``/snapshot`` dump: each rank's
    MON1 trace digest becomes a lane of per-cycle phase-stacked slices.

    No absolute timestamps exist at digest level, so cycles are laid out on
    a synthetic time axis (cycle id spacing = the fleet's max per-cycle
    phase sum) — phase *attribution* is exact, alignment is by cycle id.
    """
    table = dump.get("table", {})
    per_rank: Dict[int, dict] = {}
    for r, snap in table.items():
        tr = (snap or {}).get("trace")
        if tr and tr.get("cycles"):
            per_rank[int(r)] = tr
    events: List[dict] = []
    if not per_rank:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    # Synthetic axis: slot width fits the largest cycle anywhere.
    width = 1.0
    for tr in per_rank.values():
        for row in tr["cycles"]:
            width = max(width, float(sum(row[2:])))
    width *= 1.25
    cycle_ids = sorted({row[0] for tr in per_rank.values()
                        for row in tr["cycles"]})
    offset = {cid: i * width for i, cid in enumerate(cycle_ids)}
    cycle_sites: Dict[int, List[tuple]] = {}
    for rank in sorted(per_rank):
        tr = per_rank[rank]
        events.append({"name": "process_name", "ph": "M", "pid": rank,
                       "args": {"name": f"rank {rank} (digest)"}})
        events.append({"name": "thread_name", "ph": "M", "pid": rank,
                       "tid": 0, "args": {"name": "cycles"}})
        for row in tr["cycles"]:
            cid, n = int(row[0]), int(row[1])
            start = offset[cid]
            cursor = start
            for phase, us in zip(PHASES, row[2:]):
                if us <= 0:
                    continue
                events.append({
                    "name": phase.upper(), "ph": "X", "pid": rank, "tid": 0,
                    "ts": round(cursor, 3), "dur": round(float(us), 3),
                    "args": {"cycle": cid, "tensors": n}})
                cursor += float(us)
            cycle_sites.setdefault(cid, []).append((rank, start))
    _emit_cycle_flows(events, cycle_sites)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(trace: dict, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(trace, fh)
