# Copied from horovod_tpu/trace/analyze.py:1-185 (critical_path, phase_summary,
# render_report); jax-free, the port keeps its own copy.
"""Critical-path analysis over merged spans (no jax imports).

Answers the question the ROADMAP's small-message latency war needs answered
before any fix can claim credit: *which host-side phase eats the cycle*.
Given one or more ranks' parsed traces (``merge.RankTrace``), attributes
per-cycle wall time to the five lifecycle phases, fleet-wide:

- **per-phase summary** — count/mean/total microseconds per phase across
  every committed span (per rank and fleet);
- **per-cycle critical path** — for each negotiation cycle present on every
  rank, the *slowest* rank's phase breakdown (that rank gates the lock-step
  round, so its phases ARE the cycle's critical path), plus which rank it
  was;
- **attribution totals** — summing the critical-path breakdown over cycles:
  the microseconds each phase contributed to the run's wall time, the
  number a latency PR must move.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .core import PHASES, REDUCE_LEGS, STAMPS, phases_from_stamps


def _span_phases_us(span: dict) -> Dict[str, float]:
    """Phase durations from a span line's stamps — the SAME carry-forward
    rule the live recorder applies (core.phases_from_stamps), so offline
    reports agree with the MON1 digests on partially stamped spans."""
    return phases_from_stamps([span.get(k, 0.0) for k in STAMPS])


def _span_legs_us(span: dict, reduce_us: float) -> Optional[Dict[str, float]]:
    """ICI/DCN split of a span's reduce phase, from the ``cf`` key the
    engine stamps on two-level dispatches (the modeled DCN share —
    core.REDUCE_LEGS).  None for flat spans, so leg totals attribute only
    the time the two-level path actually ran."""
    frac = float(span.get("cf", 0.0) or 0.0)
    if frac <= 0.0:
        return None
    return {REDUCE_LEGS[0]: reduce_us * (1.0 - frac),
            REDUCE_LEGS[1]: reduce_us * frac}


def phase_summary(ranks: List) -> dict:
    """Fleet + per-rank per-phase mean/total microseconds.

    When any span rode the two-level data plane, a ``legs`` block splits
    the fleet's reduce time into intra-slice (ICI) and cross-slice (DCN)
    legs — the number the crossover-picking workflow reads (DCN time is
    what a bigger HOROVOD_HIER_THRESHOLD trades against phase latency)."""
    fleet = {p: [0.0, 0] for p in PHASES}        # sum, count
    legs = {p: [0.0, 0] for p in REDUCE_LEGS}
    per_rank: Dict[int, dict] = {}
    for rt in ranks:
        mine = {p: [0.0, 0] for p in PHASES}
        for s in rt.spans:
            phases = _span_phases_us(s)
            for p, us in phases.items():
                mine[p][0] += us
                mine[p][1] += 1
                fleet[p][0] += us
                fleet[p][1] += 1
            ls = _span_legs_us(s, phases["reduce"])
            if ls is not None:
                for p, us in ls.items():
                    legs[p][0] += us
                    legs[p][1] += 1
        per_rank[rt.rank] = {
            p: {"total_us": round(v[0], 1),
                "mean_us": round(v[0] / v[1], 2) if v[1] else None}
            for p, v in mine.items()}
    out = {
        "fleet": {p: {"total_us": round(v[0], 1),
                      "mean_us": round(v[0] / v[1], 2) if v[1] else None,
                      "spans": v[1]}
                  for p, v in fleet.items()},
        "per_rank": per_rank,
    }
    if any(v[1] for v in legs.values()):
        out["legs"] = {p: {"total_us": round(v[0], 1),
                           "mean_us": round(v[0] / v[1], 2) if v[1] else None,
                           "spans": v[1]}
                       for p, v in legs.items()}
    return out


def critical_path(ranks: List, max_cycles: Optional[int] = None) -> dict:
    """Per-cycle critical-path attribution.

    For every cycle id seen on *all* ranks: per rank, sum that cycle's span
    phases; the critical rank is the one with the largest phase sum (it
    gated the lock-step round).  Returns the per-cycle rows plus the
    attribution totals over the critical rank's phases."""
    if not ranks:
        return {"cycles": [], "attributed_us": None, "slowest_counts": {}}
    # rank -> cycle -> phase sums
    by_rank: Dict[int, Dict[int, Dict[str, float]]] = {}
    for rt in ranks:
        table: Dict[int, Dict[str, float]] = {}
        for s in rt.spans:
            cid = int(s.get("c", -1))
            if cid < 0:
                continue
            agg = table.setdefault(cid, {p: 0.0 for p in PHASES})
            for p, us in _span_phases_us(s).items():
                agg[p] += us
        by_rank[rt.rank] = table
    common = None
    for table in by_rank.values():
        ids = set(table)
        common = ids if common is None else (common & ids)
    common = sorted(common or [])
    if max_cycles:
        common = common[-max_cycles:]
    rows = []
    attributed = {p: 0.0 for p in PHASES}
    slowest_counts: Dict[int, int] = {}
    for cid in common:
        slow_rank, slow_total, slow_phases = None, -1.0, None
        for rank, table in by_rank.items():
            phases = table[cid]
            total = sum(phases.values())
            if total > slow_total:
                slow_rank, slow_total, slow_phases = rank, total, phases
        rows.append({"cycle": cid, "slowest_rank": slow_rank,
                     "total_us": round(slow_total, 1),
                     "phases_us": {p: round(v, 1)
                                   for p, v in slow_phases.items()}})
        slowest_counts[slow_rank] = slowest_counts.get(slow_rank, 0) + 1
        for p, v in slow_phases.items():
            attributed[p] += v
    return {
        "cycles": rows,
        "attributed_us": {p: round(v, 1) for p, v in attributed.items()},
        "slowest_counts": slowest_counts,
    }


def render_report(ranks: List, max_cycles: int = 20) -> str:
    """Human-readable critical-path report for the CLI (``--report``)."""
    summary = phase_summary(ranks)
    cp = critical_path(ranks)
    lines: List[str] = []
    lines.append(f"ranks: {sorted(rt.rank for rt in ranks)}   spans: "
                 f"{sum(len(rt.spans) for rt in ranks)}   common cycles: "
                 f"{len(cp['cycles'])}")
    lines.append("")
    lines.append("fleet per-phase means (us):")
    header = "  " + "".join(f"{p:>14}" for p in PHASES)
    lines.append(header)
    lines.append("  " + "".join(
        f"{(summary['fleet'][p]['mean_us'] or 0):>14.2f}" for p in PHASES))
    legs = summary.get("legs")
    if legs:
        lines.append("")
        lines.append("two-level reduce legs (ICI vs DCN, modeled split):")
        for p in REDUCE_LEGS:
            v = legs[p]
            link = "ICI" if p == REDUCE_LEGS[0] else "DCN"
            lines.append(f"  {p:>14}  {v['total_us']:>12.1f} us total  "
                         f"{(v['mean_us'] or 0):>10.2f} us mean  [{link}]")
    att = cp["attributed_us"]
    if att:
        total = sum(att.values()) or 1.0
        lines.append("")
        lines.append("critical-path attribution (slowest rank per cycle):")
        for p in PHASES:
            pct = 100.0 * att[p] / total
            bar = "#" * int(round(pct / 2))
            lines.append(f"  {p:>12}  {att[p]:>12.1f} us  {pct:5.1f}%  {bar}")
        lines.append(f"  {'total':>12}  {total:>12.1f} us")
        counts = ", ".join(f"rank {r}: {n}" for r, n in
                           sorted(cp["slowest_counts"].items()))
        lines.append(f"  slowest-rank counts: {counts}")
    if cp["cycles"]:
        lines.append("")
        lines.append(f"last {min(max_cycles, len(cp['cycles']))} cycles "
                     f"(slowest rank, us):")
        lines.append("  cycle  rank  " + "".join(f"{p:>12}" for p in PHASES))
        for row in cp["cycles"][-max_cycles:]:
            lines.append(
                f"  {row['cycle']:>5}  {row['slowest_rank']:>4}  " + "".join(
                    f"{row['phases_us'][p]:>12.1f}" for p in PHASES))
    return "\n".join(lines)
