# Copied from horovod_tpu/trace/__main__.py:1-112 (the CLI); jax-free, the port
# keeps its own copy; the CLI's name is the port's.
"""``python -m horovod_tpu_torch.trace`` — merge per-rank trace files into one
perfetto/chrome trace, and report the critical path (no jax required).

Usage::

    # merge explicit per-rank files
    python -m horovod_tpu_torch.trace /tmp/tr.0 /tmp/tr.1 -o merged.json

    # or give the filename base the launcher suffixed (globs <base>.*)
    python -m horovod_tpu_torch.trace /tmp/tr -o merged.json

    # critical-path report instead of (or as well as) the merged file
    python -m horovod_tpu_torch.trace /tmp/tr --report

    # digest-level lanes from a monitor /snapshot dump (no trace files
    # needed — the MON1 side-channel already shipped per-cycle digests)
    python -m horovod_tpu_torch.trace --from-snapshot snap.json -o merged.json

Open the merged file in https://ui.perfetto.dev or ``chrome://tracing``:
one lane per rank, flow arrows tying each negotiation cycle across ranks.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .analyze import render_report
from .merge import (expand_inputs, load_trace_file, merge_snapshot,
                    merge_traces, write_chrome_trace)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.trace",
        description="Merge per-rank horovod_tpu trace files into one "
                    "perfetto/chrome trace with cross-rank cycle flows")
    p.add_argument("inputs", nargs="*",
                   help="per-rank trace files, or a filename base to glob "
                        "(<base>.<rank>)")
    p.add_argument("-o", "--output", default=None,
                   help="merged chrome-trace JSON path (default: "
                        "<first input>.merged.json)")
    p.add_argument("--from-snapshot", metavar="FILE", default=None,
                   help="build digest-level lanes from a monitor /snapshot "
                        "JSON dump instead of trace files")
    p.add_argument("--report", action="store_true",
                   help="print the critical-path phase report")
    p.add_argument("--report-cycles", type=int, default=20, metavar="N",
                   help="cycles shown in the report table (default 20)")
    args = p.parse_args(argv)
    if bool(args.inputs) == bool(args.from_snapshot):
        p.error("pass per-rank trace files (or a base), or --from-snapshot")

    if args.from_snapshot:
        try:
            with open(args.from_snapshot) as fh:
                dump = json.load(fh)
        except (OSError, ValueError) as exc:
            print(f"error: could not read {args.from_snapshot}: {exc}",
                  file=sys.stderr)
            return 1
        merged = merge_snapshot(dump)
        if not merged["traceEvents"]:
            print("error: snapshot carries no trace digests (was tracing "
                  "armed with HOROVOD_TRACE and HOROVOD_MONITOR=1?)",
                  file=sys.stderr)
            return 1
        out = args.output or (args.from_snapshot + ".merged.json")
        write_chrome_trace(merged, out)
        print(f"wrote {out} ({len(merged['traceEvents'])} events, "
              f"digest-level)")
        return 0

    try:
        paths = expand_inputs(args.inputs)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    by_rank = {}
    for path in paths:
        try:
            rt = load_trace_file(path)
        except (OSError, ValueError) as exc:
            print(f"error: could not parse {path}: {exc}", file=sys.stderr)
            return 1
        prev = by_rank.get(rt.rank)
        if prev is not None:
            print(f"warning: duplicate rank {rt.rank} ({prev.path} and "
                  f"{rt.path}); using the later file", file=sys.stderr)
        by_rank[rt.rank] = rt
    ranks = [by_rank[r] for r in sorted(by_rank)]
    if args.report:
        print(render_report(ranks, max_cycles=args.report_cycles))
    if args.output or not args.report:
        merged = merge_traces(ranks)
        out = args.output or (paths[0] + ".merged.json")
        write_chrome_trace(merged, out)
        flows = sum(1 for e in merged["traceEvents"]
                    if e.get("ph") in ("s", "t", "f"))
        print(f"wrote {out} ({len(ranks)} rank lane(s), "
              f"{len(merged['traceEvents'])} events, {flows} flow points)")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:     # |head closed stdout — not an error
        sys.exit(0)
