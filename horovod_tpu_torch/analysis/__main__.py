# Copied from horovod_tpu/analysis/__main__.py:1-181 (jax-free; the port keeps its own copy).
"""CLI: ``python -m horovod_tpu_torch.analysis [paths...]``.

Lints the given files/directories for deadlock-prone collective patterns
and prints findings with severity and fix hints.  ``--whole-package``
additionally runs the two-pass interprocedural analysis (call-graph
rank-guard propagation, cross-module HVD102/HVD103 facts, HVD108/HVD109
schedule checks) over the whole file set.

Exit status (CI contract):
  0  clean (or warnings only, unless ``--strict``)
  1  error-severity findings (with ``--baseline``: NEW findings of any
     severity)
  2  usage errors (bad paths, bad flags)
  3  the analyzer itself crashed — distinct from lint failures so CI
     consumers can page the analyzer's owners instead of the author of
     the change under test

The lint layer is pure AST analysis: nothing is executed, no runtime is
initialized and no device is touched — safe to run in CI.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

from .findings import RULES, summarize

EXIT_CLEAN, EXIT_FINDINGS, EXIT_USAGE, EXIT_INTERNAL = 0, 1, 2, 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="Static collective-correctness linter for horovod_tpu_torch "
                    "training scripts.")
    ap.add_argument("paths", nargs="*",
                    help="Python files or directories to lint")
    ap.add_argument("--whole-package", action="store_true",
                    help="two-pass interprocedural mode: call-graph "
                         "rank-guard propagation, cross-module facts, "
                         "HVD108/HVD109 schedule checks")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--sarif", metavar="FILE",
                    help="write findings as SARIF 2.1.0 to FILE (for CI "
                         "annotation); with --baseline, only NEW findings")
    ap.add_argument("--baseline", metavar="FILE",
                    help="subtract the baseline file: only findings not "
                         "listed there count (and fail the exit status)")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="write the current findings to FILE as a baseline "
                         "and exit 0")
    ap.add_argument("--emit-static-index", metavar="FILE",
                    help="(whole-package) write the call-site -> static "
                         "call-graph node map consumed by "
                         "HVD_TPU_SANITIZER_STATIC_INDEX")
    ap.add_argument("--root", default=None,
                    help="repo root for relative paths in SARIF/baseline "
                         "output (default: common prefix of the inputs)")
    ap.add_argument("--no-fix-hints", action="store_true",
                    help="omit fix guidance lines")
    ap.add_argument("--disable", default="",
                    help="comma-separated rule IDs to ignore (e.g. "
                         "HVD105,HVD103)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in RULES.values():
            print(f"{rule.id} [{rule.severity.value}] {rule.title}")
            print(f"    {rule.rationale}")
            print(f"    fix: {rule.fix_hint}")
        return EXIT_CLEAN

    if not args.paths:
        ap.print_usage()
        return EXIT_USAGE

    disabled = {s.strip().upper() for s in args.disable.split(",")
                if s.strip()}
    if args.root is None and (args.baseline or args.write_baseline
                              or args.sarif):
        # The documented default: baselines/SARIF must be portable across
        # checkouts, so relativize against the inputs' common prefix.
        common = os.path.commonpath([os.path.abspath(p)
                                     for p in args.paths])
        args.root = common if os.path.isdir(common) \
            else os.path.dirname(common)
    try:
        if args.whole_package:
            from .whole_package import analyze_package, build_package, \
                build_static_index
            pkg = build_package(args.paths)
            findings = analyze_package(args.paths, package=pkg)
            if args.emit_static_index:
                index = build_static_index(args.paths, package=pkg,
                                           findings=findings)
                with open(args.emit_static_index, "w",
                          encoding="utf-8") as fh:
                    json.dump(index, fh, indent=2, sort_keys=True)
        else:
            from .collective_lint import lint_paths
            findings = lint_paths(args.paths)
            if args.emit_static_index:
                print("error: --emit-static-index requires --whole-package",
                      file=sys.stderr)
                return EXIT_USAGE
        findings = [f for f in findings if f.rule not in disabled]
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE
    except Exception:  # noqa: BLE001 - CI contract: crashes are NOT findings
        print("internal error: the analyzer crashed (exit 3); this is an "
              "analyzer bug, not a finding in the code under test",
              file=sys.stderr)
        traceback.print_exc()
        return EXIT_INTERNAL

    try:
        if args.write_baseline:
            from .baseline import write_baseline
            write_baseline(findings, args.write_baseline, root=args.root)
            print(f"wrote baseline with {len(findings)} finding(s) to "
                  f"{args.write_baseline}")
            return EXIT_CLEAN

        baselined = 0
        stale = []
        if args.baseline:
            from .baseline import diff_baseline, load_baseline
            diff = diff_baseline(findings, load_baseline(args.baseline),
                                 root=args.root)
            baselined, stale = len(diff.matched), diff.stale
            findings = diff.new

        if args.sarif:
            from .sarif import write_sarif
            write_sarif(findings, args.sarif, root=args.root)
    except Exception:  # noqa: BLE001
        print("internal error: the analyzer crashed (exit 3)",
              file=sys.stderr)
        traceback.print_exc()
        return EXIT_INTERNAL

    if args.json:
        print(json.dumps([{
            "rule": f.rule, "severity": f.severity.value, "path": f.path,
            "line": f.line, "col": f.col, "message": f.message,
            "fix_hint": f.fix_hint,
        } for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render(show_fix=not args.no_fix_hints))
        tail = summarize(findings)
        if args.baseline:
            tail += f" (+{baselined} baselined)"
            if stale:
                tail += f"; {len(stale)} stale baseline entr" + \
                    ("y" if len(stale) == 1 else "ies") + \
                    " no longer fire(s): " + \
                    ", ".join(f"{r}@{p}:{ln}" for r, p, ln in stale[:5])
        print(tail)

    if args.baseline:
        return EXIT_FINDINGS if findings else EXIT_CLEAN
    if any(f.is_error for f in findings):
        return EXIT_FINDINGS
    if args.strict and findings:
        return EXIT_FINDINGS
    return EXIT_CLEAN


if __name__ == "__main__":
    sys.exit(main())
