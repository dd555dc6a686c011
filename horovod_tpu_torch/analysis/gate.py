# Copied from horovod_tpu/analysis/gate.py:1-172 (jax-free; the port keeps its own copy).
"""The whole-package self-lint CI gate of the port.

Runs the two-pass interprocedural analyzer over the port's own
``horovod_tpu_torch/`` tree (its examples are inside it), subtracts the
reviewed baseline (``horovod_tpu_torch/analysis/lint_baseline.json``), and
exits nonzero on any NEW
finding — error or warning severity alike, because a silent warning creep
is exactly what a baseline is for.  Stale baseline entries (code fixed,
lines moved) are reported so the file shrinks over time; the tier-1 suite
(``tests/test_torch_lint_self.py``) asserts both "no new findings" and "no
stale entries", and that the baseline holds no error.  ``chip_smoke.py`` is
outside the gate: ``DistributedOptimizer(check="strict")`` lints it where it
runs.

Invocations:
  python -m horovod_tpu_torch.analysis.gate          # the gate
  python -m horovod_tpu_torch.analysis.gate --update-baseline
                                            # re-baseline after review
  python -m horovod_tpu_torch.analysis.gate \
      --explain HVD108:horovod_tpu_torch/x.py:42   # why did this fire?

``--explain RULE:path:line`` re-runs the analyzer and prints the full
story behind one finding — the interprocedural call chain and the
resolved process-set values — so deciding whether to baseline it stops
requiring a debugger.

Exit status: 0 gate passes, 1 new findings, 3 analyzer crash (matching
``python -m horovod_tpu_torch.analysis`` CI contract).
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCOPE = ("horovod_tpu_torch",)
BASELINE = os.path.join("horovod_tpu_torch", "analysis", "lint_baseline.json")


def run_gate(root: str = REPO_ROOT, update_baseline: bool = False,
             sarif: str | None = None, quiet: bool = False):
    """Returns (new_findings, stale_keys, baselined_count)."""
    from .baseline import diff_baseline, load_baseline, write_baseline
    from .whole_package import analyze_package

    paths = [os.path.join(root, p) for p in SCOPE
             if os.path.exists(os.path.join(root, p))]
    baseline_path = os.path.join(root, BASELINE)
    findings = analyze_package(paths)

    if update_baseline:
        write_baseline(findings, baseline_path, root=root)
        if not quiet:
            print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return [], [], len(findings)

    diff = diff_baseline(findings, load_baseline(baseline_path), root=root)
    if sarif:
        from .sarif import write_sarif
        write_sarif(diff.new, sarif, root=root)
    return diff.new, diff.stale, len(diff.matched)


def explain(spec: str, root: str = REPO_ROOT, quiet: bool = False) -> int:
    """``--explain RULE:path:line``: print the interprocedural chain and
    resolved process-set values behind one finding.  Returns 0 when the
    finding exists, 1 when nothing at that key fires."""
    from .whole_package import analyze_package
    from .baseline import _rel

    try:
        rule, rest = spec.split(":", 1)
        path, line_s = rest.rsplit(":", 1)
        line = int(line_s)
    except ValueError:
        print(f"error: --explain wants RULE:path:line, got {spec!r}",
              file=sys.stderr)
        return 2

    paths = [os.path.join(root, p) for p in SCOPE
             if os.path.exists(os.path.join(root, p))]
    findings = analyze_package(paths)
    # Match the finding's repo-relative path by suffix, so both
    # "horovod_tpu_torch/x.py" and a bare "x.py" select the site.
    rel_want = path.replace(os.sep, "/").lstrip("./")
    hits = [f for f in findings
            if f.rule == rule and f.line == line
            and _rel(f.path, root).lstrip("/").endswith(rel_want)]
    if not hits:
        if not quiet:
            print(f"no {rule} finding at {path}:{line} "
                  f"(the analyzer reports {len(findings)} finding(s) "
                  f"package-wide)")
        return 1
    for f in hits:
        print(f.render())
        if f.process_set:
            print(f"  process set(s): {f.process_set}")
        if f.chain:
            print("  call chain:")
            for hop in f.chain:
                print(f"    {hop}")
        if f.related:
            print("  related collective sites:")
            for rp, rl in f.related:
                print(f"    {_rel(rp, root).lstrip('/')}:{rl}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis.gate",
        description="Whole-package collective-correctness self-lint gate "
                    "(horovod_tpu_torch/ vs the reviewed baseline).")
    ap.add_argument("--root", default=REPO_ROOT,
                    help="repo root (default: autodetected)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the package's lint_baseline.json from the "
                         "current findings (after human review)")
    ap.add_argument("--sarif", metavar="FILE",
                    help="also write NEW findings as SARIF 2.1.0")
    ap.add_argument("--explain", metavar="RULE:path:line",
                    help="print the interprocedural chain + resolved "
                         "process-set values behind one finding")
    args = ap.parse_args(argv)

    # Guard the console-script case: installed into site-packages, the
    # autodetected root is site-packages and the gate would "find" zero
    # baseline + scan the wrong tree.  Demand a real source checkout.
    if not os.path.isfile(os.path.join(args.root, "pyproject.toml")):
        print(f"error: {args.root!r} does not look like the horovod_tpu "
              f"repo (no pyproject.toml) — pass --root <checkout>",
              file=sys.stderr)
        return 2

    if args.explain:
        try:
            return explain(args.explain, root=args.root)
        except Exception:  # noqa: BLE001 - crash != finding (CI contract)
            print("internal error: --explain crashed (exit 3)",
                  file=sys.stderr)
            traceback.print_exc()
            return 3

    try:
        new, stale, baselined = run_gate(
            root=args.root, update_baseline=args.update_baseline,
            sarif=args.sarif)
    except Exception:  # noqa: BLE001 - crash != finding (CI contract)
        print("internal error: lint gate crashed (exit 3)", file=sys.stderr)
        traceback.print_exc()
        return 3

    if args.update_baseline:
        return 0
    for f in new:
        print(f.render())
    if stale:
        print(f"note: {len(stale)} stale baseline entr"
              + ("y" if len(stale) == 1 else "ies")
              + " no longer fire(s) — prune " + BASELINE + ":")
        for r, p, ln in stale:
            print(f"  {r} {p}:{ln}")
    print(f"lint gate: {len(new)} new finding(s), {baselined} baselined, "
          f"{len(stale)} stale")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
