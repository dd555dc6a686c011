# Copied from horovod_tpu/analysis/baseline.py:1-82 (jax-free; the port keeps its own copy).
"""Finding baselines: known findings that must not block a CI gate.

A baseline is a JSON file listing reviewed findings keyed by
``(rule, repo-relative path, line)``.  The gate (``tools/lint_gate.py``)
subtracts the baseline from a fresh run: only NEW findings fail CI, and
entries that no longer fire are reported as stale so the file shrinks as
code is fixed — the same honesty contract as ``tests/test_lint_self.py``'s
inline allowlist, but file-based so the whole-package mode's reviewed
findings (benchmarks, deliberate test divergence) don't need source edits
in bulk.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .findings import Finding

Key = Tuple[str, str, int]


def _rel(path: str, root: Optional[str]) -> str:
    path = os.path.abspath(path)
    if root:
        root = os.path.abspath(root)
        if path == root or path.startswith(root + os.sep):
            path = os.path.relpath(path, root)
    return path.replace(os.sep, "/")


def finding_key(f: Finding, root: Optional[str] = None) -> Key:
    return (f.rule, _rel(f.path, root), f.line)


@dataclasses.dataclass
class BaselineDiff:
    new: List[Finding]
    matched: List[Finding]
    stale: List[Key]


def load_baseline(path: str) -> Dict[Key, str]:
    """Baseline file → {key: reason/message}.  Missing file → empty."""
    if not os.path.isfile(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    out: Dict[Key, str] = {}
    for e in data.get("findings", []):
        out[(e["rule"], e["path"], int(e["line"]))] = e.get("message", "")
    return out


def write_baseline(findings: Iterable[Finding], path: str,
                   root: Optional[str] = None) -> None:
    entries = [{
        "rule": f.rule,
        "path": _rel(f.path, root),
        "line": f.line,
        "message": f.message,
    } for f in findings]
    entries.sort(key=lambda e: (e["path"], e["line"], e["rule"]))
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "findings": entries}, fh, indent=2)
        fh.write("\n")


def diff_baseline(findings: Sequence[Finding], baseline: Dict[Key, str],
                  root: Optional[str] = None) -> BaselineDiff:
    """Split findings into new vs baseline-matched; report stale entries."""
    live: Dict[Key, None] = {}
    new: List[Finding] = []
    matched: List[Finding] = []
    for f in findings:
        k = finding_key(f, root)
        live[k] = None
        (matched if k in baseline else new).append(f)
    stale = [k for k in baseline if k not in live]
    return BaselineDiff(new=new, matched=matched, stale=sorted(stale))
