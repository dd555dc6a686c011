# Copied from horovod_tpu/analysis/sarif.py:1-109 (jax-free; the port keeps its own copy).
"""SARIF 2.1.0 emitter for analyzer findings.

SARIF (Static Analysis Results Interchange Format, OASIS 2.1.0) is what CI
annotation surfaces (GitHub code scanning, most SARIF viewers) ingest.  One
``run`` per invocation: the tool driver carries the rule catalog for every
rule that fired (id, descriptions, default level), each finding becomes a
``result`` with a physical location whose URI is repo-relative when a root
is given.

Pure stdlib — the emitter builds a plain dict; ``write_sarif`` serializes
it.  ``tests/test_whole_package.py`` validates the output against the
2.1.0 schema's structural requirements.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from .findings import Finding, RULES, Severity

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json")

_LEVELS = {Severity.ERROR: "error", Severity.WARNING: "warning"}


def _uri(path: str, root: Optional[str]) -> str:
    # One normalization for the whole analyzer: SARIF URIs and baseline
    # keys must agree on the spelling of a finding's path, or baselined
    # findings reappear as "new" in the SARIF feed.
    from .baseline import _rel
    return _rel(path, root).lstrip("/")


def to_sarif(findings: Iterable[Finding], root: Optional[str] = None,
             tool_version: str = "0.1.0") -> Dict:
    """Render findings as a SARIF 2.1.0 log dict."""
    findings = list(findings)
    rule_ids: List[str] = []
    for f in findings:
        if f.rule not in rule_ids:
            rule_ids.append(f.rule)
    rule_ids.sort()
    rule_index = {rid: i for i, rid in enumerate(rule_ids)}

    rules = []
    for rid in rule_ids:
        r = RULES.get(rid)
        rules.append({
            "id": rid,
            "shortDescription": {"text": r.title if r else rid},
            "fullDescription": {"text": r.rationale if r else rid},
            "help": {"text": r.fix_hint if r else ""},
            "defaultConfiguration": {
                "level": _LEVELS.get(r.severity, "warning") if r
                         else "warning"},
        })

    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "ruleIndex": rule_index[f.rule],
            "level": _LEVELS.get(f.severity, "warning"),
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": _uri(f.path, root)},
                    "region": {"startLine": max(1, f.line),
                               "startColumn": max(1, f.col)},
                },
            }],
        }
        props = {}
        if getattr(f, "process_set", None):
            # Resolved process-set value(s) behind the finding — lets a
            # SARIF viewer group multi-tenant findings per set.
            props["processSet"] = f.process_set
        if getattr(f, "chain", None):
            props["callChain"] = list(f.chain)
        if props:
            result["properties"] = props
        results.append(result)

    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "hvd-lint",
                "informationUri":
                    "https://github.com/horovod/horovod",
                "version": tool_version,
                "rules": rules,
            }},
            "results": results,
            "columnKind": "unicodeCodePoints",
        }],
    }


def write_sarif(findings: Iterable[Finding], path: str,
                root: Optional[str] = None) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(to_sarif(findings, root=root), fh, indent=2, sort_keys=True)
        fh.write("\n")
