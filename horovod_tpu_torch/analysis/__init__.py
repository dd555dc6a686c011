# Copied from horovod_tpu/analysis/__init__.py:1-56 (jax-free; the port keeps its own copy).
"""Collective-correctness analyzer: lint + trace check + runtime sanitizer.

Three layers, one rule catalog (see ``findings.RULES`` and
``docs/analysis.md``):

- :mod:`.collective_lint` — AST lint of training scripts (and this repo),
  in the JAX package's spellings and the port's (``torch.distributed``,
  the process mesh).  CLI: ``python -m horovod_tpu_torch.analysis
  <paths>``.
- :mod:`.trace_check` — collective ledger audit of a step traced with
  fake tensors (a ``torch.fx`` walk; ``make_sharded_train_step(check=)``).
- :mod:`.runtime_sanitizer` — ``HVD_TPU_SANITIZER=1`` run-time ledger and
  cross-rank order/signature check through the negotiation controller.

Plus the two-pass **whole-package mode** (``--whole-package``; see
:mod:`.callgraph` / :mod:`.whole_package`): a package-wide symbol table +
call graph, interprocedural HVD101 rank-guard propagation, cross-module
HVD102/HVD103 facts, per-entry-point collective schedules (HVD108/HVD109),
SARIF 2.1.0 output (:mod:`.sarif`), finding baselines (:mod:`.baseline`)
and the port's CI gate (:mod:`.gate`, ``python -m
horovod_tpu_torch.analysis.gate``).

``DistributedOptimizer(..., check=...)`` exposes the lint (see
:mod:`.hooks`).
"""

from .findings import Finding, Rule, RULES, Severity, summarize  # noqa: F401
from .collective_lint import (  # noqa: F401
    COLLECTIVE_NAMES, lint_file, lint_paths, lint_source,
)

__all__ = [
    "Finding", "Rule", "RULES", "Severity", "summarize",
    "COLLECTIVE_NAMES", "lint_file", "lint_paths", "lint_source",
    "analyze_paths", "analyze_package", "build_package",
]


def analyze_package(paths):
    """Whole-package (interprocedural) analysis; see
    :func:`.whole_package.analyze_package`.  Imported lazily so the plain
    per-module lint path stays import-light."""
    from .whole_package import analyze_package as _ap
    return _ap(paths)


def build_package(paths):
    """Build the pass-1 symbol table + call graph; see
    :func:`.callgraph.build_package`."""
    from .callgraph import build_package as _bp
    return _bp(paths)


def analyze_paths(paths, include_warnings: bool = True):
    """Lint files/dirs; returns findings (errors first, then warnings)."""
    findings = lint_paths(paths)
    if not include_warnings:
        findings = [f for f in findings if f.is_error]
    return sorted(findings, key=lambda f: (not f.is_error, f.path, f.line))
