# Copied from horovod_tpu/analysis/hooks.py:1-76 (jax-free; the port keeps its own copy).
"""The ``check=`` hook shared by the framework bindings.

``DistributedOptimizer(..., check=True)`` (torch, tensorflow and jax
bindings alike) lints the *calling script* at wrap time — the moment every
Horovod training script passes through — and reports deadlock-prone
collective patterns before the first step runs:

- ``check=False`` (default): no analysis.
- ``check=True`` / ``check="warn"``: log findings as warnings.
- ``check="strict"``: additionally raise :class:`CollectiveCheckError`
  when any error-severity finding is present.
"""

from __future__ import annotations

import inspect
import os
from typing import List, Optional

from .collective_lint import lint_file
from .findings import Finding, is_package_frame, summarize
from ..utils.logging import get_logger

log = get_logger()


class CollectiveCheckError(RuntimeError):
    """Raised by ``check='strict'`` when the caller's script has
    error-severity collective findings."""

    def __init__(self, findings: List[Finding]):
        self.findings = findings
        msgs = "\n".join(f.render() for f in findings)
        super().__init__(
            f"collective-correctness check failed "
            f"({summarize(findings)}):\n{msgs}")


def _caller_file(depth: int = 2) -> Optional[str]:
    """Source file of the user frame ``depth`` levels up (skipping this
    package's own frames — ``findings.is_package_frame`` decides what
    counts as package code)."""
    frame = inspect.currentframe()
    try:
        for _ in range(depth):
            if frame is None:
                return None
            frame = frame.f_back
        while frame is not None:
            fn = frame.f_code.co_filename
            if not is_package_frame(fn) and os.path.isfile(fn):
                return fn
            frame = frame.f_back
        return None
    finally:
        del frame


def run_check_hook(check, caller_file: Optional[str] = None
                   ) -> List[Finding]:
    """Execute the ``check=`` contract; returns the findings (possibly
    empty).  ``check`` falsy → no-op."""
    if not check:
        return []
    path = caller_file or _caller_file(depth=3)
    if path is None:
        log.warning("check=%r: could not locate the calling script to lint",
                    check)
        return []
    findings = lint_file(path)
    for f in findings:
        log.warning("%s", f.render())
    errors = [f for f in findings if f.is_error]
    if check == "strict" and errors:
        raise CollectiveCheckError(errors)
    return findings
