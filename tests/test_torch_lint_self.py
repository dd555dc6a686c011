"""The port's own gate (``python -m horovod_tpu_torch.analysis.gate``):
the whole-package analyzer over ``horovod_tpu_torch/`` against the reviewed
``horovod_tpu_torch/analysis/lint_baseline.json``.

- no new finding, and no stale baseline entry (the file shrinks as code is
  fixed);
- no error is baselined: every error the analyzer finds in the port is
  repaired or carries a pragma with its reason;
- ``chip_smoke.py`` (a script outside the gate, as ``tests/data`` is for
  the JAX gate) lints without an unsuppressed error: its strict
  ``check=`` runs on the card.

The package is analysed once for the module.
"""

import json
import os

import pytest

from horovod_tpu_torch.analysis import gate
from horovod_tpu_torch.analysis.collective_lint import lint_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run():
    new, stale, baselined = gate.run_gate(root=REPO, quiet=True)
    return new, stale, baselined


def test_torch_gate_has_no_new_findings(run):
    new, _, baselined = run
    assert not new, "\n".join(f.render() for f in new)
    assert baselined > 0


def test_torch_gate_baseline_has_no_stale_entries(run):
    _, stale, _ = run
    assert not stale, stale


def test_torch_gate_baselines_no_error():
    from horovod_tpu_torch.analysis.findings import RULES, Severity
    with open(os.path.join(REPO, gate.BASELINE)) as fh:
        entries = json.load(fh)["findings"]
    errors = [e for e in entries
              if RULES[e["rule"]].severity is Severity.ERROR]
    assert not errors, errors
    assert all(e["path"].startswith("horovod_tpu_torch/") for e in entries)


def test_torch_gate_scope_is_the_port():
    assert gate.SCOPE == ("horovod_tpu_torch",)


def test_chip_smoke_lints_without_an_unsuppressed_error():
    findings = lint_file(os.path.join(REPO, "chip_smoke.py"))
    errors = [f.render() for f in findings if f.is_error]
    assert not errors, "\n".join(errors)

