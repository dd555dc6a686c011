"""The port's whole-package analyzer (``horovod_tpu_torch/analysis``:
``callgraph``, ``whole_package``, ``baseline``, ``sarif``) held against the
JAX package's on the CPU.

- Every fixture package of ``tests/test_whole_package.py`` (each dict
  literal of ``{"name.py": source}``, read from its syntax tree) and every
  module snippet it lints goes through both analyzers, one parametrised
  case each: the whole-package and the per-module findings' (rule, path in
  the package, line, column, severity, message) are equal.
- The SARIF log and the baseline written from one fixture package are the
  JAX ones, key for key; the static index too.
- The port's spellings reach the interprocedural rules: a helper whose
  ``dist.all_reduce`` is only called under ``dist.get_rank()`` (HVD101
  through the call chain), and branches whose mesh collectives differ
  (HVD108).
"""

import ast
import json
import os
import textwrap

import pytest

from horovod_tpu.analysis import analyze_package as jax_analyze_package
from horovod_tpu.analysis import lint_paths as jax_lint_paths
from horovod_tpu.analysis import lint_source as jax_lint_source
from horovod_tpu.analysis.baseline import write_baseline as jax_write_baseline
from horovod_tpu.analysis.sarif import to_sarif as jax_to_sarif
from horovod_tpu.analysis.whole_package import \
    build_static_index as jax_static_index
from horovod_tpu_torch.analysis import analyze_package, lint_paths, \
    lint_source
from horovod_tpu_torch.analysis.__main__ import main as cli
from horovod_tpu_torch.analysis.baseline import (diff_baseline,
                                                 load_baseline,
                                                 write_baseline)
from horovod_tpu_torch.analysis.sarif import to_sarif
from horovod_tpu_torch.analysis.whole_package import build_static_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = os.path.join(REPO, "tests", "test_whole_package.py")


def _constant(node):
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "dedent" and node.args:
        node = node.args[0]
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _fixtures():
    """``(id, files)`` of every literal fixture package, and ``(id,
    source)`` of every literal module snippet, in the JAX tests."""
    with open(JAX_TESTS, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    pkgs, mods = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) and isinstance(k.value, str)
                and k.value.endswith(".py") for k in node.keys) and all(
                _constant(v) is not None for v in node.values):
            pkgs.append((f"line{node.lineno}",
                         {k.value: _constant(v)
                          for k, v in zip(node.keys, node.values)}))
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.func, ast.Name) \
                and node.func.id == "lint_source":
            src = _constant(node.args[0])
            if src is not None:
                mods.append((f"line{node.lineno}", textwrap.dedent(src)))
    return pkgs, mods


PACKAGES, MODULES = _fixtures()


def make_pkg(tmp_path, files, name="fixture"):
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    for rel, src in files.items():
        p = d / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(d)


def _key(findings, root):
    return sorted((f.rule, os.path.relpath(f.path, root), f.line, f.col,
                   f.severity.value, f.message) for f in findings)


def test_fixtures_were_found():
    assert len(PACKAGES) >= 40 and len(MODULES) >= 3, \
        (len(PACKAGES), len(MODULES))


@pytest.mark.parametrize("files", [p[1] for p in PACKAGES],
                         ids=[p[0] for p in PACKAGES])
def test_torch_whole_package_matches_jax_on_its_fixtures(tmp_path, files):
    pkg = make_pkg(tmp_path, files)
    assert _key(analyze_package([pkg]), pkg) == \
        _key(jax_analyze_package([pkg]), pkg)
    assert _key(lint_paths([pkg]), pkg) == _key(jax_lint_paths([pkg]), pkg)


@pytest.mark.parametrize("src", [m[1] for m in MODULES],
                         ids=[m[0] for m in MODULES])
def test_torch_module_lint_matches_jax_on_its_snippets(src):
    def key(fs):
        return [(f.rule, f.line, f.col, f.severity.value, f.message)
                for f in fs]
    assert key(lint_source(src, "f.py")) == key(jax_lint_source(src, "f.py"))


# The fixture with the most rules: HVD101 through a call chain, HVD108,
# HVD111 and HVD113 over process sets, and a pragma.
MIXED = {
    "__init__.py": "",
    "helpers.py": """
        import horovod_tpu as hvd

        def do_sum(x):
            return hvd.allreduce(x, name="s")

        def scoped(x, process_set):
            hvd.allreduce(x, process_set=process_set)
            hvd.barrier()
    """,
    "train.py": """
        import horovod_tpu as hvd
        from .helpers import do_sum, scoped

        evens = hvd.add_process_set([0, 2])

        def main(x, flag):
            if hvd.rank() == 0:
                do_sum(x)
            if flag:
                hvd.allreduce(x, process_set=evens)
                hvd.allreduce(x)
            else:
                hvd.allreduce(x)
                hvd.allreduce(x, process_set=evens)
            scoped(x, process_set=evens)
    """,
}


def test_torch_sarif_baseline_and_static_index_match_jax(tmp_path):
    pkg = make_pkg(tmp_path, MIXED)
    port, jax_f = analyze_package([pkg]), jax_analyze_package([pkg])
    assert {f.rule for f in port} >= {"HVD101", "HVD108", "HVD111",
                                      "HVD113"}
    assert to_sarif(port, root=pkg) == jax_to_sarif(jax_f, root=pkg)
    write_baseline(port, str(tmp_path / "port.json"), root=pkg)
    jax_write_baseline(jax_f, str(tmp_path / "jax.json"), root=pkg)
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    base = load_baseline(str(tmp_path / "jax.json"))
    diff = diff_baseline(port, base, root=pkg)
    assert not diff.new and not diff.stale and len(diff.matched) == len(port)
    assert build_static_index([pkg]) == jax_static_index([pkg])


def test_torch_cli_whole_package_baseline_and_sarif(tmp_path):
    pkg = make_pkg(tmp_path, MIXED)
    assert cli([pkg, "--whole-package"]) == 1
    base = str(tmp_path / "base.json")
    assert cli([pkg, "--whole-package", "--write-baseline", base]) == 0
    sarif = str(tmp_path / "out.sarif")
    assert cli([pkg, "--whole-package", "--baseline", base,
                "--sarif", sarif]) == 0
    with open(sarif) as fh:
        assert json.load(fh)["runs"][0]["results"] == []
    idx = str(tmp_path / "idx.json")
    assert cli([pkg, "--whole-package", "--emit-static-index", idx]) == 1
    with open(idx) as fh:
        assert "helpers.py:5" in json.load(fh)["sites"]


# ------------------------------------------------------- port spellings
def test_torch_port_spellings_reach_the_interprocedural_rules(tmp_path):
    pkg = make_pkg(tmp_path, {
        "__init__.py": "",
        "helpers.py": """
            import torch.distributed as dist
            from horovod_tpu_torch.parallel import psum

            def reduce(t):
                dist.all_reduce(t)

            def mixed(x, mesh, flag):
                if flag:
                    return psum(x, mesh, "tp")
                return x
        """,
        "train.py": """
            import torch.distributed as dist
            from .helpers import reduce

            def main(t):
                if dist.get_rank() == 0:
                    reduce(t)
        """,
    })
    findings = analyze_package([pkg])
    rules = {(f.rule, os.path.basename(f.path), f.line) for f in findings}
    assert ("HVD101", "helpers.py", 6) in rules, findings
    assert ("HVD108", "helpers.py", 9) in rules, findings
    hit = next(f for f in findings if f.rule == "HVD101")
    assert "rank-guarded call chain" in hit.message and "train.py" in \
        hit.message
