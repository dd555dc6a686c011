"""The port's collective lint (``horovod_tpu_torch/analysis``) held against
the JAX package's (``horovod_tpu/analysis``) on the CPU.

- Every source snippet that ``tests/test_analysis.py`` lints (the string
  constants it hands to ``lint``/``lint_source``, read from its syntax
  tree) goes through both analyzers, one parametrised case each: the
  findings' (rule, line, column, severity, message) are equal, so a
  script's pragmas carry over.
- The port's spellings give their rules: ``dist.all_reduce`` under ``if
  dist.get_rank() == 0`` (HVD101), ``psum(x, mesh, "tq")`` on a
  ``make_mesh({"tp": 2})`` mesh (HVD112), a mesh's ``.index(axis)`` as a
  rank read but not ``list.index``, ``group=`` as a scope (no HVD102).
- The rule catalog, the CLI's exit codes (``python -m
  horovod_tpu_torch.analysis``) and ``DistributedOptimizer(check=)``, whose
  hook lints the calling script.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

from horovod_tpu.analysis import RULES as JAX_RULES
from horovod_tpu.analysis import lint_source as jax_lint_source
from horovod_tpu_torch.analysis import RULES, Severity, lint_source
from horovod_tpu_torch.analysis.findings import is_package_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = os.path.join(REPO, "tests", "test_analysis.py")


def _constant_source(arg):
    """A string constant, or ``textwrap.dedent`` of one; else None."""
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
            and arg.func.attr == "dedent" and arg.args:
        arg = arg.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return textwrap.dedent(arg.value)
    return None


def _snippets(path):
    """``(test name, n, source)`` of every constant snippet a JAX test
    file lints: the sources it hands to ``lint(...)``/``lint_source(...)``
    and the scripts it writes with ``write_text(...)`` for the CLI."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        n = 0
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            name = node.func.id if isinstance(node.func, ast.Name) else \
                node.func.attr if isinstance(node.func, ast.Attribute) \
                else None
            if name not in ("lint", "lint_source", "write_text"):
                continue
            src = _constant_source(node.args[0])
            if src is not None:
                out.append((fn.name, n, src))
                n += 1
    return out


SNIPPETS = _snippets(JAX_TESTS)


def _key(findings):
    return [(f.rule, f.line, f.col, f.severity.value, f.message)
            for f in findings]


def rules_of(findings):
    return {f.rule for f in findings}


def lint(src):
    return lint_source(textwrap.dedent(src), "fixture.py")


def test_snippets_were_found():
    assert len(SNIPPETS) >= 39, len(SNIPPETS)


@pytest.mark.parametrize("name,n,src", SNIPPETS,
                         ids=[f"{s[0]}-{s[1]}" for s in SNIPPETS])
def test_torch_lint_matches_jax_on_its_snippets(name, n, src):
    assert _key(lint_source(src, "fixture.py")) == \
        _key(jax_lint_source(src, "fixture.py"))


def test_torch_rule_catalog_is_the_jax_one():
    assert list(RULES) == list(JAX_RULES)
    for rid, r in RULES.items():
        j = JAX_RULES[rid]
        assert (r.severity.value, r.title, r.rationale, r.fix_hint) == \
            (j.severity.value, j.title, j.rationale, j.fix_hint)


def test_torch_package_frame_is_the_port_only():
    import horovod_tpu
    import horovod_tpu_torch
    port = os.path.dirname(horovod_tpu_torch.__file__)
    jax_pkg = os.path.dirname(horovod_tpu.__file__)
    assert is_package_frame(os.path.join(port, "optimizer.py"))
    assert not is_package_frame(os.path.join(jax_pkg, "optimizer.py"))
    assert not is_package_frame(port + "_x/train.py")


# ------------------------------------------------------- port spellings
def test_torch_dist_collective_under_get_rank_fires_hvd101():
    findings = lint("""
        import torch.distributed as dist
        def step(t):
            if dist.get_rank() == 0:
                dist.all_reduce(t)
            r = dist.get_rank()
            if r:
                dist.all_gather_into_tensor(t, t)
    """)
    hits = [f for f in findings if f.rule == "HVD101"]
    assert [f.line for f in hits] == [5, 8], [f.render() for f in hits]
    assert "'all_reduce'" in hits[0].message and hits[0].is_error


def test_torch_mesh_psum_on_unbound_axis_fires_hvd112():
    findings = lint("""
        from horovod_tpu_torch.parallel import make_mesh, psum
        mesh = make_mesh({"tp": 2})
        def step(x):
            x = psum(x, mesh, "tp")
            return psum(x, mesh, "tq")
    """)
    hits = [f for f in findings if f.rule == "HVD112"]
    assert len(hits) == 1 and hits[0].line == 6 and hits[0].is_error
    assert "'tq'" in hits[0].message and "['tp']" in hits[0].message


def test_torch_mesh_functions_and_index_read_rank():
    findings = lint("""
        from horovod_tpu_torch.parallel.mesh import ReduceOutput, make_mesh
        mesh = make_mesh({"pp": 2, "tp": 2})
        def step(x, stages):
            if mesh.index("pp") == 0:
                x = ReduceOutput.apply(x, mesh, "tp")
            if stages.index(x):
                x = ReduceOutput.apply(x, mesh, "tp")
            return ReduceOutput.apply(x, mesh, "dp")
    """)
    assert [(f.rule, f.line) for f in findings] == [("HVD101", 6),
                                                     ("HVD112", 9)]
    assert "'ReduceOutput'" in findings[0].message


def test_torch_group_scopes_a_dist_collective():
    findings = lint("""
        import horovod_tpu_torch as hvd
        import torch.distributed as dist
        hvd.init()
        evens = hvd.add_process_set([0, 2])
        def step(t, g):
            dist.all_reduce(t, group=g)
            dist.broadcast(t, 0)
    """)
    assert [(f.rule, f.line) for f in findings] == [("HVD102", 8)]


def test_torch_lax_spelling_keeps_the_jax_reading():
    src = """
        from jax import lax
        import horovod_tpu as hvd
        def step(x, mesh_axis):
            if hvd.rank() == 0:
                x = lax.psum(x, "dp")
                x = lax.all_gather(x, mesh_axis)
            return x
    """
    assert _key(lint(src)) == _key(jax_lint_source(textwrap.dedent(src),
                                                   "fixture.py"))
    assert "HVD101" not in rules_of(lint(src))


# ---------------------------------------------------------------- CLI
def test_torch_cli_exit_codes_and_output(tmp_path):
    from horovod_tpu_torch.analysis.__main__ import main

    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import torch.distributed as dist
        if dist.get_rank() == 0:
            dist.barrier()
    """))
    clean = tmp_path / "clean.py"
    clean.write_text("import horovod_tpu_torch as hvd\nhvd.allreduce(x)\n")
    assert main([str(clean)]) == 0
    assert main([str(bad)]) == 1
    assert main([str(bad), "--disable", "HVD101"]) == 0
    assert main([]) == 2
    assert main(["--list-rules"]) == 0
    assert main([str(bad), "--json"]) == 1
    assert main([str(tmp_path / "nonexistent.py")]) == 2
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis", str(bad)],
        capture_output=True, text=True, cwd=REPO, timeout=60)
    assert res.returncode == 1, res.stderr
    assert "HVD101" in res.stdout


# ---------------------------------------------------------- check= hook
_SCRIPT = '''
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.analysis.hooks import CollectiveCheckError

hvd.init(device="cpu")
model = torch.nn.Linear(2, 2)
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               check=True)
print("WARN_OK", isinstance(opt, torch.optim.SGD))
try:
    hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                             check="strict")
except CollectiveCheckError as e:
    print("STRICT_RAISED", sorted({f.rule for f in e.findings}),
          sorted({os.path.basename(f.path) for f in e.findings}))
if hvd.rank() == 1:
    hvd.barrier()
hvd.shutdown()
'''


def test_torch_distributed_optimizer_check_lints_the_calling_script(
        tmp_path):
    """``DistributedOptimizer`` is a function that builds a class: the
    hook's caller discovery must land on the script that called it."""
    script = tmp_path / "train_script.py"
    script.write_text("import os\n" + _SCRIPT)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "WARN_OK True" in res.stdout, res.stdout
    assert "STRICT_RAISED ['HVD101'] ['train_script.py']" in res.stdout, \
        res.stdout


def test_torch_check_hook_modes(tmp_path):
    from horovod_tpu_torch.analysis.hooks import (CollectiveCheckError,
                                                  run_check_hook)
    bad = tmp_path / "train.py"
    bad.write_text("import torch.distributed as dist\n"
                   "if dist.get_rank() == 0:\n"
                   "    dist.all_reduce(x)\n")
    with pytest.raises(CollectiveCheckError) as ei:
        run_check_hook("strict", caller_file=str(bad))
    assert [f.rule for f in ei.value.findings] == ["HVD101"]
    assert ei.value.findings[0].severity is Severity.ERROR
    assert [f.rule for f in run_check_hook(True, caller_file=str(bad))] \
        == ["HVD101"]
    assert run_check_hook(False, caller_file=str(bad)) == []
