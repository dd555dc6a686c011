"""The port stands alone: ``horovod_tpu_torch`` imports neither JAX nor any
module of ``horovod_tpu`` (the name is tested exactly, so the port's own
prefix is not caught), and its runtime follows the world and device
contract without JAX.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horovod_tpu_torch")

_BLOCKED_ROOTS = ("jax", "jaxlib")


def _blocked(name: str) -> bool:
    return (name.split(".")[0] in _BLOCKED_ROOTS or name == "horovod_tpu"
            or name.startswith("horovod_tpu."))


_PURITY_SRC = r"""
import importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if (name.split('.')[0] in ('jax', 'jaxlib') or name == 'horovod_tpu'
                or name.startswith('horovod_tpu.')):
            raise ImportError('port purity: %s must not be imported' % name)
        return None

sys.meta_path.insert(0, BlockJax())
sys.path.insert(0, sys.argv[1])
import horovod_tpu_torch as hvd
names = [m.name for m in pkgutil.walk_packages(hvd.__path__,
                                               'horovod_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
hvd.init(device='cpu')
assert hvd.size() == 1 and hvd.rank() == 0
print('PURE', len(names))
"""


def test_torch_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PURITY_SRC, REPO],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "PURE" in res.stdout
    assert int(res.stdout.split()[-1]) >= 15


def test_torch_blocked_name_rule():
    assert _blocked("horovod_tpu") and _blocked("horovod_tpu.serve")
    assert _blocked("jax.numpy") and _blocked("jaxlib")
    assert not _blocked("horovod_tpu_torch")
    assert not _blocked("horovod_tpu_torch.serve.replica")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_torch_port_source_has_no_jax_import():
    files = []
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) >= 20
    bad = [(f, m) for f in files for m in _imports(f) if _blocked(m)]
    assert not bad, bad


def test_torch_init_without_card_raises(monkeypatch):
    """With no card and no explicit CPU request, init() raises instead of
    carrying on on the CPU."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(basics, "_state", basics.GlobalState())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()


def test_torch_world_contract_single_process(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(basics, "_state", basics.GlobalState())
    with pytest.raises(hvd.NotInitializedError):
        hvd.rank()
    hvd.init(device="cpu")
    hvd.init(device="cpu")                      # idempotent
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size()) \
        == (0, 1, 0, 1)
    assert hvd.device() == torch.device("cpu")
    assert hvd.global_process_set.ranks == [0]
    assert hvd.global_process_set.group is None    # no process group
    assert hvd.process_set_included(hvd.global_process_set)
    with pytest.raises(ValueError, match="out of range"):
        hvd.add_process_set([0, 1])
    with pytest.raises(ValueError, match="already exists"):
        hvd.add_process_set([0])
    hvd.shutdown()
    assert not hvd.is_initialized()


def test_torch_world_needs_controller_address(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.delenv("HOROVOD_CONTROLLER_ADDR", raising=False)
    monkeypatch.setattr(basics, "_state", basics.GlobalState())
    with pytest.raises(RuntimeError, match="CONTROLLER_ADDR"):
        hvd.init(device="cpu")
