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


# The observability modules, copies of jax-free modules of the JAX package:
# each must import with JAX and horovod_tpu blocked, its own relative
# imports resolving inside the port.
OBSERVE_MODULES = (
    "horovod_tpu_torch.utils.timeline", "horovod_tpu_torch.trace",
    "horovod_tpu_torch.trace.core", "horovod_tpu_torch.trace.writer",
    "horovod_tpu_torch.trace.merge", "horovod_tpu_torch.trace.analyze",
    "horovod_tpu_torch.trace.__main__", "horovod_tpu_torch.monitor",
    "horovod_tpu_torch.monitor.agent", "horovod_tpu_torch.monitor.aggregator",
    "horovod_tpu_torch.monitor.http", "horovod_tpu_torch.monitor.__main__",
    "horovod_tpu_torch.monitor.registry")

_OBSERVE_SRC = _PURITY_SRC.split("import horovod_tpu_torch as hvd")[0] + r"""
import importlib
for name in sys.argv[2:]:
    mod = importlib.import_module(name)
    assert mod.__file__.startswith(sys.argv[1]), mod.__file__
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', len(sys.argv) - 2)
"""


def test_torch_observability_modules_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _OBSERVE_SRC, REPO,
                          *OBSERVE_MODULES], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[-1] == str(len(OBSERVE_MODULES))


# The data-plane depth modules: the autotuner (a copy of the jax-free
# ``horovod_tpu/ops/autotune.py``), the scheduler copies, the engine and
# the fusion wrappers that run its chunks.
DEPTH_MODULES = ("horovod_tpu_torch.ops.autotune",
                 "horovod_tpu_torch.ops.scheduler",
                 "horovod_tpu_torch.ops.engine",
                 "horovod_tpu_torch.ops.fusion")

_DEPTH_SRC = _OBSERVE_SRC.replace("print('PURE', len(sys.argv) - 2)", r"""
import types
from horovod_tpu_torch.ops import autotune, scheduler
eng = types.SimpleNamespace(fusion_threshold=1 << 20, cycle_time_s=1e-3,
                            fast_lane_threshold=0)
sent = []
pm = autotune.ParameterManager(
    eng, warmup_samples=0, steps_per_sample=1, max_evals=3,
    broadcaster=lambda p: sent.append(p) or p, poller=lambda h: h)
for _ in range(10):
    pm.on_cycle(1 << 20)
assert sent and not pm.tuning, (sent, pm.tuning)
assert scheduler.partition_plan(10, 4, 12) == ((0, 3), (3, 3), (6, 3),
                                               (9, 1))
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', len(sys.argv) - 2)
""")


def test_torch_depth_modules_import_without_jax():
    """The autotuner, the scheduler, the engine and the fusion wrappers
    import with JAX and horovod_tpu blocked, and the autotuner's search
    runs to its end on a fake engine."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _DEPTH_SRC, REPO,
                          *DEPTH_MODULES], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[-1] == str(len(DEPTH_MODULES))


def test_torch_copied_modules_name_their_origin():
    """Every copied observability module's first line, the copied
    autotuner's, the Spark store's and the Ray strategies' and package's,
    names the JAX file it was copied from, with its lines; the copied
    ``AsyncDataLoaderMixin`` is named so on the line above it, and is the
    JAX class line for line."""
    for name in OBSERVE_MODULES + DEPTH_MODULES[:1] + COPIED_LAST:
        rel = name.replace("horovod_tpu_torch.", "").replace(".", os.sep)
        path = os.path.join(PKG, rel + ".py")
        if not os.path.exists(path):
            path = os.path.join(PKG, rel, "__init__.py")
        first = open(path).readline()
        src = os.path.relpath(path, PKG)
        assert first.startswith(f"# Copied from horovod_tpu/{src}:1-"), \
            (path, first)
    rel = os.path.join("data", "__init__.py")
    port = open(os.path.join(PKG, rel)).read().splitlines()
    ref = open(os.path.join(REPO, "horovod_tpu", rel)).read().splitlines()
    start = port.index("class AsyncDataLoaderMixin:")
    assert port[start - 1] == f"# Copied from horovod_tpu/{rel}:26-94.", \
        port[start - 1]
    assert port[start:start + 69] == ref[25:94]
    assert ref[93] == "_SENTINEL = object()"


_ZERO_SRC = _PURITY_SRC.split("import horovod_tpu_torch as hvd")[0] + r"""
import numpy as np, torch
from horovod_tpu_torch.parallel import zero
import horovod_tpu_torch as hvd
from horovod_tpu_torch import optimizer
hvd.init(device='cpu')
for sharded in (True, 'full'):
    ps = [torch.randn(7, requires_grad=True), torch.randn(3, 2,
                                                          requires_grad=True)]
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(ps, lr=0.1),
                                   sharded=sharded)
    if sharded == 'full':
        opt.gather_params()
    for p in ps:
        p.grad = torch.ones_like(p)
    opt.step()
    assert hvd.is_sharded_saveable(opt.hvd_sharded_saveable())
assert zero.shard_info(7, 2) == (1, 4)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', zero.__file__, optimizer.__file__)
"""


def test_torch_zero_modules_stand_alone():
    """The pad+slice helpers (a copy of ``horovod_tpu/parallel/zero.py``
    :40-72, whose first line says so) and the sharded optimizer import and
    run a step in both modes with JAX and horovod_tpu blocked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _ZERO_SRC, REPO],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    _, zero_file, opt_file = res.stdout.split()[-3:]
    assert zero_file.startswith(PKG) and opt_file.startswith(PKG)
    first = open(os.path.join(PKG, "parallel", "zero.py")).readline()
    assert first.startswith("# Copied from horovod_tpu/parallel/zero.py:40-72")
    head = open(os.path.join(PKG, "optimizer.py")).read(600)
    assert "horovod_tpu/jax/optimizer.py" in head


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


# torch.distributed calls that are collectives (world set-up and tear-down
# are not: init_process_group, destroy_process_group, new_group).
_COLLECTIVES = {
    "all_reduce", "all_reduce_coalesced", "broadcast", "broadcast_object_list",
    "all_gather", "all_gather_into_tensor", "all_gather_object",
    "all_gather_coalesced", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "barrier",
    "monitored_barrier", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "gather", "gather_object", "scatter",
    "scatter_object_list"}
# The modules allowed to issue them, and which: the engine's cycle thread,
# and the process mesh's exchanges and reduction (the counterparts of
# lax.ppermute, lax.all_to_all and lax.psum, on communicators the engine
# never uses).
_ENGINE = os.path.join("ops", "engine.py")
_MESH = os.path.join("parallel", "mesh.py")
_COLLECTIVE_CALLERS = {_ENGINE, _MESH}
_MESH_CALLS = {"batch_isend_irecv", "isend", "irecv", "all_to_all_single",
               "all_reduce"}


def _collective_calls(path):
    """``(line, name)`` of every torch.distributed collective a file calls,
    through ``torch.distributed.<name>``, an alias of the module, or a name
    imported from it."""
    tree = ast.parse(open(path).read(), path)
    aliases, direct = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed":
                    aliases.add(a.asname or "torch.distributed")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch" and node.level == 0:
                aliases.update(a.asname or a.name for a in node.names
                               if a.name == "distributed")
            if node.module == "torch.distributed" and node.level == 0:
                direct.update(a.asname or a.name for a in node.names
                              if a.name in _COLLECTIVES)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in direct:
            out.append((node.lineno, f.id))
        elif isinstance(f, ast.Attribute) and f.attr in _COLLECTIVES:
            owner = ast.unparse(f.value)
            if owner in aliases or owner == "torch.distributed":
                out.append((node.lineno, f.attr))
    return out


def test_torch_only_the_engine_calls_collectives():
    """The engine's cycle thread is the port's only caller of
    torch.distributed collectives on a process set's group (a main-thread
    broadcast interleaved with engine-thread allreduces can be issued in
    different orders on different ranks); basics only forms and destroys
    the world.  The process mesh may exchange too, only by point-to-point
    rotations, all-to-alls and the tensor-parallel all-reduce, and only on
    its own groups (``test_torch_mesh_exchanges_run_on_mesh_groups``).  The engine's
    Adasum swaps pairs by ``batch_isend_irecv``, in ``_swapper`` only
    (``test_torch_engine_swaps_only_in_its_swapper``)."""
    callers = {}
    for root, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(root, n)
                calls = _collective_calls(path)
                if calls:
                    callers[os.path.relpath(path, PKG)] = calls
    smoke = _collective_calls(os.path.join(REPO, "chip_smoke.py"))
    assert not smoke, smoke
    assert set(callers) == _COLLECTIVE_CALLERS, callers
    assert {n for _, n in callers[_ENGINE]} == {
        "all_reduce", "broadcast", "all_gather_into_tensor",
        "reduce_scatter_tensor", "all_to_all_single", "batch_isend_irecv"}
    assert {n for _, n in callers[_MESH]} <= _MESH_CALLS, callers[_MESH]


def _group_sources(path):
    """``(line, call, group expression, its sources)`` for every call in
    ``path`` that takes a process group: the mesh's collectives and the
    ``P2POp``s that ``batch_isend_irecv`` issues; ``sources`` are the
    right-hand sides assigned, in the enclosing function, to the name the
    group is taken from."""
    tree = ast.parse(open(path).read(), path)
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        assigned = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        assigned.setdefault(t.id, []).append(
                            ast.unparse(node.value))
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = ast.unparse(node.func).split(".")[-1]
            if name not in _MESH_CALLS - {"batch_isend_irecv"} | {"P2POp"}:
                continue
            group = [k.value for k in node.keywords if k.arg == "group"]
            expr = ast.unparse(group[0]) if group else None
            owner = group[0].value.id if group and isinstance(
                group[0], ast.Attribute) and isinstance(
                group[0].value, ast.Name) else None
            out.append((node.lineno, name, expr, assigned.get(owner, [])))
    return out


def test_torch_mesh_exchanges_run_on_mesh_groups():
    """Every exchange of the process mesh, and its all-reduce, passes
    ``group=`` taken from a mesh axis (``ax = mesh.axis(axis)``;
    ``ax.group``), never a process set's group or the world's default."""
    found = _group_sources(os.path.join(PKG, _MESH))
    assert {name for _, name, _, _ in found} == {"P2POp",
                                                 "all_to_all_single",
                                                 "all_reduce"}
    for line, name, expr, sources in found:
        assert expr == "ax.group", (line, name, expr)
        assert sources == ["mesh.axis(axis)"], (line, name, sources)


def test_torch_engine_swaps_only_in_its_swapper():
    """The engine's point-to-point ops (Adasum's pairwise swaps) are the
    ``P2POp``s of one ``batch_isend_irecv`` in ``_swapper``, each on the
    group that its caller binds (the set's, or a two-level local or cross
    group the engine made), never the world's default."""
    tree = ast.parse(open(os.path.join(PKG, _ENGINE)).read())
    found = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and ast.unparse(
                    node.func).split(".")[-1] in ("P2POp",
                                                  "batch_isend_irecv"):
                group = [ast.unparse(k.value) for k in node.keywords
                         if k.arg == "group"]
                found.append((fn.name, ast.unparse(node.func), group))
    assert {f for f, _, _ in found} == {"_swapper", "swap"}, found
    for _, call, group in found:
        if call.endswith("P2POp"):
            assert group == ["group"], found


def test_torch_collective_scan_sees_every_spelling(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import torch\nimport torch.distributed as dist\n"
        "from torch import distributed as d2\n"
        "from torch.distributed import all_gather as ag\n"
        "dist.all_reduce(x)\nd2.barrier()\nag(y, x)\n"
        "torch.distributed.broadcast(x, 0)\ndist.init_process_group('gloo')\n"
        "other.broadcast(x)\n")
    assert sorted(n for _, n in _collective_calls(str(src))) == [
        "ag", "all_reduce", "barrier", "broadcast"]


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


# The elastic slice: the copied driver-side modules, the state plane, the
# worker, the state objects, the sampler and the checkpoints.
ELASTIC_MODULES = (
    "horovod_tpu_torch.elastic", "horovod_tpu_torch.elastic.rendezvous",
    "horovod_tpu_torch.elastic.registration",
    "horovod_tpu_torch.elastic.discovery", "horovod_tpu_torch.elastic.driver",
    "horovod_tpu_torch.elastic.stateplane", "horovod_tpu_torch.elastic.worker",
    "horovod_tpu_torch.elastic.state", "horovod_tpu_torch.elastic.sampler",
    "horovod_tpu_torch.checkpoint")

_ELASTIC_SRC = _OBSERVE_SRC.replace("print('PURE', len(sys.argv) - 2)", r"""
import numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.elastic import stateplane as spl
hvd.init(device='cpu')
st = hvd.elastic.TorchState(params={'w': torch.ones(3, dtype=torch.bfloat16)},
                            step=2)
blob = spl.encode_state(st._saved_state)
back = spl.decode_state(blob)
assert torch.equal(back['params']['w'], st.params['w']) and back['step'] == 2
assert hvd.elastic.run and hvd.elastic.ElasticSampler
hvd.shutdown()
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', len(sys.argv) - 2)
""")


def test_torch_elastic_modules_import_without_jax():
    """The elastic modules import with JAX and horovod_tpu blocked, and a
    TorchState's committed state makes a round trip through the state
    plane's blob."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _ELASTIC_SRC, REPO,
                          *ELASTIC_MODULES], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[-1] == str(len(ELASTIC_MODULES))


# The rest of elastic: the autoscaler, the host agent and the churn
# harness, copies of jax-free modules of the JAX package.
DRAIN_MODULES = ("horovod_tpu_torch.elastic.autoscale",
                 "horovod_tpu_torch.common.host_agent",
                 "horovod_tpu_torch.testing.churn")

_DRAIN_SRC = _OBSERVE_SRC.replace("print('PURE', len(sys.argv) - 2)", r"""
from horovod_tpu_torch.elastic.autoscale import SCALE_IN, ScalePolicy
from horovod_tpu_torch.testing.churn import ChurnRunner
from horovod_tpu_torch.testing.faults import parse_churn
p = ScalePolicy(min_np=1, persistence=1, cooldown_s=0.0, idle_s=5.0)
for t in (100.0, 110.0, 120.0):
    d = p.observe({'queue_depth': 0, 'progress_total': 7}, 3, now=t)
assert d.action == SCALE_IN, d
rep = ChurnRunner(4, ranks_per_host=2, hier=True, rounds=8, warm=2,
                  script=parse_churn('preempt_notice:1@3')).run()
assert rep['survived'] and rep['left_ranks'] == [2, 3], rep
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', len(sys.argv) - 2)
""")


def test_torch_drain_modules_stand_alone():
    """The autoscaler, the host agent and the churn harness import with
    JAX and horovod_tpu blocked; the policy scales an idle fleet in, and
    a hierarchical churn run drains a host behind real agents over the
    port's own coordinator."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _DRAIN_SRC, REPO,
                          *DRAIN_MODULES], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[-1] == str(len(DRAIN_MODULES))
    for name in DRAIN_MODULES:
        rel = name.replace("horovod_tpu_torch.", "").replace(".", os.sep)
        first = open(os.path.join(PKG, rel + ".py")).readline()
        assert first.startswith(f"# Copied from horovod_tpu/{rel}.py:1-"), \
            (name, first)


def test_torch_elastic_modules_name_their_origin():
    """Every elastic module's first line names the JAX file it was copied
    or ported from."""
    for name in ELASTIC_MODULES:
        rel = name.replace("horovod_tpu_torch.", "").replace(".", os.sep)
        path = os.path.join(PKG, rel + ".py")
        if not os.path.exists(path):
            path = os.path.join(PKG, rel, "__init__.py")
        first = open(path).readline()
        assert first.startswith(("# Copied from horovod_tpu/",
                                 "# Ported from horovod_tpu/")), (path, first)



# The expert-parallel slice: MoE, DLRM, the gradient rule and the examples.
EP_MODULES = ("horovod_tpu_torch.models.moe", "horovod_tpu_torch.models.dlrm",
              "horovod_tpu_torch.parallel.expert",
              "horovod_tpu_torch.examples",
              "horovod_tpu_torch.examples.moe_expert_parallel",
              "horovod_tpu_torch.examples.dlrm_alltoall")

_EP_SRC = _OBSERVE_SRC.replace("print('PURE', len(sys.argv) - 2)", r"""
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import parallel
from horovod_tpu_torch.models import dlrm, llama, moe
from horovod_tpu_torch.parallel import expert
hvd.init(device='cpu')
cfg = moe.MoEConfig(d_model=8, d_ff=16, n_experts=4, router_top_k=2,
                    gated=True)
p = moe.init_params(cfg, torch.Generator().manual_seed(0))
y, aux, z = moe.moe_ffn(torch.randn(12, 8), p, cfg, parallel.make_mesh(
    {'ep': 1}))
assert y.shape == (12, 8) and aux.item() > 0
dc = dlrm.tiny(n_tables=2, rows_per_table=10, embed_dim=4)
dp = dlrm.init_params(dc, torch.Generator().manual_seed(0))
d, ids, lab = dlrm.synthetic_batch(dc, 3)
assert dlrm.forward(dp, torch.from_numpy(d), torch.from_numpy(ids),
                    dc).shape == (3,)
lc = llama.mixtral_8x7b(d_model=16, n_heads=2, n_kv_heads=1, d_ff=8,
                        n_layers=1, vocab_size=11, dtype=torch.float32)
assert len(expert.spec_of(llama.param_specs(lc))) == 13
hvd.shutdown()
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', len(sys.argv) - 2)
""")


def test_torch_expert_parallel_modules_stand_alone():
    """MoE, DLRM, the expert gradient rule and the two examples import
    with JAX and horovod_tpu blocked, and a gated top-2 MoE layer, a DLRM
    forward and Mixtral's specs run; each module's first line names its
    origin."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _EP_SRC, REPO, *EP_MODULES],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[-1] == str(len(EP_MODULES))
    for name in EP_MODULES:
        rel = name.replace("horovod_tpu_torch.", "").replace(".", os.sep)
        path = os.path.join(PKG, rel + ".py")
        if not os.path.exists(path):
            continue            # the examples' package: a docstring only
        first = open(path).readline()
        origin = "examples/" if rel.startswith("examples") else "horovod_tpu/"
        assert first.startswith(f"# Ported from {origin}"), (path, first)

# The tensor-parallel slice: the mesh's reduction and Megatron's pair, the
# split specs and the gradient rule, and the four families.
TP_MODULES = ("horovod_tpu_torch.parallel.mesh",
              "horovod_tpu_torch.parallel.expert",
              "horovod_tpu_torch.models.llama", "horovod_tpu_torch.models.bert",
              "horovod_tpu_torch.models.vit", "horovod_tpu_torch.models.gpt2")

_TP_SRC = _OBSERVE_SRC.replace("print('PURE', len(sys.argv) - 2)", r"""
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import parallel
from horovod_tpu_torch.models import bert, gpt2, llama, vit
hvd.init(device='cpu')
mesh = parallel.make_mesh({'dp': 1, 'tp': 1})
cfg = llama.tiny(dtype=torch.float32)
p = llama.shard_params(llama.init_params(cfg, torch.Generator().manual_seed(
    0)), cfg, mesh)
named = list(llama.named_parameters(p))
rep, sh = parallel.split_named(named, llama.param_specs(cfg), ('tp', 'ep'))
assert len(sh) == 14, len(sh)
shards = parallel.ShardedParallel(mesh, torch.optim.SGD(
    [t for _, t in sh], lr=0.1), sh, llama.param_specs(cfg))
step = llama.make_train_step(cfg, torch.optim.SGD([t for _, t in rep],
                                                  lr=0.1), mesh, shards)
toks = torch.zeros(1, 8, dtype=torch.int64)
assert torch.isfinite(step(p, toks, toks))
assert llama.generate(p, toks, 2, cfg, mesh=mesh).shape == (1, 2)
for mod in (bert, vit, gpt2):
    assert parallel.spec_of(mod.param_specs(mod.tiny()))
x = torch.ones(3, requires_grad=True)
parallel.CopyInput.apply(parallel.ReduceOutput.apply(x, mesh, 'tp'), mesh,
                         'tp').sum().backward()
assert torch.equal(x.grad, torch.ones(3))
shards.shutdown()
mesh.shutdown()
hvd.shutdown()
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', len(sys.argv) - 2)
""")


def test_torch_tensor_parallel_modules_stand_alone():
    """The tensor-parallel modules import with JAX and horovod_tpu
    blocked, and a Llama step with its tp leaves in a ``ShardedParallel``,
    a tp ``generate``, the families' specs and Megatron's pair run (at tp
    = 1: one process); each module's first line names its origin."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _TP_SRC, REPO, *TP_MODULES],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[-1] == str(len(TP_MODULES))
    for name in TP_MODULES:
        rel = name.replace("horovod_tpu_torch.", "").replace(".", os.sep)
        first = open(os.path.join(PKG, rel + ".py")).readline()
        assert first.startswith(("# Ported from horovod_tpu/", '"""')), \
            (name, first)
        text = open(os.path.join(PKG, rel + ".py")).read()
        assert "horovod_tpu/" in text.split("\n\n")[0] + text[:2000], name


# World set-up and tear-down (not collectives, but each is a call on a
# communicator's life): who may make, destroy and abort process groups.
_WORLD_CALLS = {"init_process_group", "destroy_process_group",
                "_abort_process_group", "new_group"}
_WORLD_CALLERS = {
    os.path.join("common", "basics.py"): {"init_process_group",
                                          "new_group"},
    os.path.join("elastic", "worker.py"): {"init_process_group",
                                           "destroy_process_group",
                                           "_abort_process_group"},
    _ENGINE: {"new_group"},
    _MESH: {"new_group", "destroy_process_group"},
}


def _world_calls(path):
    tree = ast.parse(open(path).read(), path)
    return {ast.unparse(n.func).split(".")[-1] for n in ast.walk(tree)
            if isinstance(n, ast.Call)
            and ast.unparse(n.func).split(".")[-1] in _WORLD_CALLS}


def test_torch_world_setup_and_teardown_sites():
    """The world is formed in basics (and, in an elastic job, in the
    worker's resilient form), torn down (destroyed, or its communicators
    aborted) only by the elastic worker's teardown, and groups are made
    by basics (process sets), the engine (the two-level groups) and the
    mesh (which destroys its own)."""
    found = {}
    for root, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(root, n)
                calls = _world_calls(path)
                if calls:
                    found[os.path.relpath(path, PKG)] = calls
    assert found == _WORLD_CALLERS, found
    assert not _world_calls(os.path.join(REPO, "chip_smoke.py"))


# Modules that open sockets of their own: the control plane's address
# helpers, the launcher's probe, the monitor's exporter, the serving front
# door, the elastic slice's rendezvous, driver pings, worker
# notifications and the state plane's shard servers, the host agent's
# listener and links, and the churn harness's simulated ranks.
_SOCKET_USERS = {
    os.path.join("common", "net.py"), os.path.join("runner", "bootstrap.py"),
    os.path.join("monitor", "agent.py"), os.path.join("monitor", "http.py"),
    os.path.join("serve", "frontdoor.py"),
    os.path.join("elastic", "rendezvous.py"),
    os.path.join("elastic", "driver.py"), os.path.join("elastic", "worker.py"),
    os.path.join("elastic", "stateplane.py"),
    os.path.join("common", "host_agent.py"),
    os.path.join("testing", "churn.py")}


def test_torch_socket_sites():
    """No data-plane module opens a socket: the collective engine's
    traffic goes through torch.distributed and the coordinator's native
    client only."""
    users = set()
    pat = ("socket.socket(", "socket.create_connection(", "HTTPConnection(",
           "HTTPServer(")
    for root, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(root, n)
                if any(p in open(path).read() for p in pat):
                    users.add(os.path.relpath(path, PKG))
    assert users == _SOCKET_USERS, users


# The pipeline-parallel slice: the schedule, the mesh's rotation under
# autograd and its one-sided hop, the SPMD harness, the pipelined Llama
# and the families' sharded steps.
PP_MODULES = ("horovod_tpu_torch.parallel.pipeline",
              "horovod_tpu_torch.parallel.spmd",
              "horovod_tpu_torch.parallel.mesh",
              "horovod_tpu_torch.models.llama",
              "horovod_tpu_torch.models.resnet",
              "horovod_tpu_torch.models.mnist")

_PP_SRC = _OBSERVE_SRC.replace("print('PURE', len(sys.argv) - 2)", r"""
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import parallel
from horovod_tpu_torch.models import llama, mnist
hvd.init(device='cpu')
mesh = parallel.make_mesh({'dp': 1, 'pp': 1})
cfg = llama.tiny(dtype=torch.float32, pp_axis='pp', n_microbatches=2,
                 remat_stages=True)
p = llama.shard_params(llama.init_params(cfg, torch.Generator().manual_seed(
    0)), cfg, mesh)
named = list(llama.named_parameters(p))
rep, sh = parallel.split_named(named, llama.param_specs(cfg), ('pp',))
assert [n for n, _ in sh][:2] == ['layers.attn_norm', 'layers.mlp_norm'], sh
shards = parallel.ShardedParallel(mesh, torch.optim.SGD(
    [t for _, t in sh], lr=0.1), sh, llama.param_specs(cfg))
step = parallel.make_sharded_train_step(llama.make_train_step(
    cfg, torch.optim.SGD([t for _, t in rep], lr=0.1), mesh, shards), mesh,
    llama.param_specs(cfg))
toks = torch.zeros(4, 8, dtype=torch.int64)
assert torch.isfinite(step(p, toks, toks))
x = torch.ones(3, requires_grad=True)
parallel.PPermute.apply(x, mesh, 'pp', 1).sum().backward()
assert torch.equal(x.grad, torch.ones(3))
mp = mnist.init_params(torch.Generator().manual_seed(0))
mstep = mnist.make_sharded_train_step(torch.optim.SGD(
    [t for _, t in mnist.named_parameters(mp)], lr=0.1), mesh)
assert torch.isfinite(mstep(mp, torch.zeros(2, 28, 28, 1),
                            torch.zeros(2, dtype=torch.int64)))
assert parallel.infer_specs_like({'m': p}, p, llama.param_specs(cfg))[
    'm'] == llama.param_specs(cfg)
shards.shutdown()
mesh.shutdown()
hvd.shutdown()
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', len(sys.argv) - 2)
""")


def test_torch_pipeline_modules_stand_alone():
    """The pipeline-parallel modules import with JAX and horovod_tpu
    blocked, and a remat pipelined Llama step through the SPMD harness,
    the rotation under autograd and MNIST's sharded step run (one process:
    pp = 1); each new module's first line names its origin."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PP_SRC, REPO, *PP_MODULES],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[-1] == str(len(PP_MODULES))
    for name in PP_MODULES[:2]:
        rel = name.replace("horovod_tpu_torch.", "").replace(".", os.sep)
        first = open(os.path.join(PKG, rel + ".py")).readline()
        assert first.startswith("# Ported from horovod_tpu/parallel/"), \
            (name, first)


def test_torch_pipeline_exchanges_run_through_the_mesh():
    """``parallel/pipeline.py`` issues no torch.distributed call: its
    exchanges are the mesh's one-sided hop (``send_recv``) and its sum
    (``ReduceOutput``), each on the pipeline's own ``mesh`` and ``axis``,
    so that they run on the mesh's pp group
    (``test_torch_mesh_exchanges_run_on_mesh_groups`` holds those)."""
    path = os.path.join(PKG, "parallel", "pipeline.py")
    assert not _collective_calls(path)
    tree = ast.parse(open(path).read(), path)
    assert not [n for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                and "distributed" in ast.unparse(n)]
    found = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = ast.unparse(node.func)
        if name in ("send_recv", "ReduceOutput.apply"):
            args = [ast.unparse(a) for a in node.args]
            found.append(name)
            assert args[1:3] == ["mesh", "axis"], (node.lineno, args)
    assert sorted(found) == ["ReduceOutput.apply", "send_recv",
                             "send_recv"], found


# The serving surface: the Hugging Face converter and the generation
# example, ported from JAX modules that import JAX.
SERVING_MODULES = ("horovod_tpu_torch.models.convert",
                   "horovod_tpu_torch.examples.llama_generate")

_SERVING_SRC = _OBSERVE_SRC.replace("print('PURE', len(sys.argv) - 2)", r"""
import torch
from horovod_tpu_torch.examples import llama_generate
from horovod_tpu_torch.models import convert, llama
cfg = llama.tiny(dtype=torch.float32, sliding_window=4, rolling_cache=True)
params = llama.init_params(cfg, torch.Generator().manual_seed(0))
back = convert.from_hf_state_dict(convert.to_hf_state_dict(params, cfg), cfg)
assert all(torch.equal(a, b) for a, b in zip(
    params["layers"][1].values(), back["layers"][1].values()))
llama_generate.main(["--tiny", "--cpu", "--n-draft", "2", "--n-tokens",
                     "6"])
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', len(sys.argv) - 2)
""")


def test_torch_serving_modules_stand_alone():
    """The converter and the generation example import with JAX and
    horovod_tpu blocked; a round trip through Hugging Face names is
    bitwise, and the example decodes speculatively on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _SERVING_SRC, REPO,
                          *SERVING_MODULES], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "DONE tokens=12" in res.stdout
    assert res.stdout.split()[-1] == str(len(SERVING_MODULES))


# The collective analyzer: copies of the jax-free ``horovod_tpu/analysis``
# modules (``trace_check`` a torch.fx walk of its own), each importing with
# JAX and horovod_tpu blocked.
ANALYSIS_MODULES = tuple(
    "horovod_tpu_torch.analysis" + m for m in (
        "", ".findings", ".collective_lint", ".callgraph", ".whole_package",
        ".baseline", ".sarif", ".gate", ".hooks", ".__main__",
        ".runtime_sanitizer", ".trace_check"))

_ANALYSIS_SRC = _OBSERVE_SRC.replace("print('PURE', len(sys.argv) - 2)", r"""
import torch
from horovod_tpu_torch.analysis import lint_source, trace_check
from horovod_tpu_torch.parallel.mesh import psum
fs = lint_source("import torch.distributed as dist\n"
                 "if dist.get_rank() == 0:\n    dist.all_reduce(t)\n")
assert [f.rule for f in fs] == ['HVD101'], fs
mesh = trace_check.AbstractMesh({'tp': 2})
rep = trace_check.check_step_fn(lambda x: psum(x * 2, mesh, 'tp'),
                                torch.ones(3), mesh=mesh)
assert rep.ok and [r.digest() for r in rep.ledger] == [
    "psum|tp|((3,),)|('float32',)|None"], rep
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', len(sys.argv) - 2)
""")


def test_torch_analysis_modules_import_without_jax():
    """``horovod_tpu_torch.analysis`` and every submodule, ``trace_check``
    included, import with JAX and horovod_tpu blocked; the lint and an
    audit run there; each copied module's first line names its origin."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _ANALYSIS_SRC, REPO,
                          *ANALYSIS_MODULES], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[-1] == str(len(ANALYSIS_MODULES))
    for name in ANALYSIS_MODULES:
        rel = name.replace("horovod_tpu_torch.", "").replace(".", os.sep)
        path = os.path.join(PKG, rel + ".py")
        if not os.path.exists(path):
            path = os.path.join(PKG, rel, "__init__.py")
        first = open(path).readline()
        src = os.path.relpath(path, PKG)
        word = "Ported" if name.endswith("trace_check") else "Copied"
        assert first.startswith(f"# {word} from horovod_tpu/{src}:1-"), \
            (path, first)


# The last modules: training-loop callbacks and data helpers, the
# TensorFlow and Keras bindings, Spark and Ray.  Each imports with JAX and
# horovod_tpu blocked, and ``import horovod_tpu_torch`` brings in none of
# tensorflow, keras, pyspark or ray.
LAST_MODULES = tuple("horovod_tpu_torch." + m for m in (
    "callbacks", "data", "tensorflow.compression", "tensorflow.mpi_ops",
    "tensorflow", "keras.callbacks", "keras", "spark.store",
    "ray.strategy", "ray.runner", "ray.elastic", "ray", "spark.estimator",
    "spark"))
COPIED_LAST = ("horovod_tpu_torch.spark.store",
               "horovod_tpu_torch.ray.strategy", "horovod_tpu_torch.ray")

_LAST_SRC = _OBSERVE_SRC.replace("import importlib\n", r"""
import importlib
import horovod_tpu_torch
heavy = [m for m in ('tensorflow', 'keras', 'pyspark', 'ray')
         if m in sys.modules]
assert not heavy, heavy
""").replace("print('PURE', len(sys.argv) - 2)", r"""
import torch
from horovod_tpu_torch import callbacks, data
horovod_tpu_torch.init(device='cpu')
st = type('S', (), {})()
st.lr = 0.0
callbacks.LearningRateWarmupCallback(0.1, 2).on_epoch_begin(1, st)
assert st.lr == 0.1, st.lr
(x,) = next(iter(data.ShardedBatchIterator([list(range(8))], 4, seed=1)))
assert isinstance(x, torch.Tensor) and x.shape == (4,)
import horovod_tpu_torch.tensorflow as tfhvd
import tensorflow as tf
out = tfhvd.allreduce(tf.constant([1.0, 2.0]), name='pure')
assert out.numpy().tolist() == [1.0, 2.0], out
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')
       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]
assert not bad, bad
print('PURE', len(sys.argv) - 2)
""")


def test_torch_last_modules_import_without_jax():
    """The fourteen modules of the last slice import with JAX and
    horovod_tpu blocked (TensorFlow and Keras too, which try JAX and do
    without it), after ``import horovod_tpu_torch`` has imported none of
    tensorflow, keras, pyspark or ray; a warmup, a batch and a TF
    allreduce through the engine run there."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["KERAS_BACKEND"] = "tensorflow"
    res = subprocess.run([sys.executable, "-c", _LAST_SRC, REPO,
                          *LAST_MODULES], capture_output=True, text=True,
                         env=env, timeout=180)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.split()[-1] == str(len(LAST_MODULES))
    for name in LAST_MODULES:
        rel = name.replace("horovod_tpu_torch.", "").replace(".", os.sep)
        path = os.path.join(PKG, rel + ".py")
        if not os.path.exists(path):
            path = os.path.join(PKG, rel, "__init__.py")
        first = open(path).readline()
        src = os.path.relpath(path, PKG)
        word = "Copied" if name in COPIED_LAST else "Ported"
        assert first.startswith(f"# {word} from horovod_tpu/{src}:1-"), \
            (path, first)


# The modules of horovod_tpu/ with no counterpart in the port, and why:
# ROADMAP.md's no-counterpart list.  Every other module of horovod_tpu/
# has one at the same path.
NO_COUNTERPART = {
    "compat.py": "JAX-version glue",
    "jax/__init__.py": "the JAX binding",
    "jax/compression.py": "the JAX binding",
    "jax/optimizer.py": "the JAX binding",
    "ops/bridge.py": "single-controller stacking; the TF binding hands "
                     "tensors over by DLPack (tensorflow/mpi_ops.py)",
    "runner/tpu_vm.py": "the TPU VM launcher",
    "torch/__init__.py": "the JAX package's torch binding: the port's "
                         "top-level package is its counterpart",
    "torch/compression.py": "counterpart: compression.py",
    "torch/functions.py": "counterpart: functions.py",
    "torch/mpi_ops.py": "counterpart: mpi_ops.py",
    "torch/optimizer.py": "counterpart: optimizer.py",
    "torch/sync_batch_norm.py": "counterpart: sync_batch_norm.py",
    "torch/elastic/__init__.py": "counterpart: elastic/__init__.py",
    "torch/elastic/sampler.py": "counterpart: elastic/sampler.py",
    "torch/elastic/state.py": "counterpart: elastic/state.py",
}
# Parts of modules that have a counterpart, left out of it, and why.
NO_COUNTERPART_NAMES = {
    "spark/estimator.py": {"JaxEstimator": "a JAX training function",
                           "JaxModel": "a JAX training function"},
    "data/__init__.py": {
        "ShardedBatchIterator._global_batch": "single-controller global "
                                              "batches: one process is one "
                                              "rank in the port"},
    "elastic/discovery.py": {"TPUMetadataDiscovery": "TPU metadata"},
    "ops/eager.py": {n: "single-controller mode" for n in (
        "stack_per_rank", "replicated", "to_local", "to_global",
        "per_process_mode", "broadcast_pytree")},
}


def _py_modules(root):
    return {os.path.relpath(os.path.join(d, n), root)
            for d, _, names in os.walk(root) for n in names
            if n.endswith(".py")}


def _names(path):
    """Top-level classes and functions of a file, and each class's
    methods as ``Class.method``."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, ast.FunctionDef))
    return out


def test_torch_every_module_has_a_counterpart_or_a_reason():
    """Every module of horovod_tpu/ has a counterpart at its path in the
    port, or is in NO_COUNTERPART; every name NO_COUNTERPART_NAMES leaves
    out is in the JAX module and not in the port's, so that neither list
    goes stale."""
    ref = _py_modules(os.path.join(REPO, "horovod_tpu"))
    port = _py_modules(PKG)
    missing = sorted(ref - port - set(NO_COUNTERPART))
    assert not missing, missing
    stale = sorted(set(NO_COUNTERPART) - (ref - port))
    assert not stale, stale
    for rel, names in NO_COUNTERPART_NAMES.items():
        jax_names = _names(os.path.join(REPO, "horovod_tpu", rel))
        port_names = _names(os.path.join(PKG, rel))
        for name in names:
            assert name in jax_names and name not in port_names, (rel, name)
