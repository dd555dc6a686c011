"""The port's two-level data plane against the JAX package's.

- The slice topology (``parallel/topology.py``, a copy) against
  ``horovod_tpu.parallel.topology`` on the same inputs, and the world's
  layout over hosts (``common/topology.py``) against the JAX ``Topology``'s
  ``local_rank_of``/``ranks_of_process``.
- ``parallel/hierarchical.py``'s functions on simulated ranks (threads in
  lock step, the legs over their groups) against the JAX functions under
  ``shard_map`` on a (cross, local) mesh of CPU devices.
- The three verdicts (``_hier_decision``, ``_hier_ag_decision``,
  ``_hier_bcast_decision``) against the JAX engine's on the same entries,
  knobs and topologies.
- A 4-process gloo world through the port's launcher with the three
  ``--hierarchical-*`` flags and ``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2``,
  against the JAX engine at world 4 with ``HOROVOD_SLICE_MAP=2`` (a
  subprocess with 4 CPU devices and the same knobs) and against the port's
  flat path.  Inputs are small integers: every order of the reduction
  gives the same bits, so every comparison is bitwise, as
  ``tests/test_hier_collectives.py`` holds the JAX engine.
"""

import dataclasses
import logging
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops import engine as jengine
from horovod_tpu.parallel import topology as jtopo
from horovod_tpu_torch.common import topology as ctopo
from horovod_tpu_torch.ops import collectives as PC
from horovod_tpu_torch.ops import engine as pengine
from horovod_tpu_torch.parallel import topology as ptopo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, LOCAL = 4, 2
DTYPES = ("float32", "bfloat16", "int32", "int16", "bool")
OPS = ("Sum", "Average", "Min", "Max")
ROOT = 3                     # in slice 1: the other slice from rank 0


# ------------------------------------------------------------ slice topology
def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except ValueError as exc:
        return ("raises", str(exc))
    return dataclasses.asdict(out) if dataclasses.is_dataclass(out) else out


@pytest.mark.parametrize("text,world", [
    ("4", 8), ("2,2,2,2", 8), ("", 8), ("0", 8), ("3", 8), ("4,5", 8),
    ("4,4,4", 8), ("2,2,4", 8), ("x", 8), ("-2", 8), ("2", 4)])
def test_torch_parse_slice_map_matches_jax(text, world):
    assert _outcome(ptopo.parse_slice_map, text, world) == \
        _outcome(jtopo.parse_slice_map, text, world)


@pytest.mark.parametrize("kw", [
    dict(world=8, slice_map="4"), dict(world=8, local_size=4),
    dict(world=8, local_counts=[4, 4]), dict(world=8),
    dict(world=2, slice_map="1"), dict(world=8, slice_map="5"),
    dict(world=6, local_counts=[2, 1, 3]),
    dict(world=6, local_counts=[2, 2, 2]), dict(world=4, local_size=2),
    dict(world=4, local_size=3), dict(world=3, local_size=1),
    dict(world=12, slice_map="4", local_size=6),
    dict(world=12, local_size=6, local_counts=[4, 4, 4]),
    dict(world=8, slice_map="2,6")], ids=repr)
def test_torch_slice_topology_matches_jax(kw):
    assert _outcome(ptopo.slice_topology, None, **kw) == \
        _outcome(jtopo.slice_topology, None, **kw)


@pytest.mark.parametrize("local,slices", [
    (4, 2), (3, 2), (4, 3), (1, 8), (8, 4), (2, 2), (2, 1)])
def test_torch_hier_bit_orders_matches_jax(local, slices):
    assert ptopo.hier_bit_orders(local, slices) == \
        jtopo.hier_bit_orders(local, slices)


@pytest.mark.parametrize("nbytes,world,local", [
    (1 << 20, 8, 4), (12345, 4, 2), (1, 16, 8), (0, 4, 2)])
def test_torch_wire_model_matches_jax(nbytes, world, local):
    assert ptopo.modeled_leg_bytes(nbytes, world, local) == \
        jtopo.modeled_leg_bytes(nbytes, world, local)
    assert ptopo.cross_fraction(nbytes, world, local) == \
        jtopo.cross_fraction(nbytes, world, local)


def test_torch_cross_ring_order_matches_jax():
    coords = ((0, 0, 0), (1, 0, 0), (4, 0, 0), (5, 0, 0), (2, 0, 0),
              (3, 0, 0))
    for c in (coords, None):
        assert ptopo._cross_ring_order((0, 2, 4), c) == \
            jtopo._cross_ring_order((0, 2, 4), c)


# ------------------------------------------------------- the world's layout
@pytest.mark.parametrize("counts", [(2, 1, 3), (4,), (2, 2), (1, 1, 1, 1)])
def test_torch_host_layout_matches_jax_topology(counts):
    """``local_rank_of`` and ``ranks_of_process`` of the port's host
    layout against the JAX ``Topology`` over devices with those process
    indices (a JAX process's devices are what a port host's ranks are)."""
    from horovod_tpu.common.topology import Topology as JaxTopology
    size = sum(counts)
    devs = [types.SimpleNamespace(process_index=p)
            for p, c in enumerate(counts) for _ in range(c)]
    jt = JaxTopology(devices=devs, mesh=None, axis_name="hvd",
                     local_counts=list(counts), my_process=0,
                     num_processes=len(counts))
    for rank in range(size):
        pt = ctopo.Topology(size=size, rank=rank, local_counts=counts)
        assert pt.local_rank_of == jt.local_rank_of
        assert pt.local_size == counts[pt.my_host]
        for h in range(len(counts)):
            assert pt.ranks_of_process(h) == jt.ranks_of_process(h)


def test_torch_local_counts_from_the_launcher(monkeypatch):
    """The list is the launcher's, the same on every rank: hosts of 2, 1
    and 3 ranks give no slices on any rank (2 x 3 = 6 would look uniform
    to the first host alone), hosts of 2, 2 and 2 give three slices."""
    assert ctopo.parse_local_counts("2,1,3", 6) == (2, 1, 3)
    assert ctopo.parse_local_counts("", 6) is None
    for bad in ("2,2", "a", "0,6", "3,-1,4"):
        with pytest.raises(ValueError):
            ctopo.parse_local_counts(bad, 6)
    monkeypatch.setenv(ctopo.LOCAL_COUNTS_ENV, "2,1,3")
    for rank in range(6):
        t = ctopo.build_topology(6, rank)
        assert ptopo.slice_topology(None, world=6,
                                    local_counts=t.local_counts) is None
    monkeypatch.setenv(ctopo.LOCAL_COUNTS_ENV, "2,2,2")
    st = ptopo.slice_topology(None, world=6, local_counts=ctopo.build_topology(
        6, 5).local_counts)
    assert (st.num_slices, st.local_size) == (3, 2)
    monkeypatch.delenv(ctopo.LOCAL_COUNTS_ENV)
    assert ctopo.build_topology(6, 0).local_counts is None
    assert ctopo.build_topology(1, 0).local_counts == (1,)


# ------------------------------------------- the functions, simulated ranks
class _Threads:
    """Ranks as threads: each group's collective gathers its members'
    tensors in lock step (a barrier of the group), so groups of one leg
    run side by side and a leg that only some ranks call works."""

    def __init__(self):
        self.lock, self.groups = threading.Lock(), {}

    def gather(self, rank, ranks, t):
        with self.lock:
            barrier, box = self.groups.setdefault(
                tuple(ranks), (threading.Barrier(len(ranks), timeout=30), {}))
        box[rank] = t.clone()
        barrier.wait()
        got = [box[r] for r in ranks]
        barrier.wait()
        return got

    def legs(self, rank, local, cross):
        from horovod_tpu_torch.parallel.hierarchical import Legs
        s, i = divmod(rank, local)
        lg = [s * local + j for j in range(local)]
        cg = [c * local + i for c in range(cross)]
        red = {"sum": lambda ts: torch.stack(ts).sum(0),
               "min": lambda ts: torch.stack(ts).min(0).values,
               "max": lambda ts: torch.stack(ts).max(0).values}

        def reduce_scatter(out, inp, op):
            out.copy_(red[op](self.gather(rank, lg, inp)).view(local, -1)[i])

        def all_reduce(t, op):
            t.copy_(red[op](self.gather(rank, cg, t)))
        return Legs(
            local, cross, i, s, reduce_scatter, all_reduce,
            lambda out, inp: out.copy_(torch.cat(self.gather(rank, lg, inp))),
            lambda out, inp: out.copy_(torch.cat(self.gather(rank, cg, inp))),
            lambda t, src: t.copy_(self.gather(rank, lg, t)[src]),
            lambda t, src: t.copy_(self.gather(rank, cg, t)[src]))


@pytest.mark.parametrize("cross,local", [(2, 2), (4, 2), (2, 4)])
def test_torch_hierarchical_functions_match_jax(cross, local):
    """Two-level sum (and average), min and max against the JAX
    functions on a (cross, local) mesh, bitwise (integer values; 23
    elements: the pad to the local size); allgather in world order and a
    broadcast from the last rank, bitwise."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.compat import shard_map
    from horovod_tpu.parallel import hierarchical as jh
    from horovod_tpu_torch.parallel import hierarchical as ph
    n = cross * local
    vals = np.random.RandomState(n + local).randint(-5, 6, (n, 23)).astype(
        np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(cross, local),
                ("cross", "local"))

    def jax_run(fn):
        return np.asarray(jax.jit(shard_map(
            lambda x: fn(x.reshape(x.shape[1:]))[None], mesh=mesh,
            in_specs=P(("cross", "local")), out_specs=P(("cross", "local")),
            check_vma=False))(jnp.asarray(vals)))

    want = {"sum": jax_run(lambda x: jh.hierarchical_allreduce(x)),
            "avg": jax_run(lambda x: jh.hierarchical_allreduce(
                x, average=True)),
            "min": jax_run(lambda x: jh.hierarchical_allreduce_minmax(
                x, "min")),
            "max": jax_run(lambda x: jh.hierarchical_allreduce_minmax(
                x, "max"))}
    world, outs = _Threads(), [None] * n

    def body(r):
        legs = world.legs(r, local, cross)
        x = torch.from_numpy(vals[r])
        outs[r] = {
            "sum": ph.hierarchical_allreduce(x, legs),
            "avg": ph.hierarchical_allreduce(x, legs, average=True),
            "min": ph.hierarchical_allreduce_minmax(x, "min", legs),
            "max": ph.hierarchical_allreduce_minmax(x, "max", legs),
            "ag": ph.hierarchical_allgather(x, legs),
            "bc": ph.hierarchical_broadcast(x.clone(), n - 1, legs)}
    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for r in range(n):
        for k, w in want.items():
            assert outs[r][k].numpy().tobytes() == w[r].tobytes(), (r, k)
        assert outs[r]["ag"].numpy().tobytes() == vals.tobytes()
        assert outs[r]["bc"].numpy().tobytes() == vals[-1].tobytes()
    with pytest.raises(ValueError, match="'min' or 'max'"):
        ph.hierarchical_allreduce_minmax(torch.zeros(2), "sum", None)


# ------------------------------------------------------------- the verdicts
_TOPOS = {"flat": None,
          "2x2": jtopo.slice_topology(None, world=4, local_size=2),
          "2x3": jtopo.slice_topology(None, world=6, local_size=3),
          "4x2": jtopo.slice_topology(None, world=8, local_size=2)}


def _verdict(mod, ops, kind, op, hier, knob, nbytes, threshold, topo):
    stub = types.SimpleNamespace(
        hierarchical_allreduce=knob, hierarchical_allgather=knob,
        hierarchical_broadcast=knob, hier_threshold_bytes=threshold,
        _slice_topology=lambda ps_id: topo)
    e0 = types.SimpleNamespace(ctype=mod.CollectiveType[kind],
                               reduce_op=ops.ReduceOp[op], hierarchical=hier,
                               process_set_id=0)
    eng = mod.CollectiveEngine
    if kind == "ALLGATHER":
        return eng._hier_ag_decision(stub, e0)
    if kind == "BROADCAST":
        return eng._hier_bcast_decision(stub, e0)
    return eng._hier_decision(stub, e0, nbytes)


@pytest.mark.parametrize("kind,op", [
    ("ALLREDUCE", op) for op in ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT",
                                 "ADASUM")] + [
    ("ALLGATHER", "AVERAGE"), ("BROADCAST", "AVERAGE"),
    ("REDUCESCATTER", "SUM")])
def test_torch_hier_verdicts_match_jax_engine(kind, op):
    """Every combination of the per-call override, the knob, the payload
    against the threshold and the topology (none, 2x2, a non-power-of-two
    local extent, 4x2) decides as the JAX engine does."""
    seen = set()
    for hier in (None, True, False):
        for knob in (False, True):
            for nbytes, threshold in ((100, 0), (100, 1000), (5000, 1000)):
                for name, topo in _TOPOS.items():
                    args = (kind, op, hier, knob, nbytes, threshold, topo)
                    want = _verdict(jengine, JC, *args)
                    got = _verdict(pengine, PC, *args)
                    assert got == want, (args[:-1], name)
                    seen.add(want)
    if kind not in ("REDUCESCATTER",) and op != "PRODUCT":
        assert seen == {True, False}


def _engine_alone(monkeypatch, world):
    """A port engine over a world of ``world`` ranks that runs no cycle
    (its checks read only the process set table)."""
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.common.process_sets import ProcessSetTable
    table = ProcessSetTable()
    table.initialize(world, lambda ranks: None)
    state = types.SimpleNamespace(config=Config(), process_set_table=table,
                                  device=torch.device("cpu"), size=world,
                                  rank=0, topology=None)
    return pengine.CollectiveEngine(state)


def test_torch_nonuniform_slice_map_falls_back_once(monkeypatch):
    """A non-uniform HOROVOD_SLICE_MAP logs ONE warning naming the sizes,
    counts one fallback (the probe is cached per process set), and keeps
    the world flat (JAX ``test_nonuniform_slice_map_falls_back_once``)."""
    from horovod_tpu_torch.utils.logging import get_logger
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = Capture(level=logging.WARNING)
    get_logger().addHandler(handler)
    try:
        eng = _engine_alone(monkeypatch, 8)
        eng.hierarchical_allreduce = True
        eng.slice_map = "2,6"
        assert eng._slice_topology(0) is None
        assert eng._slice_topology(0) is None
        assert eng.slice_map_fallbacks == 1
        warns = [r for r in records
                 if "HOROVOD_SLICE_MAP rejected" in r.getMessage()]
        assert len(warns) == 1 and "[2, 6]" in warns[0].getMessage()
        e = pengine.TensorTableEntry(
            handle=1, name="x", ctype=pengine.CollectiveType.ALLREDUCE,
            tensor=torch.zeros(4), reduce_op=PC.ReduceOp.SUM)
        assert eng._hier_verdict([e]) is False
        assert eng.hier_dispatches == 0
        # Subgroup process sets keep the flat path, as in the JAX engine.
        eng.slice_map = "4"
        eng._slice_topos.clear()
        assert eng._slice_topology(0).num_slices == 2
        assert eng._slice_topology(1) is None
    finally:
        get_logger().removeHandler(handler)


# ---------------------------------------------------- a 4-process gloo world
def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _inputs(rank):
    """Rank ``rank``'s seeded inputs: small integers (exact sums, bf16
    included), bools for bool."""
    rng = np.random.RandomState(300 + 17 * rank)

    def ints(shape, dt):
        if dt == "bool":
            return rng.randint(0, 2, shape).astype(bool)
        return rng.randint(-3, 4, shape).astype(_np_dtype(dt))
    return {
        "ar": {dt: ints((33,), dt) for dt in DTYPES},
        "group": [ints((257,), "float32"), ints((2, 2), "bfloat16"),
                  ints((1,), "float32")],
        "ag": [ints((33,), "float32"), ints((4, 5), "int32")],
        "bc": [ints((7,), "int32"), ints((2, 3), "bool"),
               rng.randn(5).astype(np.float32) * (rank + 1)],
        "small": ints((8,), "float32"),
    }


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


_PORT = textwrap.dedent("""
    import pickle, sys
    import ml_dtypes, numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import eager
    from horovod_tpu_torch.ops.engine import CollectiveType
    hvd.init(device="cpu")
    r = hvd.rank()
    eng = hvd.common.basics._get_state().engine
    with open(sys.argv[2], "rb") as fh:
        ins = pickle.load(fh)[r]

    def T(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    def N(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    def legs():
        return [eng.hier_dispatches, eng.hier_intra_legs,
                eng.hier_cross_legs, eng.hier_ag_dispatches,
                eng.hier_ag_intra_legs, eng.hier_ag_cross_legs,
                eng.hier_bcast_dispatches, eng.hier_bcast_intra_legs,
                eng.hier_bcast_cross_legs]

    def flat(ctype, t, i, **kw):
        return eng.synchronize(eng.enqueue(f"flat.{ctype.value}.{i}", ctype,
                                           t, hierarchical=False, **kw))

    st = eng._slice_topology(0)
    out = {"topo": (st.num_slices, st.local_size), "groups":
           eng._hier is not None}
    for dt, x in ins["ar"].items():
        for op in ("Sum", "Average", "Min", "Max"):
            c0 = legs()
            h = eager.allreduce(T(x), name=f"h.{dt}.{op}",
                                op=getattr(hvd, op))
            c1 = legs()
            f = eager.allreduce(T(x), name=f"f.{dt}.{op}",
                                op=getattr(hvd, op), hierarchical=False)
            out[("ar", dt, op)] = (N(h), N(f),
                                   [b - a for a, b in zip(c0, c1)],
                                   [b - a for a, b in zip(c1, legs())])
    c0 = legs()
    h = eager.grouped_allreduce([T(a) for a in ins["group"]], name="gh",
                                op=hvd.Sum)
    c1 = legs()
    f = eager.grouped_allreduce([T(a) for a in ins["group"]], name="gf",
                                op=hvd.Sum, hierarchical=False)
    out["group"] = ([N(t) for t in h], [N(t) for t in f],
                    [b - a for a, b in zip(c0, c1)])
    c0 = legs()
    h = hvd.grouped_allgather([T(a) for a in ins["ag"]], name="agh")
    c1 = legs()
    f = [flat(CollectiveType.ALLGATHER, T(a), i)
         for i, a in enumerate(ins["ag"])]
    out["ag"] = ([N(t) for t in h], [N(t) for t in f],
                 [b - a for a, b in zip(c0, c1)])
    c0 = legs()
    h = [hvd.broadcast(T(a), root_rank=3, name=f"bch.{i}")
         for i, a in enumerate(ins["bc"])]
    c1 = legs()
    f = [flat(CollectiveType.BROADCAST, T(a), i, root_rank=3)
         for i, a in enumerate(ins["bc"])]
    out["bc"] = ([N(t) for t in h], [N(t) for t in f],
                 [b - a for a, b in zip(c0, c1)])
    # The crossover: under the threshold flat, the override forces it.
    eng.hier_threshold_bytes = 1 << 20
    c0 = legs()
    eager.allreduce(T(ins["small"]), name="small", op=hvd.Sum)
    c1 = legs()
    forced = eager.allreduce(T(ins["small"]), name="forced", op=hvd.Sum,
                             hierarchical=True)
    c2 = legs()
    eng.hier_threshold_bytes = 0
    pinned = eager.allreduce(T(ins["small"]), name="pinned", op=hvd.Sum,
                             hierarchical=False)
    out["threshold"] = ([b - a for a, b in zip(c0, c1)],
                        [b - a for a, b in zip(c1, c2)],
                        [b - a for a, b in zip(c2, legs())],
                        N(forced), N(pinned))
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("HIER_OK", r)
""")

_JAX = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    import jax
    jax.config.update("jax_platforms", "cpu")
    import horovod_tpu as hvd
    from horovod_tpu.ops import eager
    hvd.init()
    assert hvd.size() == 4
    eng = eager._engine()
    assert eng._slice_topology(0) is not None
    with open(sys.argv[2], "rb") as fh:
        ins = pickle.load(fh)

    def run(fn):
        try:
            return np.asarray(fn())
        except Exception as exc:
            return ("raises", type(exc).__name__)

    out = {}
    for dt in ins[0]["ar"]:
        xs = hvd.stack_per_rank([i["ar"][dt] for i in ins])
        for op in ("Sum", "Average", "Min", "Max"):
            out[("ar", dt, op)] = (
                run(lambda: hvd.allreduce(xs, name=f"h.{dt}.{op}",
                                          op=getattr(hvd, op))),
                run(lambda: hvd.allreduce(xs, name=f"f.{dt}.{op}",
                                          op=getattr(hvd, op),
                                          hierarchical=False)))
    out["group"] = [np.asarray(o) for o in hvd.grouped_allreduce(
        [hvd.stack_per_rank([i["group"][k] for i in ins]) for k in range(3)],
        name="g", op=hvd.Sum)]
    out["ag"] = [np.asarray(o) for o in hvd.grouped_allgather(
        [hvd.stack_per_rank([i["ag"][k] for i in ins]) for k in range(2)],
        name="ag")]
    out["bc"] = [np.asarray(hvd.broadcast(
        hvd.stack_per_rank([i["bc"][k] for i in ins]), root_rank=3,
        name=f"bc.{k}")) for k in range(3)]
    out["legs"] = [eng.hier_dispatches, eng.hier_ag_dispatches,
                   eng.hier_bcast_dispatches]
    with open(sys.argv[3], "wb") as fh:
        pickle.dump(out, fh)
    print("JAX_OK")
""")


def _jax_env(tmp_dir):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    env.update(XLA_FLAGS=" ".join(
        flags + [f"--xla_force_host_platform_device_count={WORLD}"]),
        JAX_PLATFORMS="cpu", HOROVOD_SLICE_MAP=str(LOCAL),
        HOROVOD_HIERARCHICAL_ALLREDUCE="1",
        HOROVOD_HIERARCHICAL_ALLGATHER="1",
        HOROVOD_HIERARCHICAL_BROADCAST="1")
    return env


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's gloo world of 4 and the JAX engine at world 4, side by
    side, on the same inputs."""
    tmp = tmp_path_factory.mktemp("hier")
    with open(tmp / "ins.pkl", "wb") as fh:
        pickle.dump([_inputs(r) for r in range(WORLD)], fh)
    (tmp / "port.py").write_text(_PORT)
    (tmp / "jax_ref.py").write_text(_JAX)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env.update(PYTHONPATH=REPO, HOROVOD_HIERARCHICAL_LOCAL_SIZE=str(LOCAL))
    port = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(WORLD), "--hierarchical-allreduce", "--hierarchical-allgather",
         "--hierarchical-broadcast", "--output-filename", str(tmp / "logs"),
         sys.executable, str(tmp / "port.py"), REPO, str(tmp / "ins.pkl"),
         str(tmp / "out")], env=env, cwd=str(tmp))
    jax_proc = subprocess.Popen(
        [sys.executable, str(tmp / "jax_ref.py"), REPO, str(tmp / "ins.pkl"),
         str(tmp / "jax.pkl")], env=_jax_env(tmp), cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        rc = port.wait(timeout=240)
        jax_log = jax_proc.communicate(timeout=240)[0]
    finally:
        port.kill()
        jax_proc.kill()
    logs = ""
    for r in range(WORLD):
        for f in ("stdout", "stderr"):
            p = tmp / "logs" / f"rank.{r}" / f
            if p.exists():
                logs += p.read_text()[-2000:]
    assert rc == 0, logs
    assert jax_proc.returncode == 0, jax_log
    port_out = []
    for r in range(WORLD):
        with open(tmp / f"out.{r}", "rb") as fh:
            port_out.append(pickle.load(fh))
    with open(tmp / "jax.pkl", "rb") as fh:
        jax_out = pickle.load(fh)
    return port_out, jax_out


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape,
                                                       b.dtype, b.shape)
    assert a.tobytes() == b.tobytes(), (a, b)


def test_torch_hier_world_has_two_slices_and_groups(worlds):
    port, _ = worlds
    for out in port:
        assert out["topo"] == (WORLD // LOCAL, LOCAL) and out["groups"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", DTYPES)
def test_torch_hier_allreduce_matches_jax_and_flat(worlds, dt, op):
    """Two-level bitwise the port's flat path on every rank, one leg
    count each (1 dispatch, 2 local and 1 cross leg; flat none), and
    bitwise the JAX engine's two-level result.  A bool Sum/Average, which
    the JAX two-level program refuses (its psum_scatter adds no bool;
    ROADMAP queue 3), gives the JAX flat path's int32 counts."""
    port, jax_out = worlds
    jh, jf = jax_out[("ar", dt, op)]
    for out in port:
        h, f, legs, flat_legs = out[("ar", dt, op)]
        _same(h, f)
        _same(h, port[0][("ar", dt, op)][0])
        assert legs[:3] == [1, 2, 1] and flat_legs == [0] * 9
        if dt == "bool" and op in ("Sum", "Average"):
            assert jh == ("raises", "TypeError")
            _same(h, jf)
        else:
            _same(h, jh)
            _same(h, jf)


def test_torch_hier_grouped_mixed_dtypes(worlds):
    """A grouped fp32 + bf16 + one-element batch: one two-level dispatch
    (a leg set for the batch, whatever its dtype groups), bitwise flat and
    the JAX engine."""
    port, jax_out = worlds
    for out in port:
        h, f, legs = out["group"]
        assert legs[:3] == [1, 2, 1]
        for a, b, c in zip(h, f, jax_out["group"]):
            _same(a, b)
            _same(a, c)


def test_torch_hier_allgather_matches_jax_and_flat(worlds):
    port, jax_out = worlds
    for out in port:
        h, f, legs = out["ag"]
        assert legs[3:6] == [1, 1, 1]
        for a, b, c in zip(h, f, jax_out["ag"]):
            _same(a, b)
            _same(a, c)


def test_torch_hier_broadcast_cross_slice_root(worlds):
    """Root 3 lives in slice 1: its cross leg and the fan-out deliver its
    bytes (int32, bool, float32) to every rank, as flat and the JAX engine
    (whose rows are all root's)."""
    port, jax_out = worlds
    want = _inputs(ROOT)["bc"]
    for out in port:
        h, f, legs = out["bc"]
        assert legs[6:9] == [3, 3, 3]
        for a, b, c, w in zip(h, f, jax_out["bc"], want):
            _same(a, b)
            _same(a, w)
            _same(a, c)


def test_torch_hier_threshold_crossover_and_overrides(worlds):
    """Under HOROVOD_HIER_THRESHOLD a batch dispatches flat; the per-call
    ``hierarchical=True`` forces two-level; ``hierarchical=False`` pins
    flat with the mode armed and the payload over the threshold."""
    port, _ = worlds
    want = sum(i["small"] for i in map(_inputs, range(WORLD)))
    for out in port:
        under, forced, pinned, forced_v, pinned_v = out["threshold"]
        assert under[:3] == [0, 0, 0]
        assert forced[:3] == [1, 2, 1]
        assert pinned[:3] == [0, 0, 0]
        _same(forced_v, want)
        _same(pinned_v, want)
