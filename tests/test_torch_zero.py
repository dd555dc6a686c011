"""The port's ZeRO-sharded optimizer against the JAX package's.

- The shard plan (``optimizer._make_shard_plan``) against the JAX
  ``_make_shard_plan`` field by field, over worlds 1-8 and several bucket
  sizes, on a tree with a non-divisible leaf, a scalar, an empty leaf and
  a bf16 leaf; the copied pad+slice helpers (``parallel/zero.py``) against
  ``horovod_tpu.parallel.zero``.
- Two gloo worlds through the port's launcher, of 2 and of 4 processes,
  with ``HOROVOD_PIPELINE_CHUNK`` giving three buckets: the port's eager
  ``sharded=True`` and ``sharded="full"`` over 5 steps of the same
  per-rank gradient streams, against the JAX in-graph
  ``parallel.zero.sharded_optimizer`` and ``full_sharded_optimizer`` (+
  ``gather_full_params``) under ``shard_map`` on 2 and 4 of the 8 virtual
  CPU devices: ``torch.optim.AdamW`` against ``optax.adamw`` (rtol 1e-5,
  atol 1e-6: the two libraries order the same arithmetic differently) and
  SGD with momentum against ``optax.sgd`` (rtol 1e-6, atol 1e-7).
- In the world of 2: both modes bitwise equal to the port's replicated
  ``sharded=False`` after 10 steps (float32 and bf16 leaves and an empty
  one), with AdamW and SGD, two param groups of different ``lr`` and an LR
  scheduler; optimizer-state and resident bytes at most half the
  replicated ones plus the padding slack; ``prefetch_overlapped >= 1``;
  the saveable the same on both ranks, round-tripping bitwise, its plan
  the JAX plan, and refused after shutdown with the JAX message.
- Engine and scheduler: the sharded digest token and the fusion keys of
  port entries against the JAX engine's, a joined rank's synthesized
  entry keyed as its peers' sharded entry, batching of sharded, unsharded
  and prefetch entries against the JAX engine's (a sharded and an
  unsharded entry never fuse), the prefetch lane's pops against the JAX
  scheduler's on the same heaps; the refusals raise the JAX errors.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.common.controller import TCPController as JaxController
from horovod_tpu.compat import shard_map
from horovod_tpu.jax import optimizer as jopt
from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops import engine as jengine
from horovod_tpu.ops import scheduler as jsched
from horovod_tpu.parallel import zero as jzero
from horovod_tpu.parallel.mesh import make_mesh
from horovod_tpu_torch import optimizer as popt
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.controller import TCPController
from horovod_tpu_torch.common.process_sets import ProcessSetTable
from horovod_tpu_torch.compression import Compression as PCompression
from horovod_tpu_torch.ops import collectives as PC
from horovod_tpu_torch.ops import engine as pengine
from horovod_tpu_torch.ops import scheduler as psched
from horovod_tpu_torch.parallel import zero as pzero

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 600          # HOROVOD_PIPELINE_CHUNK of the worlds: three buckets
STEPS_JAX = 5
ADAMW = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
SGD = dict(lr=0.1, momentum=0.9)
ADAMW_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_LEAF = 3        # the bf16 leaf of the world's tree
SGD_TOL = dict(rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------- the plan
def _tree_np():
    """Leaves as (numpy array, is_bf16): a non-divisible float32 leaf, a
    2-D one, a scalar, a bf16 leaf, an empty leaf and an int32 leaf."""
    rng = np.random.RandomState(0)
    return [(rng.randn(257).astype(np.float32), False),
            (rng.randn(16, 8).astype(np.float32), False),
            (np.asarray(0.25, np.float32), False),
            (rng.randn(66).astype(np.float32), True),
            (np.zeros((0, 3), np.float32), False),
            (np.arange(5, dtype=np.int32), False)]


def _jax_leaves(tree):
    return [jnp.asarray(a, jnp.bfloat16) if bf else jnp.asarray(a)
            for a, bf in tree]


def _port_leaves(tree):
    return [torch.from_numpy(a.copy()).to(torch.bfloat16) if bf
            else torch.from_numpy(a.copy()) for a, bf in tree]


@pytest.mark.parametrize("chunk", [0, 64, 600, 4096])
@pytest.mark.parametrize("world", range(1, 9))
def test_torch_shard_plan_matches_jax(world, chunk):
    """Every field of the plan, for every rank of the world."""
    tree = _tree_np()
    for rank in range(world):
        want = jopt._make_shard_plan(_jax_leaves(tree), world, rank, chunk)
        got = popt._make_shard_plan(_port_leaves(tree), world, rank, chunk)
        assert got._asdict() == want._asdict()


@pytest.mark.parametrize("chunk", [0, 600])
def test_torch_shard_plan_splits_at_param_groups(chunk):
    """Buckets never straddle two param groups, and inside each group
    they are the JAX plan of that group's leaves."""
    tree = _tree_np()
    groups = [0, 0, 1, 1, 1, 2]
    got = popt._make_shard_plan(_port_leaves(tree), 2, 0, chunk, groups)
    assert [i for b in got.buckets for i in b] == list(range(len(tree)))
    for b in got.buckets:
        assert len({groups[i] for i in b}) == 1
    for g in sorted(set(groups)):
        idx = [i for i, x in enumerate(groups) if x == g]
        want = jopt._make_shard_plan([_jax_leaves(tree)[i] for i in idx], 2,
                                     0, chunk)
        mine = [tuple(i - idx[0] for i in b) for b in got.buckets
                if groups[b[0]] == g]
        assert tuple(mine) == want.buckets


def test_torch_shard_helpers_match_jax():
    for world in range(1, 9):
        for n in range(0, 40):
            assert pzero.shard_info(n, world) == jzero.shard_info(n, world)
    rng = np.random.RandomState(1)
    for n, world in [(257, 2), (257, 4), (7, 8), (1, 3), (0, 2), (64, 4)]:
        a = rng.randn(n).astype(np.float32)
        b = a.astype(ml_dtypes.bfloat16)
        tb = torch.from_numpy(a).to(torch.bfloat16)
        shards, tshards = [], []
        for r in range(world):
            want = jzero.shard_slice_host(a, r, world)
            got = pzero.shard_slice_host(a, r, world)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            tgot = pzero.shard_slice_host(tb, r, world)
            assert tgot.view(torch.int16).numpy().tobytes() == \
                jzero.shard_slice_host(b, r, world).view(np.int16).tobytes()
            shards.append(got)
            tshards.append(tgot)
        assert np.array_equal(pzero.unshard_host(shards, n, (n,)),
                              jzero.unshard_host(shards, n, (n,)))
        assert torch.equal(pzero.unshard_host(tshards, n, (n,)), tb)


# ------------------------------------------------------------ the worlds
_PORT = textwrap.dedent("""
    import hashlib, pickle, sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    eng = basics._get_state().engine
    with open(sys.argv[2], "rb") as fh:
        spec = pickle.load(fh)
    out = {}

    def bits(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()

    def make(params, kind, mode, **kw):
        if kind == "adamw":
            inner = torch.optim.AdamW(params, lr=1e-2, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=0.01)
        else:
            inner = torch.optim.SGD(params, lr=0.1, momentum=0.9)
        return hvd.DistributedOptimizer(inner, sharded=mode, **kw)

    # (b) the same gradient streams as the JAX run.
    def run_jax_case(kind, mode):
        ps = [torch.from_numpy(a.copy()).requires_grad_()
              for a in spec["params"]]
        opt = make(ps, kind, mode)
        for s in range(len(spec["grads"])):
            if mode == "full":
                opt.gather_params()
            for p, g in zip(ps, spec["grads"][s][r]):
                p.grad = torch.from_numpy(g.copy())
            opt.step()
        if mode == "full":
            opt.gather_params()
        return [p.detach().numpy().copy() for p in ps]

    out["jax_cases"] = {(k, m): run_jax_case(k, m)
                        for k in ("adamw", "sgd") for m in (True, "full")}

    # (c) against the replicated path: tests/data/worker_sharded.py's tree
    # plus an empty leaf.
    def tree():
        return [torch.tensor(np.linspace(-1.0, 1.0, 257),
                             dtype=torch.float32).requires_grad_(),
                torch.tensor(np.linspace(0.5, -0.5, 128).reshape(16, 8),
                             dtype=torch.float32).requires_grad_(),
                torch.tensor(0.25, dtype=torch.float32).requires_grad_(),
                torch.tensor(np.linspace(-2.0, 2.0, 66), dtype=torch.float32
                             ).to(torch.bfloat16).requires_grad_(),
                torch.zeros((0, 3)).requires_grad_()]

    def grads(step):
        rng = np.random.RandomState(1000 * (r + 1) + step)
        f = [rng.randn(257), rng.randn(16, 8), np.asarray(rng.randn()),
             rng.randn(66)]
        g = [torch.from_numpy(np.asarray(x, np.float32)) for x in f]
        g[3] = g[3].to(torch.bfloat16)
        return g + [torch.zeros((0, 3))]

    def state_bytes(opt):
        if getattr(opt, "sharded", False):
            return opt.opt_state_bytes()
        return sum(v.numel() * v.element_size() for st in opt.state.values()
                   for v in st.values() if isinstance(v, torch.Tensor))

    def train(kind, mode, groups=False, sched=False, steps=10):
        ps = tree()
        params = ([dict(params=ps[:2], lr=1e-2), dict(params=ps[2:],
                                                        lr=3e-2)]
                  if groups else ps)
        opt = make(params, kind, mode)
        sch = (torch.optim.lr_scheduler.StepLR(opt, step_size=3, gamma=0.5)
               if sched else None)
        res = dict(resident=None)
        o0 = eng.prefetch_overlapped
        for s in range(steps):
            if mode == "full":
                opt.gather_params()
            for p, g in zip(ps, grads(s)):
                p.grad = g
            opt.step()
            if sch is not None:
                sch.step()
            if mode == "full" and s == steps - 1:
                res["resident"] = opt.resident_bytes()
                res["freed"] = [p.numel() for p in ps]
        if mode == "full":
            opt.gather_params()
        res.update(params=[bits(p) for p in ps],
                   state=state_bytes(opt), overlapped=eng.prefetch_overlapped
                   - o0, param_bytes=sum(p.numel() * p.element_size()
                                         for p in ps),
                   outer_lr=[g["lr"] for g in opt.param_groups])
        if mode:
            res["buckets"] = len(opt._plan.buckets)
            res["inner_lr"] = [o.param_groups[0]["lr"] for o in opt._inner]
            res["bucket_group"] = list(opt._bucket_group)
        return res

    if n == 2:
        d0 = eng.prefetch_dispatches
        out["parity"] = {(k, m, gr, sc): train(k, m, gr, sc)
                         for k in ("adamw", "sgd") for m in (False, True, "full")
                         for gr, sc in ((False, False), (True, True))}
        out["prefetch_dispatches"] = eng.prefetch_dispatches - d0

        # (d) the saveable.
        def sd_bits(opt):
            return [[(i, k, bits(v)) for i in sorted(sd["state"])
                     for k, v in sorted(sd["state"][i].items())
                     if isinstance(v, torch.Tensor)]
                    for sd in opt.state_dict()["buckets"]]

        def digest(saved):
            h = hashlib.sha256()
            for sd in saved["inner_states"]:
                for i in sorted(sd["state"]):
                    for k, v in sorted(sd["state"][i].items()):
                        h.update(f"{i}.{k}".encode() + bits(v))
            for b in saved.get("param_shards", []):
                for t in b:
                    h.update(bits(t))
            h.update(repr(saved["plan"]).encode())
            return h.hexdigest()

        out["saveable"] = {}
        for mode in (True, "full"):
            ps = tree()
            opt = make(ps, "adamw", mode)
            for s in range(3):
                if mode == "full":
                    opt.gather_params()
                for p, g in zip(ps, grads(s)):
                    p.grad = g
                opt.step()
            saved = opt.hvd_sharded_saveable()
            ps2 = tree()
            opt2 = make(ps2, "adamw", mode)
            loaded = opt2.load_sharded_saveable(saved)
            same = sd_bits(opt2) == sd_bits(opt)
            if mode == "full":
                same = same and all(bits(a) == bits(b) for a, b in
                                    zip(opt._shards, opt2._shards))
                opt.gather_params()
                opt2.gather_params()
                same = same and all(bits(a) == bits(b)
                                    for a, b in zip(ps, ps2))
            out["saveable"][mode] = dict(
                digest=digest(saved), loaded=loaded, same=same,
                plan=saved["plan"], marker=sorted(k for k in saved
                                                  if k.startswith("__")),
                other_world=hvd.load_sharded_saveable(saved, r, 3) is None,
                full_shards=[len(b) for b in saved.get("param_shards", [])])
    hvd.shutdown()
    if n == 2:
        try:
            opt.hvd_sharded_saveable()
            out["after_shutdown"] = None
        except RuntimeError as exc:
            out["after_shutdown"] = str(exc)
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("ZERO_OK", r)
""")


def _jax_inputs():
    """The JAX comparison's parameters and per-rank gradient streams
    (float32), for the widest world: the narrower takes its first ranks."""
    rng = np.random.RandomState(7)
    params = [rng.randn(13, 7).astype(np.float32),
              rng.randn(7).astype(np.float32),
              np.asarray(rng.randn(), np.float32),
              rng.randn(257).astype(np.float32)]
    grads = [[[np.asarray(rng.randn(*p.shape), np.float32) for p in params]
              for _ in range(4)] for _ in range(STEPS_JAX)]
    return params, grads


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Gloo worlds of 2 and 4 processes through the port's launcher, side
    by side; each rank's output by world."""
    tmp = tmp_path_factory.mktemp("zero")
    params, grads = _jax_inputs()
    (tmp / "port.py").write_text(_PORT)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env.update(PYTHONPATH=REPO, HOROVOD_PIPELINE_CHUNK=str(CHUNK))
    procs = {}
    for world in (2, 4):
        with open(tmp / f"ins{world}.pkl", "wb") as fh:
            pickle.dump(dict(params=params, grads=[
                [g[r] for r in range(world)] for g in grads]), fh)
        procs[world] = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(world), "--output-filename", str(tmp / f"logs{world}"),
             sys.executable, str(tmp / "port.py"), REPO,
             str(tmp / f"ins{world}.pkl"), str(tmp / f"out{world}")],
            env=env, cwd=str(tmp))
    out = {}
    try:
        for world, proc in procs.items():
            rc = proc.wait(timeout=240)
            logs = ""
            for r in range(world):
                for f in ("stdout", "stderr"):
                    p = tmp / f"logs{world}" / f"rank.{r}" / f
                    if p.exists():
                        logs += p.read_text()[-3000:]
            assert rc == 0, logs
            out[world] = []
            for r in range(world):
                with open(tmp / f"out{world}.{r}", "rb") as fh:
                    out[world].append(pickle.load(fh))
    finally:
        for proc in procs.values():
            proc.kill()
    return out


def _jax_run(kind, full, world):
    """The JAX in-graph optimizer under shard_map on ``world`` of the
    virtual CPU devices, over the same gradient streams: the parameters
    (``full``: ``gather_full_params`` of the resident shards)."""
    params_np, grads = _jax_inputs()
    mesh = make_mesh({"dp": world}, devices=jax.devices()[:world])
    inner = (optax.adamw(ADAMW["lr"], b1=ADAMW["b1"], b2=ADAMW["b2"],
                         eps=ADAMW["eps"],
                         weight_decay=ADAMW["weight_decay"])
             if kind == "adamw" else optax.sgd(SGD["lr"],
                                               momentum=SGD["momentum"]))
    params = [jnp.asarray(p) for p in params_np]
    if full:
        opt = jzero.full_sharded_optimizer(inner, axis_name="dp")
        state, specs = jzero.init_full_sharded_state(inner, params, mesh,
                                                     "dp")
    else:
        opt = jzero.sharded_optimizer(inner, axis_name="dp")
        state, specs = jzero.init_sharded_state(inner, params, mesh, "dp")
    nl = len(params)

    def step(p, st, *gs):
        u, st = opt.update([g.reshape(g.shape[1:]) for g in gs], st, p)
        return optax.apply_updates(p, u), st

    run = jax.jit(shard_map(step, mesh=mesh,
                            in_specs=(P(), specs) + (P("dp"),) * nl,
                            out_specs=(P(), specs), check_vma=False))
    for s in range(STEPS_JAX):
        gs = [jnp.stack([grads[s][r][i] for r in range(world)])
              for i in range(nl)]
        params, state = run(params, state, *gs)
    if full:
        params = jax.jit(shard_map(
            lambda st: jzero.gather_full_params(st, params_np, "dp"),
            mesh=mesh, in_specs=(specs,), out_specs=P(),
            check_vma=False))(state)
    return [np.asarray(p) for p in params]


@pytest.mark.parametrize("mode", [True, "full"], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("kind", ["adamw", "sgd"])
@pytest.mark.parametrize("world", [2, 4])
def test_torch_sharded_matches_jax_in_graph(worlds, world, kind, mode):
    """Every rank's parameters after 5 steps within the stated tolerance
    of the JAX in-graph optimizer's, and bitwise equal across ranks."""
    want = _jax_run(kind, mode == "full", world)
    tol = ADAMW_TOL if kind == "adamw" else SGD_TOL
    for out in worlds[world]:
        got = out["jax_cases"][(kind, mode)]
        for g, w, g0 in zip(got, want, worlds[world][0]["jax_cases"][
                (kind, mode)]):
            np.testing.assert_allclose(g, w, **tol)
            assert g.tobytes() == g0.tobytes()


@pytest.mark.parametrize("groups", [False, True],
                         ids=["one_group", "two_groups_and_scheduler"])
@pytest.mark.parametrize("mode", [True, "full"], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_torch_sharded_bitwise_equals_replicated(worlds, kind, mode, groups):
    """At two ranks, 10 steps: the parameters bitwise those of the
    replicated path on both ranks; with two param groups of different
    ``lr`` and a StepLR, the scheduler's lr reached every bucket.

    One exception, which is torch's CPU kernels' and not the optimizer's:
    SGD's ``param.add_(buf, alpha=-lr)`` on a bf16 tensor on the CPU
    rounds the elements of its scalar tail loop (past the last whole
    vector) otherwise than those of its vector loop, so where a shard's
    tail is not the whole leaf's an element may differ by one bf16 ulp
    (the 66-element leaf: element 32 ends rank 0's shard, element 64 sits
    in the whole leaf's tail).  The bf16 leaf under SGD is held to one
    ulp (rtol 2^-7); every float32 leaf, and AdamW's bf16 leaf, bitwise.
    On the card every element takes the same arithmetic: E9 and
    ``tests/test_torch_cuda.py`` hold bf16 bitwise there."""
    for out in worlds[2]:
        rep = out["parity"][(kind, False, groups, groups)]
        got = out["parity"][(kind, mode, groups, groups)]
        for i, (g, w) in enumerate(zip(got["params"], rep["params"])):
            if kind == "sgd" and i == BF16_LEAF:
                a, b = (np.frombuffer(x, np.int16).view(ml_dtypes.bfloat16)
                        .astype(np.float32) for x in (g, w))
                np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=0)
            else:
                assert g == w, i
        assert got["buckets"] >= 3
        assert got["outer_lr"] == rep["outer_lr"]
        assert got["inner_lr"] == [got["outer_lr"][g]
                                   for g in got["bucket_group"]]
        if groups:
            assert got["outer_lr"] == [1e-2 * 0.5 ** 3, 3e-2 * 0.5 ** 3]
            assert set(got["bucket_group"]) == {0, 1}


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_torch_sharded_bytes_are_a_world_th(worlds, kind):
    """Optimizer state (both modes) and, for FSDP between steps, the
    parameters and state a rank hold at most 1/2 of the replicated bytes
    plus the padding slack (tests/data/worker_sharded.py's bound); FSDP's
    full parameters are freed between steps."""
    world = 2
    for out in worlds[world]:
        rep = out["parity"][(kind, False, False, False)]
        n_leaves = 5
        slack = 2 * n_leaves * world * 8 + 64 * n_leaves
        for mode in (True, "full"):
            got = out["parity"][(kind, mode, False, False)]
            assert got["state"] <= rep["state"] / world + slack, \
                (got["state"], rep["state"])
        full = out["parity"][(kind, "full", False, False)]
        assert full["freed"] == [0, 0, 0, 0, 0]
        assert full["resident"] <= (rep["param_bytes"] + rep["state"]) \
            / world + slack, (full["resident"], rep)


def test_torch_fsdp_prefetch_overlaps(worlds):
    """With three buckets and depth 2, gathers are dispatched while an
    earlier bucket's gather is outstanding, on the prefetch lane."""
    for out in worlds[2]:
        got = out["parity"][("adamw", "full", False, False)]
        assert got["buckets"] >= 3
        assert got["overlapped"] >= 1
        assert out["prefetch_dispatches"] >= 1


@pytest.mark.parametrize("mode", [True, "full"], ids=["zero1", "fsdp"])
def test_torch_saveable_round_trips(worlds, mode):
    """The saveable is the same dict on both ranks (rank-invariant), loads
    bitwise into a new optimizer, its plan is the JAX plan of the same
    leaves with rank -1, its markers are the JAX ones, and another world
    size loads nothing."""
    outs = [o["saveable"][mode] for o in worlds[2]]
    assert outs[0]["digest"] == outs[1]["digest"]
    leaves = [jnp.asarray(np.linspace(-1.0, 1.0, 257), jnp.float32),
              jnp.asarray(np.linspace(0.5, -0.5, 128).reshape(16, 8),
                          jnp.float32),
              jnp.asarray(0.25, jnp.float32),
              jnp.asarray(np.linspace(-2.0, 2.0, 66), jnp.bfloat16),
              jnp.zeros((0, 3), jnp.float32)]
    want = jopt._make_shard_plan(leaves, 2, 0, CHUNK)._replace(rank=-1)
    markers = ["__hvd_sharded_opt__"] + (["__hvd_full_sharded__"]
                                         if mode == "full" else [])
    for o in outs:
        assert o["loaded"] and o["same"] and o["other_world"]
        assert o["plan"] == want._asdict()
        assert o["marker"] == sorted(markers)
        if mode == "full":
            assert o["full_shards"] == [len(b) for b in want.buckets]


def test_torch_saveable_refused_after_shutdown(worlds):
    """Without the live engine a state sharded over two ranks cannot be
    gathered: the JAX message."""
    plan = jopt._make_shard_plan([jnp.zeros(4)], 2, 0, 0)
    with pytest.raises(RuntimeError) as exc:
        jopt.ShardedOptimizerState([], plan).hvd_sharded_saveable()
    for out in worlds[2]:
        assert out["after_shutdown"] == str(exc.value)


# ---------------------------------------------------- engine and scheduler
def _entries(sharded, prefetch=False, ctype="ALLGATHER", shape=(6,)):
    je = jengine.TensorTableEntry(
        handle=1, name="t", ctype=getattr(jengine.CollectiveType, ctype),
        tensor=np.zeros((2,) + shape, np.float32),
        reduce_op=JC.ReduceOp.AVERAGE, sharded=sharded, prefetch=prefetch)
    pe = pengine.TensorTableEntry(
        handle=1, name="t", ctype=getattr(pengine.CollectiveType, ctype),
        tensor=torch.zeros(shape), reduce_op=PC.ReduceOp.AVERAGE,
        sharded=sharded, prefetch=prefetch)
    return je, pe


def _norm(key):
    return tuple(getattr(x, "name", x) for x in key)


@pytest.mark.parametrize("ctype", ["ALLGATHER", "REDUCESCATTER"])
@pytest.mark.parametrize("sharded,prefetch,token", [
    (False, False, None), (True, False, "sharded"),
    ("full", False, "sharded-full"), ("full", True, "sharded-full")])
def test_torch_sharded_digest_and_fusion_key(ctype, sharded, prefetch,
                                             token):
    """The digest is the JAX string, with the sharded token last (none
    when unsharded; prefetch is not in it); the fusion key is the JAX
    key, its partition count included."""
    je, pe = _entries(sharded, prefetch, ctype)
    d = TCPController._digest(pe)
    assert d == JaxController._digest(je)
    assert d.split("|")[8:] == ([token] if token else [])
    assert _norm(pengine._fusion_key(pe)) == _norm(jengine._fusion_key(je))


def _port_engine(world=2):
    table = ProcessSetTable()
    table.initialize(world, lambda ranks: None)
    return pengine.CollectiveEngine(types.SimpleNamespace(
        config=Config(), process_set_table=table,
        device=torch.device("cpu")))


@pytest.mark.parametrize("sharded", [False, True, "full"])
def test_torch_joined_rank_synthesizes_the_sharded_entry(sharded):
    """A joined rank's entry from a peer's digest carries the sharded
    flag, so its fusion key is its peers' (a prefetch gather's, but for
    the prefetch flag, which the digest does not carry)."""
    eng = _port_engine()
    for ctype in ("ALLGATHER", "REDUCESCATTER"):
        for prefetch in (False, True):
            _, pe = _entries(sharded, prefetch, ctype, shape=(4, 3))
            e = eng._synthesize_join_entry("t", TCPController._digest(pe))
            assert e.sharded == sharded and not e.prefetch
            assert pengine._fusion_key(e) == pengine._fusion_key(
                pengine.TensorTableEntry(
                    handle=2, name="t", ctype=pe.ctype, tensor=pe.tensor,
                    reduce_op=pe.reduce_op, sharded=sharded))


# (name, sharded, prefetch, group, priority)
FUSE_CASE = [("a", False, False, -1, 0), ("b", True, False, -1, 0),
             ("c", "full", False, -1, 0), ("d", False, False, -1, 0),
             ("e", True, False, -1, 0), ("f", "full", True, 0, 3),
             ("g", "full", True, 0, 3), ("h", "full", False, -1, 1),
             ("i", True, False, 1, 2), ("j", True, False, 1, 2),
             ("k", False, False, 2, 2), ("m", False, False, 2, 2)]


@pytest.mark.parametrize("ctype", ["ALLGATHER", "REDUCESCATTER"])
def test_torch_sharded_batching_matches_jax(ctype):
    """The same entries batch alike in both engines, and no batch mixes
    sharded values or prefetch flags: a sharded and an unsharded entry of
    the same shape never fuse."""
    from horovod_tpu.common.config import Config as JaxConfig
    jeng = jengine.CollectiveEngine(types.SimpleNamespace(
        config=JaxConfig(), timeline=None))
    peng = _port_engine()
    jents, pents = [], []
    for i, (name, sh, pf, gid, prio) in enumerate(FUSE_CASE):
        je, pe = _entries(sh, pf, ctype, shape=(8, 4))
        for e in (je, pe):
            e.handle, e.name, e.group_id, e.priority = i, name, gid, prio
        jents.append(je)
        pents.append(pe)
    jeng.queue.push_many(jents)
    peng.queue.push_many(pents)
    jb, _ = jeng._compute_response_list(jeng.queue.drain())
    pb, _ = peng._compute_response_list(peng.queue.drain())
    names = [[e.name for e in b] for b in pb]
    assert names == [[e.name for e in b] for b in jb]
    for b in pb:
        assert len({(e.sharded, e.prefetch) for e in b}) == 1
    assert len(names) == 4          # prefetch, True, unsharded, "full"


def test_torch_sharded_and_plain_scatter_run_apart():
    """At size 1 through the engine: a sharded and an unsharded
    reduce-scatter of the same shape submitted in one cycle are two
    batches, each with its own result."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import eager
    hvd.init(device="cpu")
    eng = basics._get_state().engine
    a, b = torch.arange(6.0), torch.arange(6.0) * 2
    n0 = eng.pipeline_dispatches
    h = [eng.enqueue("zero.plain", pengine.CollectiveType.REDUCESCATTER,
                     a, reduce_op=PC.ReduceOp.SUM),
         eng.enqueue("zero.sharded", pengine.CollectiveType.REDUCESCATTER,
                     b, reduce_op=PC.ReduceOp.SUM, sharded=True)]
    eng.kick()
    outs = [eager.synchronize(x) for x in h]
    assert eng.pipeline_dispatches - n0 == 2
    assert torch.equal(outs[0], a) and torch.equal(outs[1], b)


def test_torch_prefetch_lane_pops_like_jax():
    """On the same heaps of prefetch and fused batches, the port's
    ``pop_gradient_batches`` pops what the JAX scheduler pops, in its
    order: every prefetch batch first, outside the fused budget."""
    assert psched.PREFETCH_LANE == jsched.PREFETCH_LANE
    assert psched.FUSED_LANE == jsched.FUSED_LANE
    rng = np.random.RandomState(3)
    import heapq
    for trial in range(50):
        items = [(int(rng.choice([jsched.PREFETCH_LANE, jsched.FUSED_LANE])),
                  -int(rng.randint(0, 4)), seq, f"b{seq}")
                 for seq in range(int(rng.randint(1, 12)))]
        budget = int(rng.randint(1, 4))
        hj, hp = list(items), list(items)
        heapq.heapify(hj)
        heapq.heapify(hp)
        got = psched.pop_gradient_batches(hp, budget)
        assert got == jsched.pop_gradient_batches(hj, budget)
        assert hp == hj
        n_pf = sum(1 for it in items if it[0] == jsched.PREFETCH_LANE)
        assert sum(1 for b in got if b in {it[3] for it in items
                                           if it[0] == jsched.PREFETCH_LANE}
                   ) == n_pf
        assert len(got) - n_pf == min(budget, len(items) - n_pf)


# ------------------------------------------------------------- refusals
def _raised(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as exc:
        return type(exc), str(exc)
    return None


@pytest.mark.parametrize("sharded", [True, "full"])
def test_torch_sharded_refusals_match_jax(sharded):
    """What the JAX ``DistributedOptimizer`` refuses, the port refuses with
    the same error; an op other than Sum/Average with the JAX update's
    message (``horovod_tpu/jax/optimizer.py:486-487, 601-602``)."""
    p = [torch.zeros(4, requires_grad=True)]
    jinner = optax.adam(1e-2)
    for jkw, pkw in [
            (dict(sharded="yes"), dict(sharded="yes")),
            (dict(sharded=sharded, backward_passes_per_step=2),
             dict(sharded=sharded, backward_passes_per_step=2)),
            (dict(sharded=sharded, compression=jopt.Compression.fp16),
             dict(sharded=sharded, compression=PCompression.fp16)),
            (dict(sharded=sharded, compression=jopt.Compression.bf16),
             dict(sharded=sharded, compression=PCompression.bf16))]:
        want = _raised(lambda: jopt.DistributedOptimizer(jinner, **jkw))
        got = _raised(lambda: popt.DistributedOptimizer(
            torch.optim.Adam(p, lr=1e-2), **pkw))
        assert want is not None and got == want
    label = 'sharded="full"' if sharded == "full" else "sharded=True"
    for op in (PC.ReduceOp.MIN, PC.ReduceOp.ADASUM):
        got = _raised(lambda: popt.DistributedOptimizer(
            torch.optim.Adam(p, lr=1e-2), sharded=sharded, op=op))
        assert got == (ValueError, f"{label} supports SUM/AVERAGE, "
                                   f"not {op!r}")
    got = _raised(lambda: popt.DistributedOptimizer(
        torch.optim.Adam(p, lr=1e-2), sharded=sharded,
        gradient_predivide_factor=2.0))
    assert got[0] is ValueError and label in got[1]


def test_torch_sharded_default_reads_the_config(monkeypatch):
    """``sharded=None`` reads HOROVOD_SHARDED_PARAMS, then
    HOROVOD_SHARDED_OPTIMIZER, as the JAX binding does."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    hvd.init(device="cpu")
    st = basics._get_state()
    cfg = st.config
    try:
        for params, opt_flag, want in [(False, False, False),
                                       (False, True, True),
                                       (True, False, "full"),
                                       (True, True, "full")]:
            st.config = Config(sharded_params=params,
                               sharded_optimizer=opt_flag)
            p = [torch.zeros(4, requires_grad=True)]
            opt = hvd.DistributedOptimizer(torch.optim.SGD(p, lr=0.1))
            assert getattr(opt, "sharded", False) == want
    finally:
        st.config = cfg


def test_torch_shard_plan_reads_the_engines_live_chunk(monkeypatch):
    """The bucket bytes are the engine's live chunk knob, as the JAX
    binding reads them (``horovod_tpu/jax/optimizer.py:663-668``): once
    the autotuner (or anyone) moves ``engine.pipeline_chunk_bytes`` away
    from the config's, a new sharded optimizer buckets by the engine's."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
              "HOROVOD_PIPELINE_CHUNK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(basics, "_state", basics.GlobalState())
    hvd.init(device="cpu")
    try:
        st = basics._get_state()
        assert st.config.pipeline_chunk_bytes == 0
        st.engine.pipeline_chunk_bytes = 40          # 10 float32 a bucket
        p = [torch.zeros(10, requires_grad=True) for _ in range(4)]
        opt = hvd.DistributedOptimizer(torch.optim.SGD(p, lr=0.1),
                                       sharded=True)
        assert len(opt._plan.buckets) == 4
        st.engine.pipeline_chunk_bytes = 0           # one bucket a group
        opt = hvd.DistributedOptimizer(torch.optim.SGD(p, lr=0.1),
                                       sharded=True)
        assert len(opt._plan.buckets) == 1
    finally:
        hvd.shutdown()
