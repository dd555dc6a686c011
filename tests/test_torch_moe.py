"""Port parity: the mixture-of-experts slice against the JAX package.

In this process, ep off: ``_route``'s dense masks against
``horovod_tpu.models.moe._route`` (top-1, top-2, expert choice; the
dispatch mask bitwise, the gate-weighted combine mask, the aux loss and
the z-loss within 1e-6: XLA's and torch's ``exp`` differ in the last bit),
``moe_ffn`` values and gradients within rtol 2e-4 / atol 2e-5, capacity
drops as the identity, a top-2 output as a convex mixture, the refusals.

Two gloo worlds, of 2 and 4 processes (one world each, side by side), run
the port on seeded numpy inputs, each rank its block of the tokens (dp
major, ep fastest, as ``P(("dp", "ep"))``), against the JAX package under
``shard_map`` on 2 and 4 of the 8 virtual CPU devices:

- ``moe_ffn`` at ep = 2 and 4, gated and not, top-1, top-2 and expert
  choice, with capacity drops: values and gradients of ``Σ(y²) + aux + z``
  within rtol 2e-4 / atol 2e-5 (the router's gradient summed over the
  ranks, the slabs' concatenated);
- two SGD steps of the MoE LM at (ep, dp) = (2, 1), (2, 2), (4, 1) with
  ``aux_weight`` 0 against the unsharded JAX run: losses within rtol 2e-4,
  parameters within rtol 3e-3 / atol 3e-5 (``tests/test_llama_parallel.py``
  :203's tolerances); with aux > 0, top-2 and the z-loss against the JAX
  *sharded* run (the aux loss is per shard);
- the gradient rule (slab gradients scaled by 1/ep and averaged only over
  the ranks holding the same slab), the broadcast (no slab crosses an ep
  coordinate), router noise's contract, and the example under the port's
  launcher.
"""

import functools
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.models import moe as jm
from horovod_tpu.parallel import spmd
from horovod_tpu_torch.common.net import free_ports
from horovod_tpu_torch.models import moe as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL_TOL = dict(rtol=2e-4, atol=2e-5)
MASK_TOL = dict(rtol=0, atol=1e-6)
D, F, E = 16, 32, 4
# (router_mode, top_k, gated) for moe_ffn.
FFN_CASES = [("tokens", 1, False), ("tokens", 2, True),
             ("expert_choice", 1, False), ("tokens", 1, True)]
# (ep, dp) meshes of the LM runs, by world.
LM_MESHES = {2: [(2, 1)], 4: [(2, 2), (4, 1)]}
AUX = dict(aux_weight=0.05, top_k=2, z_weight=1e-3)


def _kw(mode, k, gated, cf):
    return dict(d_model=D, d_ff=F, n_experts=E, capacity_factor=cf,
                router_mode=mode, router_top_k=k, gated=gated)


def _jcfg(mode, k, gated, cf=1.0, ep_axis=None):
    return jm.MoEConfig(ep_axis=ep_axis, **_kw(mode, k, gated, cf))


def _tcfg(mode, k, gated, cf=1.0, ep_axis=None):
    return tm.MoEConfig(ep_axis=ep_axis, **_kw(mode, k, gated, cf))


def _x(S=32, seed=2):
    return np.random.RandomState(seed).randn(S, D).astype(np.float32)


def _ffn_params(gated, seed=1):
    cfg = _jcfg("tokens", 1, gated)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(cfg, jax.random.PRNGKey(seed)))


def _lm_cfg(jax_side, ep_axis, dp_axis, aux_weight=0.0, top_k=1,
            z_weight=0.0):
    """``tests/test_moe.py``'s ``_cfg``: capacity_factor 8 = n_experts, no
    drops, so sharded and unsharded runs keep the same tokens."""
    mod = jm if jax_side else tm
    return mod.MoELMConfig(
        vocab_size=64, d_model=32, n_layers=2,
        moe=mod.MoEConfig(d_model=32, d_ff=64, n_experts=8,
                          capacity_factor=8.0, router_top_k=top_k,
                          router_z_weight=z_weight, ep_axis=ep_axis),
        aux_weight=aux_weight, dp_axis=dp_axis)


def _lm_data(batch=16, seq=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 64, (batch, seq)).astype(np.int32),
            rng.randint(0, 64, (batch, seq)).astype(np.int32))


def _lm_params():
    cfg = _lm_cfg(True, None, None)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.lm_init(cfg, jax.random.PRNGKey(0)))


# ------------------------------------------------------------ the worlds
_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama as tl, moe as tm
    from horovod_tpu_torch.parallel import expert

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    with open(sys.argv[2], "rb") as fh:
        job = pickle.load(fh)
    out = {}

    def block(a):
        a = np.ascontiguousarray(a)
        c = a.shape[0] // n
        return torch.from_numpy(a[r * c:(r + 1) * c].copy())

    def tree(a, grad=True):
        t = tl.params_from_jax(a)
        for _, v in tl.named_parameters(t):
            v.requires_grad_(grad)
        return t

    # moe_ffn at ep = n.
    mesh = parallel.make_mesh({"ep": n})
    for key, (kw, x, params) in job["ffn"].items():
        cfg = tm.MoEConfig(ep_axis="ep", **kw)
        p = expert.shard_tree(tree(params), tm.param_specs(cfg), r, n)
        xl = block(x).requires_grad_()
        tm.moe_ffn.dropped = 0
        y, aux, z = tm.moe_ffn(xl, p, cfg, mesh)
        ((y ** 2).sum() + aux + z).backward()
        out[("ffn",) + key] = dict(
            y=y.detach().numpy(), aux=aux.item(), z=z.item(),
            dx=xl.grad.numpy(), dropped=int(tm.moe_ffn.dropped),
            grads={k: v.grad.numpy() for k, v in p.items()})
    mesh.shutdown()

    # The LM: two SGD steps.
    tokens, targets = job["data"]
    for (ep, dp), aux in job["lm"]:
        mesh = parallel.make_mesh({"dp": dp, "ep": ep})
        cfg = tm.MoELMConfig(moe=tm.MoEConfig(**job["moe_kw"][aux]),
                             **job["lm_kw"][aux])
        specs = tm.lm_param_specs(cfg)
        params = expert.shard_tree(tree(job["params"]), specs,
                                   mesh.index("ep"), ep)
        named = list(tl.named_parameters(params))
        rep, sh = expert.split_named(named, specs)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in rep], lr=0.1),
            named_parameters=rep)
        eps = expert.ExpertParallel(
            mesh, torch.optim.SGD([t for _, t in sh], lr=0.1))
        step = tm.make_train_step(cfg, opt, mesh, eps)
        x, y = block(tokens), block(targets)
        losses = []
        for i in range(2):
            if i == 0 and not aux:
                # The step's own sequence, opened to see the rule: the
                # slabs' raw gradients, then what sync_grads makes of them.
                opt.zero_grad()
                eps.zero_grad()
                loss = tm.lm_loss(params, x, y, cfg, mesh)
                loss.backward()
                raw = [t.grad.clone().numpy() for _, t in sh]
                opt.step()
                eps.sync_grads()
                out[("rule", ep, dp)] = dict(
                    names=[nm for nm, _ in sh], raw=raw,
                    synced=[t.grad.clone().numpy() for _, t in sh])
                eps.optimizer.step()
                loss = loss.detach()
            else:
                loss = step(params, x, y)
            losses.append((loss.item(), tm.psum_loss(loss, mesh).item()))
        out[("lm", ep, dp, aux)] = (
            losses, {nm: t.detach().numpy() for nm, t in named})
        # The broadcast: every rank's own draw, then the rule's broadcast.
        mine = tm.lm_init(cfg, torch.Generator().manual_seed(100 + r))
        mine = expert.shard_tree(mine, specs, mesh.index("ep"), ep)
        before = {nm: t.detach().clone().numpy()
                  for nm, t in tl.named_parameters(mine)}
        eps.broadcast_parameters(list(tl.named_parameters(mine)), specs)
        out[("bcast", ep, dp, aux)] = (before, {
            nm: t.detach().numpy() for nm, t in tl.named_parameters(mine)})
        eps.shutdown()
        mesh.shutdown()

    # Router noise: each data coordinate draws its own stream, a seed
    # its own result.
    mesh = parallel.make_mesh({"ep": n})
    cfg = tm.MoELMConfig(moe=tm.MoEConfig(**dict(job["moe_kw"][False],
                                                 router_noise=1.0)),
                         **job["lm_kw"][False])
    params = expert.shard_tree(tree(job["params"], grad=False),
                               tm.lm_param_specs(cfg), r, n)
    x, y = block(tokens), block(targets)
    with torch.no_grad():
        noisy = [tm.lm_loss(params, x, y, cfg, mesh,
                            torch.Generator().manual_seed(s)).item()
                 for s in (7, 7, 8)]
        try:
            tm.lm_loss(params, x, y, cfg, mesh)
        except ValueError as exc:
            noisy.append(str(exc))
    g = tm.data_generator(torch.Generator().manual_seed(7), mesh,
                          ("dp", "ep"))
    out["noise"] = dict(losses=noisy, draw=[
        torch.randn(4, generator=tm.fold_in(g, i)).numpy() for i in range(2)])
    mesh.shutdown()
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("MOE_OK", r)
""")


def _ffn_jobs():
    jobs = {}
    for mode, k, gated in FFN_CASES:
        jobs[(mode, k, gated)] = (_kw(mode, k, gated, 1.0), _x(),
                                  _ffn_params(gated))
    return jobs


def _start(tmp, n):
    lm_kw = {False: dict(vocab_size=64, d_model=32, n_layers=2,
                         aux_weight=0.0, dp_axis="dp"),
             True: dict(vocab_size=64, d_model=32, n_layers=2,
                        aux_weight=AUX["aux_weight"], dp_axis="dp")}
    moe_kw = {aux: dict(d_model=32, d_ff=64, n_experts=8,
                        capacity_factor=8.0,
                        router_top_k=AUX["top_k"] if aux else 1,
                        router_z_weight=AUX["z_weight"] if aux else 0.0,
                        ep_axis="ep") for aux in (False, True)}
    job = dict(ffn=_ffn_jobs(), params=_lm_params(), data=_lm_data(),
               lm=[(m, aux) for m in LM_MESHES[n] for aux in (False, True)],
               lm_kw=lm_kw, moe_kw=moe_kw)
    with open(tmp / "job.pkl", "wb") as fh:
        pickle.dump(job, fh)
    script = tmp / "moe.py"
    script.write_text(_WORKER)
    port, port2 = free_ports(2)
    procs = []
    for r in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port),
                   HOROVOD_CONTROLLER_PORT2=str(port2))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), REPO, str(tmp / "job.pkl"),
             str(tmp / "out")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _collect(tmp, procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        finally:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log
        assert f"MOE_OK {r}" in log, log
    outs = []
    for r in range(len(procs)):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, run side by side."""
    tmps = {n: tmp_path_factory.mktemp(f"moe{n}") for n in (2, 4)}
    procs = {}
    try:
        for n in (2, 4):
            procs[n] = _start(tmps[n], n)
        return {n: _collect(tmps[n], procs[n]) for n in (2, 4)}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()


# ------------------------------------------------------- ep off: routing
def _route_both(mode, k, gated=False, cf=1.0, S=32):
    x = _x(S)
    p = _ffn_params(gated)
    d, c, aux, z = jm._route(jnp.asarray(x), jnp.asarray(p["router"]),
                             _jcfg(mode, k, gated, cf), None)
    r = tm._route(torch.from_numpy(x), torch.from_numpy(p["router"].copy()),
                  _tcfg(mode, k, gated, cf))
    return (np.asarray(d), np.asarray(c), float(aux), float(z)), r


@pytest.mark.parametrize("mode,k", [("tokens", 1), ("tokens", 2),
                                    ("expert_choice", 1)],
                         ids=["top1", "top2", "expert-choice"])
@pytest.mark.parametrize("cf", [0.5, 1.0, 4.0])
def test_torch_route_masks_match_jax(mode, k, cf):
    (d, c, aux, z), r = _route_both(mode, k, cf=cf)
    td, tc = tm.dense_masks(r, 32, E)
    assert td.shape == d.shape
    np.testing.assert_array_equal(td.numpy(), d)
    np.testing.assert_allclose(tc.numpy(), c, **MASK_TOL)
    np.testing.assert_allclose(r.aux.item(), aux, **MASK_TOL)
    np.testing.assert_allclose(r.z_loss.item(), z, rtol=1e-6)


def test_torch_route_choice_priority():
    """A second choice slots after every token's first: with capacity for
    half the assignments, the first choices fill their experts before any
    second choice is kept, as in the JAX routing."""
    (d, _, _, _), r = _route_both("tokens", 2, cf=0.5)
    first_kept = r.keep[0].sum().item()
    assert first_kept > r.keep[1].sum().item()
    np.testing.assert_array_equal(tm.dense_masks(r, 32, E)[0].numpy(), d)


def test_torch_route_refusals():
    x = torch.zeros(8, D)
    w = torch.zeros(D, E)
    with pytest.raises(ValueError, match="router_mode must be"):
        tm._route(x, w, _tcfg("hash", 1, False))
    with pytest.raises(ValueError, match="router_top_k must stay 1"):
        tm._route(x, w, _tcfg("expert_choice", 2, False))
    with pytest.raises(ValueError, match="must be in"):
        tm._route(x, w, _tcfg("tokens", E + 1, False))
    with pytest.raises(ValueError, match="exceeds tokens"):
        tm._route(x, w, _tcfg("expert_choice", 1, False, cf=16.0))
    noisy = tm.MoEConfig(d_model=D, d_ff=F, n_experts=E, router_noise=1.0)
    with pytest.raises(ValueError, match="requires threading generator"):
        tm._route(x, w, noisy)


@pytest.mark.parametrize("S", [1, 7, 32, 1000])
@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 1.0), (2, 4.0), (1, 0.1)])
def test_torch_capacity_matches_jax(S, k, cf):
    kw = dict(n_experts=8, capacity_factor=cf, router_top_k=k)
    assert tm.MoEConfig(**kw).capacity(S) == jm.MoEConfig(**kw).capacity(S)


# ------------------------------------------------------ ep off: moe_ffn
def _jax_ffn_grads(cfg, x, p, mesh=None):
    """Values and the gradients of Σ(y²) + aux + z (psum'd per shard under
    ``shard_map`` when ``mesh`` is given)."""
    if mesh is None:
        def loss(x, p):
            y, a, z = jm.moe_ffn(x, p, cfg)
            return jnp.sum(y ** 2) + a + z
        y, a, z = jm.moe_ffn(jnp.asarray(x), p, cfg)
        vals = (np.asarray(y), [float(a)], [float(z)])
    else:
        specs = jm.param_specs(cfg)

        def per_shard(x, p):
            y, a, z = jm.moe_ffn(x, p, cfg)
            return y, a[None], z[None]

        def loss(x, p):
            def f(x, p):
                y, a, z = jm.moe_ffn(x, p, cfg)
                return jax.lax.psum(jnp.sum(y ** 2) + a + z, "ep")
            return shard_map(f, mesh=mesh, in_specs=(P("ep"), specs),
                             out_specs=P(), check_vma=False)(x, p)
        y, a, z = jax.jit(shard_map(
            per_shard, mesh=mesh, in_specs=(P("ep"), specs),
            out_specs=(P("ep"),) * 3, check_vma=False))(jnp.asarray(x), p)
        vals = (np.asarray(y), list(np.asarray(a)), list(np.asarray(z)))
    gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), p)
    return vals, np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


@pytest.mark.parametrize("mode,k,gated", FFN_CASES)
def test_torch_moe_ffn_ep_off_matches_jax(mode, k, gated):
    p = _ffn_params(gated)
    x = _x()
    (y, aux, z), gx, gp = _jax_ffn_grads(_jcfg(mode, k, gated), x, p)
    tp = {kk: torch.from_numpy(v.copy()).requires_grad_()
          for kk, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty, ta, tz = tm.moe_ffn(tx, tp, _tcfg(mode, k, gated))
    ((ty ** 2).sum() + ta + tz).backward()
    np.testing.assert_allclose(ty.detach().numpy(), y, **VAL_TOL)
    np.testing.assert_allclose([ta.item(), tz.item()], aux + z, **VAL_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), gx, **VAL_TOL)
    for kk, g in gp.items():
        np.testing.assert_allclose(tp[kk].grad.numpy(), g, err_msg=kk,
                                   **VAL_TOL)


def test_torch_capacity_drops_are_identity():
    """Over-capacity tokens contribute exactly zero (the caller's residual
    passes them through), and are counted."""
    cfg = tm.MoEConfig(d_model=D, d_ff=F, n_experts=E, capacity_factor=0.25,
                       ep_axis=None)
    p = {k: torch.from_numpy(v.copy()) for k, v in _ffn_params(False).items()}
    x = torch.from_numpy(_x())
    tm.moe_ffn.routed, tm.moe_ffn.dropped = 0, 0
    y, aux, _ = tm.moe_ffn(x, p, cfg)
    r = tm._route(x, p["router"], cfg)
    dropped = ~r.keep[0]
    assert torch.isfinite(y).all() and aux.item() > 0
    assert dropped.any()
    assert (y[dropped] == 0).all() and (y[~dropped] != 0).any(dim=1).all()
    assert int(dropped.sum()) == int(tm.moe_ffn.dropped)
    assert tm.moe_ffn.routed == 32
    assert int((~dropped).sum()) <= E * cfg.capacity(32)


def test_torch_top2_is_convex_mixture_of_experts():
    """With no drops a top-2 output is g1·E_a(x) + g2·E_b(x) with gates
    summing to one, against a dense per-expert computation in float64
    (``tests/test_moe.py``'s check and tolerance)."""
    cfg = tm.MoEConfig(d_model=D, d_ff=F, n_experts=E, capacity_factor=8.0,
                       router_top_k=2, ep_axis=None)
    p = {k: torch.from_numpy(v.copy()) for k, v in _ffn_params(False).items()}
    x = torch.from_numpy(_x(24))
    y, aux, zl = tm.moe_ffn(x, p, cfg)
    probs = torch.softmax(x @ p["router"], dim=-1).double()
    top = torch.topk(probs, 2, dim=-1)
    gates = top.values / top.values.sum(-1, keepdim=True)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-12)
    xd, w1, w2 = x.double(), p["w1"].double(), p["w2"].double()
    want = torch.zeros_like(xd)
    for s in range(24):
        for j in range(2):
            e = top.indices[s, j]
            want[s] += gates[s, j] * (
                torch.nn.functional.silu(xd[s] @ w1[e]) @ w2[e])
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert aux.item() > 0 and zl.item() > 0


def test_torch_moe_refuses_a_full_expert_set_at_ep():
    """A rank given every expert where the mesh splits them refuses, as
    does an expert count the ep degree does not divide."""
    from horovod_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"ep": 1})
    cfg = tm.MoEConfig(d_model=D, d_ff=F, n_experts=E, ep_axis="ep")
    p = {k: torch.from_numpy(v.copy()) for k, v in _ffn_params(False).items()}
    sliced = dict(p, w1=p["w1"][:2], w2=p["w2"][:2])
    with pytest.raises(ValueError, match="expert slab of 2 experts"):
        tm.moe_ffn(torch.from_numpy(_x()), sliced, cfg, mesh)


def test_torch_router_noise_is_seeded_and_folded():
    """One seed gives one draw; folding by another coordinate or layer
    gives another stream; no generator, no fold."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(8, generator=tm.fold_in(g, 0))
    b = torch.randn(8, generator=tm.fold_in(torch.Generator().manual_seed(3),
                                            0))
    c = torch.randn(8, generator=tm.fold_in(g, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tm.fold_in(None, 5) is None
    assert tm.data_generator(g, None, ("dp", "ep")) is g


# ------------------------------------------------------------ the worlds
@pytest.mark.parametrize("mode,k,gated", FFN_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_torch_moe_ffn_expert_parallel_matches_jax(worlds, n, mode, k,
                                                   gated):
    """ep = n with capacity drops (cf 1.0 per source rank): the port's
    all-to-all dispatch against the JAX ``lax.all_to_all`` one."""
    key = ("ffn", mode, k, gated)
    outs = [o[key] for o in worlds[n]]
    mesh = Mesh(np.array(jax.devices()[:n]), ("ep",))
    cfg = _jcfg(mode, k, gated, ep_axis="ep")
    (y, aux, z), gx, gp = _jax_ffn_grads(cfg, _x(), _ffn_params(gated), mesh)
    np.testing.assert_allclose(np.concatenate([o["y"] for o in outs]), y,
                               **VAL_TOL)
    np.testing.assert_allclose([o["aux"] for o in outs], aux, **VAL_TOL)
    np.testing.assert_allclose([o["z"] for o in outs], z, **VAL_TOL)
    np.testing.assert_allclose(np.concatenate([o["dx"] for o in outs]), gx,
                               **VAL_TOL)
    np.testing.assert_allclose(sum(o["grads"]["router"] for o in outs),
                               gp["router"], **VAL_TOL)
    for kk in gp:
        if kk != "router":
            np.testing.assert_allclose(
                np.concatenate([o["grads"][kk] for o in outs]), gp[kk],
                err_msg=kk, **VAL_TOL)
    if mode == "tokens":
        assert sum(o["dropped"] for o in outs) > 0


@functools.lru_cache(maxsize=None)
def _jax_lm_run(ep, dp, aux):
    """Two SGD(0.1) steps: unsharded without aux (every axis off), else
    under shard_map on the (dp, ep) mesh."""
    kw = AUX if aux else {}
    tokens, targets = map(jnp.asarray, _lm_data())
    params = jm.lm_init(_lm_cfg(True, None, None), jax.random.PRNGKey(0))
    opt = optax.sgd(0.1)
    opt_state = opt.init(params)
    if not aux:
        step = jax.jit(jm.make_train_step(_lm_cfg(True, None, None), opt))
    else:
        cfg = _lm_cfg(True, "ep", "dp", **kw)
        mesh = Mesh(np.array(jax.devices()[:ep * dp]).reshape(dp, ep),
                    ("dp", "ep"))
        pspecs = jm.lm_param_specs(cfg)
        os_specs = spmd.infer_specs_like(opt_state, params, pspecs)
        data = P(("dp", "ep"))
        step = jax.jit(shard_map(
            jm.make_train_step(cfg, opt), mesh=mesh,
            in_specs=(pspecs, os_specs, data, data),
            out_specs=(pspecs, os_specs, P()), check_vma=False))
    losses = []
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        losses.append(float(loss))
    from horovod_tpu_torch.models import llama as tl
    flat = {nm: t.numpy() for nm, t in tl.named_parameters(
        tl.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))}
    return losses, flat


def _assemble(outs, key, ep, dp):
    """The full parameters from the ranks of dp coordinate 0: replicated
    leaves from rank 0, each slab from its ep coordinate's rank."""
    params = dict(outs[0][key][1])
    for name in params:
        if tm.param_specs(tm.MoEConfig()).get(name.split(".")[-1]) == "ep":
            params[name] = np.concatenate([outs[e][key][1][name]
                                           for e in range(ep)])
    return params


@pytest.mark.parametrize("aux", [False, True], ids=["no-aux", "aux-z-top2"])
@pytest.mark.parametrize("ep,dp", [(2, 1), (2, 2), (4, 1)])
def test_torch_moe_lm_expert_parallel_matches_jax(worlds, ep, dp, aux):
    outs = worlds[ep * dp]
    key = ("lm", ep, dp, aux)
    ref_losses, ref = _jax_lm_run(ep, dp, aux)
    for s in range(2):
        np.testing.assert_allclose(np.mean([o[key][0][s][0] for o in outs]),
                                   ref_losses[s], rtol=2e-4)
        for o in outs:
            np.testing.assert_allclose(o[key][0][s][1], ref_losses[s],
                                       rtol=2e-4)
    got = _assemble(outs, key, ep, dp)
    assert sorted(got) == sorted(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(got[name], want, rtol=3e-3, atol=3e-5,
                                   err_msg=name)
    # Ranks holding the same slab (another dp coordinate) hold it alike.
    for r, o in enumerate(outs):
        for name, t in o[key][1].items():
            np.testing.assert_array_equal(t, outs[r % ep][key][1][name],
                                          err_msg=name)


@pytest.mark.parametrize("ep,dp", [(2, 1), (2, 2), (4, 1)])
def test_torch_expert_grads_scaled_and_never_averaged_over_ep(worlds, ep,
                                                              dp):
    """A slab's synced gradient is its raw gradient times 1/ep, averaged
    over the ranks of its ep coordinate only: not the raw one, and not an
    average over ep."""
    outs = worlds[ep * dp]
    rules = [o[("rule", ep, dp)] for o in outs]
    assert all(n.split(".")[-1] in ("w1", "w2") for n in rules[0]["names"])
    for r, rule in enumerate(rules):
        peers = [q for q in range(ep * dp) if q % ep == r % ep]
        for i in range(len(rule["names"])):
            want = np.mean([rules[q]["raw"][i] for q in peers], axis=0) / ep
            np.testing.assert_allclose(rule["synced"][i], want, rtol=1e-6,
                                       atol=1e-9)
            assert not np.allclose(rule["synced"][i], rule["raw"][i] / ep
                                   if dp > 1 else rule["raw"][i])
            over_ep = np.mean([rules[q]["raw"][i] for q in range(ep * dp)],
                              axis=0) / ep
            assert not np.allclose(rule["synced"][i], over_ep)


@pytest.mark.parametrize("ep,dp", [(2, 1), (2, 2), (4, 1)])
def test_torch_broadcast_keeps_each_ranks_slab(worlds, ep, dp):
    """After ``ExpertParallel.broadcast_parameters`` the replicated leaves
    are rank 0's, and each slab is its ep coordinate's first rank's: rank
    1's experts are still rank 1's own."""
    outs = worlds[ep * dp]
    key = ("bcast", ep, dp, False)
    for r, o in enumerate(outs):
        before, after = o[key]
        for name, t in after.items():
            if name.split(".")[-1] in ("w1", "w2"):
                np.testing.assert_array_equal(t, outs[r % ep][key][0][name])
            else:
                np.testing.assert_array_equal(t, outs[0][key][0][name])
    assert not np.array_equal(outs[1][key][1]["layers.0.w1"],
                              outs[0][key][0]["layers.0.w1"])


@pytest.mark.parametrize("n", [2, 4])
def test_torch_router_noise_contract_in_a_world(worlds, n):
    """With router noise a seed gives one loss, another seed another; each
    rank (data coordinate) draws its own stream; no generator raises."""
    draws = []
    for o in worlds[n]:
        a, b, c, refusal = o["noise"]["losses"]
        assert a == b and a != c
        assert "requires threading generator" in refusal
        draws.append(o["noise"]["draw"])
    flat = [d.tobytes() for ds in draws for d in ds]
    assert len(set(flat)) == len(flat)


# ------------------------------------------------------------- example
def test_torch_example_moe_expert_parallel():
    """The port's example under its launcher, two gloo ranks at ep = 2."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, "-m", "horovod_tpu_torch.examples.moe_expert_parallel",
         "--cpu", "--ep", "2", "--steps", "2"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "DONE", r.stdout
    assert "ep=2" in r.stdout and "tok/s" in r.stdout
