"""Port parity: the pipeline-parallel slice and the SPMD harness against the
JAX package.

Two gloo worlds, of 2 and 4 processes (side by side, each started once for
the module), run the port on seeded numpy inputs while this process runs
the JAX package under ``shard_map`` on the same meshes of the 8 virtual CPU
devices:

- ``pipeline_apply`` alone, a toy shape-preserving stage (``tanh(x @ w +
  b)``, a float32 aux ``0.1·Σy²``) at S = 2 and M ∈ {1, 2, 4}, with and
  without ``broadcast_out``, and at S = 4 with M ∈ {2, 4} (more stages than
  microbatches, then as many): the outputs against the JAX function and a
  sequential loop, the aux and the gradients of the stage parameters and
  of the input against ``jax.grad``, within 1e-5
  (``tests/test_pipeline.py``'s cases); the hops counted; the mesh's
  ``PPermute`` and its inverse rotation in the backward;
- Llama, two SGD(0.1) steps in float32 at the tiny config, the grid of
  ``tests/test_llama_parallel.py::test_pipeline_matches_reference`` (pp,
  tp, sp, M) = (2,1,1,2), (2,1,1,4), (4,1,1,2) at 4 layers, (2,2,1,2) and
  (2,1,2,2) ring, each under ``broadcast`` and ``last_stage``, plus
  ``remat_stages``, ``remat_layers`` (at tp = 2) and the MoE Llama at (ep,
  pp) = (2, 2): the global mean loss within rtol 2e-4, every rank's slab
  and the replicated leaves within rtol 3e-3 / atol 3e-5 of the matching
  JAX leaves (that file's tolerances), the replicated leaves bitwise equal
  on every rank, the two placements' parameters alike within the same
  tolerance, and the flash launches a stage runs (M × its layers: no
  compute on bubble ticks);
- the gradient rule's trap: ``embed``'s step-1 gradient at pp = 2, after
  ``DistributedOptimizer``'s world average, equals the pp-off port's, and
  with the rule switched off (``_pp_grad_scale`` patched to the identity)
  it is half of it;
- ``remat_stages`` with router noise draws what the stored pipeline draws:
  the losses and the parameters after a step equal;
- ResNet's and MNIST's ``make_sharded_train_step`` over the harness
  (MNIST also with ``DistributedOptimizer(sharded=True)`` against the JAX
  ``zero_specs`` step) in the world of 2, within 1e-4
  (``tests/test_torch_resnet.py``'s tolerance);
- refusals: ``microbatch`` with an indivisible batch, a pp slab handed to
  ``DistributedOptimizer``, decode on a pp mesh and on a stacked config,
  ``make_sharded_train_step(check="strict")`` on an unbound axis, and
  parameters that are not blocks of one tree.

Each case of a world runs under its own watchdog: a case that hangs (an
exchange one stage skipped) ends its world with the case's name.
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
from horovod_tpu.models import llama as jl, mnist as jm, resnet as jr
from horovod_tpu.parallel import pipeline as jp
from horovod_tpu.parallel import spmd as jspmd
from horovod_tpu.parallel import zero as jzero
from horovod_tpu_torch.common.net import reserve_ports
from horovod_tpu_torch.models import llama as tl, mnist as tm
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.parallel import expert, pipeline as tp, spmd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=2e-4)
PARAM_TOL = dict(rtol=3e-3, atol=3e-5)
FAMILY_TOL = dict(rtol=1e-4, atol=1e-4)
LLAMA_AXES = ("dp", "pp", "ep", "sp", "tp")
CASE_TIMEOUT_S = 90
TOY_D, TOY_MB = 8, 2
# Toy pipeline runs: key -> (world, M, broadcast_out).
TOY = {
    "s2_m1": (2, 1, False), "s2_m2": (2, 2, False), "s2_m4": (2, 4, False),
    "s2_m1_bcast": (2, 1, True), "s2_m2_bcast": (2, 2, True),
    "s2_m4_bcast": (2, 4, True), "s4_m2": (4, 2, False),
    "s4_m4_bcast": (4, 4, True),
}
AUX = dict(n_experts=4, capacity_factor=4.0, aux_weight=0.05,
           router_top_k=2, router_z_weight=1e-3, moe_gated=True)
# Llama runs: key -> (world, axis sizes in LLAMA_AXES order, config).
GRID = {"pp2_m2": ((1, 2, 1, 1, 1), 2, 2), "pp2_m4": ((1, 2, 1, 1, 1), 4, 2),
        "pp4_m2": ((1, 4, 1, 1, 1), 2, 4),
        "pp2_tp2": ((1, 2, 1, 1, 2), 2, 2),
        "pp2_sp2": ((1, 2, 1, 2, 1), 2, 2)}
LLAMA = {}
for _k, (_sizes, _m, _layers) in GRID.items():
    for _place in ("broadcast", "last_stage"):
        LLAMA[f"{_k}_{_place}"] = (int(np.prod(_sizes)), _sizes, dict(
            n_layers=_layers, pp_axis="pp", n_microbatches=_m,
            pp_loss=_place))
LLAMA["pp2_remat_stages"] = (2, (1, 2, 1, 1, 1), dict(
    pp_axis="pp", n_microbatches=2, remat_stages=True))
LLAMA["tp2_remat_layers"] = (2, (1, 1, 1, 1, 2), dict(remat_layers=True))
LLAMA["moe_ep2_pp2"] = (4, (1, 2, 2, 1, 1), dict(
    pp_axis="pp", n_microbatches=2, ep_axis="ep", **AUX))
BATCH, SEQ = 16, 16
NOISE = dict(n_experts=4, capacity_factor=4.0, router_noise=0.5,
             pp_axis="pp", n_microbatches=2)
FAMILY_LR = 0.1


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {n: t.numpy() for n, t in tl.named_parameters(
        tl.params_from_jax(_np(tree)))}


# ------------------------------------------------------------ toy stages
def _toy_inputs(key):
    world, m, _ = TOY[key]
    rng = np.random.RandomState(7 + m + world)
    w = (rng.randn(world, TOY_D, TOY_D) * 0.5).astype(np.float32)
    b = (rng.randn(world, TOY_D) * 0.1).astype(np.float32)
    x = rng.randn(m, TOY_MB, TOY_D).astype(np.float32)
    c = rng.randn(m, TOY_MB, TOY_D).astype(np.float32)
    return w, b, x, c


def _toy_fn(p, xm):
    w, b = p
    y = jnp.tanh(xm @ w[0] + b[0])
    return y, 0.1 * jnp.sum(y * y)


@functools.lru_cache(maxsize=None)
def _jax_toy(key):
    """The JAX pipeline's per-stage outputs and aux, and ``jax.grad`` of
    the sum over stages of each stage's ``Σ outs·C / k + aux``, ``k`` the
    number of stages holding the outputs (the port's loss is its own:
    ``broadcast_out``'s backward hands the last stage its own cotangent
    where JAX's psum transposes to a psum)."""
    world, m, bcast = TOY[key]
    w, b, x, c = _toy_inputs(key)
    mesh = Mesh(np.array(jax.devices()[:world]), ("pp",))
    k = world if bcast else 1

    def per_stage(w, b, x):
        outs, aux = jp.pipeline_apply(_toy_fn, (w, b), x, axis_name="pp",
                                      broadcast_out=bcast, with_aux=True)
        loss = jnp.sum(outs * c) / k + aux
        return outs[None], aux[None], loss[None]

    run = shard_map(per_stage, mesh=mesh, in_specs=(P("pp"), P("pp"), P()),
                    out_specs=(P("pp"), P("pp"), P("pp")), check_vma=False)
    outs, aux, _ = jax.jit(run)(w, b, x)
    grads = jax.jit(jax.grad(lambda w, b, x: jnp.sum(run(w, b, x)[2]),
                             argnums=(0, 1, 2)))(w, b, x)
    return np.asarray(outs), np.asarray(aux), [np.asarray(g) for g in grads]


def _hops(n, s, m):
    """The ticks at which stage ``s`` of ``n`` exchanges with ``m``
    microbatches, forward and backward (``parallel/pipeline.py``)."""
    ticks = range(m + n - 1)
    fwd = sum(1 for t in ticks
              if (s < n - 1 and 0 <= t - s < m) or (s > 0 and 0 <= t - s + 1
                                                    < m))
    bwd = sum(1 for t in ticks
              if (s > 0 and 0 <= t + 1 - s < m) or (s < n - 1
                                                    and 0 <= t - s < m))
    return fwd, bwd


def _sequential(key):
    world, m, _ = TOY[key]
    w, b, x, _ = _toy_inputs(key)
    for s in range(world):
        x = np.tanh(x @ w[s] + b[s])
    return x


# ------------------------------------------------------------------ Llama
def _data(seed=0):
    """``tests/test_llama_parallel.py``'s ``_data(batch=16)``, as numpy."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(BATCH, SEQ)).astype(np.int32),
            rng.randint(0, 256, size=(BATCH, SEQ)).astype(np.int32))


def _jcfg(kw):
    return jl.tiny(dtype=jnp.float32, **kw)


@functools.lru_cache(maxsize=None)
def _llama_params(key):
    return _np(jl.init_params(_jcfg(LLAMA[key][2]), jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_llama(key):
    """Two SGD(0.1) steps of the JAX ``make_train_step`` under
    ``shard_map`` on this run's mesh: the global losses and the leaves
    (stacked under pp), as ``named_parameters`` names them."""
    world, sizes, kw = LLAMA[key]
    cfg = _jcfg(kw)
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(sizes), LLAMA_AXES)
    params = _llama_params(key)
    pspecs = jl.param_specs(cfg)
    opt = optax.sgd(0.1)
    state = opt.init(params)
    os_specs = jspmd.infer_specs_like(state, params, pspecs)
    data_spec = P(("dp", "ep"), "sp")
    step = jax.jit(shard_map(
        jl.make_train_step(cfg, opt), mesh=mesh,
        in_specs=(pspecs, os_specs, data_spec, data_spec),
        out_specs=(pspecs, os_specs, P()), check_vma=False))
    x, y = (jnp.asarray(a) for a in _data())
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
    return losses, _flat(params)


# --------------------------------------------------- ResNet and MNIST
def _resnet_cfg(mod, dtype_mod):
    return mod.ResNetConfig(depth=18, width=8, num_classes=10,
                            compute_dtype=dtype_mod.float32)


@functools.lru_cache(maxsize=None)
def _family_job():
    rng = np.random.RandomState(31)
    p, s = _np(jr.init_params(_resnet_cfg(jr, jnp), jax.random.PRNGKey(3)))
    images = [(rng.randn(4, 32, 32, 3).astype(np.float32),
               (np.arange(4) % 10).astype(np.int32)) for _ in range(2)]
    mp = _np(jm.init_params(jax.random.PRNGKey(4)))
    digits = [jm.synthetic_batch(8, seed=40 + i) for i in range(2)]
    return p, s, images, mp, digits


@functools.lru_cache(maxsize=None)
def _jax_family():
    p, s, images, mp, digits = _family_job()
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    out = {}
    tx = optax.sgd(FAMILY_LR, momentum=0.9)
    cfg = jr.ResNetConfig(depth=18, width=8, num_classes=10,
                          compute_dtype=jnp.float32, sync_bn_axis="hvd")
    step = jr.make_sharded_train_step(cfg, tx, mesh)
    rp, rs, st, losses = p, s, tx.init(p), []
    for x, y in images:
        rp, rs, st, loss = step(rp, rs, st, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    out["resnet"] = (losses, {n: t.numpy() for n, t in tr.named_parameters(
        tr.params_from_jax(_np(rp), s)[0])}, _np(rs))
    for zero in (False, True):
        if zero:
            st, specs = jzero.init_sharded_state(tx, mp, mesh, "hvd")
            step = jm.make_sharded_train_step(tx, mesh, zero_specs=specs)
        else:
            st = tx.init(mp)
            step = jm.make_sharded_train_step(tx, mesh)
        q, losses = mp, []
        for x, y in digits:
            q, st, loss = step(q, st, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
        out["mnist_zero" if zero else "mnist"] = (
            losses, {n: t.numpy() for n, t in tm.named_parameters(
                tm.params_from_jax(_np(q)))})
    return out


# ----------------------------------------------------------- the worlds
_WORKER = textwrap.dedent("""
    import faulthandler, pickle, sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama as tl, mnist as tm
    from horovod_tpu_torch.models import resnet as tr

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    with open(sys.argv[2], "rb") as fh:
        job = pickle.load(fh)
    out = {}

    def case(name):
        # A hung case ends the world, naming itself.
        print(f"CASE {name} START", flush=True)
        faulthandler.dump_traceback_later(job["case_timeout"], exit=True)

    def done(name):
        faulthandler.cancel_dump_traceback_later()
        print(f"CASE {name} END", flush=True)

    def t(a, grad=False):
        return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)

    # The toy pipeline.
    for key, (m, bcast, (w, b, x, c)) in job["toy"].items():
        case(key)
        mesh = parallel.make_mesh({"pp": n})
        s = mesh.index("pp")
        ws, bs, xs = t(w[s:s + 1], True), t(b[s:s + 1], True), t(x, True)

        def fn(p, xm):
            y = torch.tanh(xm @ p[0][0] + p[1][0])
            return y, 0.1 * (y * y).sum()
        mesh.timing = []
        outs, aux = parallel.pipeline_apply(fn, (ws, bs), xs, mesh, "pp",
                                            broadcast_out=bcast,
                                            with_aux=True)
        fwd_hops = len(mesh.timing)
        loss = (outs * t(c)).sum() + aux
        loss.backward()
        out[key] = dict(outs=outs.detach().numpy(), aux=aux.item(),
                        gw=ws.grad.numpy(), gb=bs.grad.numpy(),
                        gx=None if xs.grad is None else xs.grad.numpy(),
                        fwd_hops=fwd_hops, hops=len(mesh.timing))
        mesh.timing = None
        mesh.shutdown()
        done(key)

    # The rotation under autograd.
    case("ppermute")
    mesh = parallel.make_mesh({"pp": n})
    xr = torch.full((3,), float(r + 1), requires_grad=True)
    yr = parallel.PPermute.apply(xr, mesh, "pp", 1)
    (yr * torch.arange(3.0) * (r + 1)).sum().backward()
    out["ppermute"] = dict(y=yr.detach().numpy(), g=xr.grad.numpy())
    mesh.shutdown()
    done("ppermute")

    # Llama.
    tokens, targets = job["data"]

    def block(a, mesh):
        return parallel.local_batch(t(a), mesh, (("dp", "ep"), "sp"))

    def train(sizes, kw, params):
        mesh = parallel.make_mesh(dict(zip(job["axes"], sizes)))
        cfg = tl.tiny(dtype=torch.float32, **kw)
        specs = tl.param_specs(cfg)
        params = tl.shard_params(params, cfg, mesh)
        named = list(tl.named_parameters(params))
        for _, v in named:
            v.requires_grad_(True)
        rep, sh = parallel.split_named(named, specs, ("tp", "ep", "pp"))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([v for _, v in rep], lr=0.1),
            named_parameters=rep)
        shards = parallel.ShardedParallel(
            mesh, torch.optim.SGD([v for _, v in sh], lr=0.1), sh, specs)
        step = parallel.make_sharded_train_step(
            tl.make_train_step(cfg, opt, mesh, shards), mesh, specs)
        losses = []
        for _ in range(2):
            loss = step(params, t(tokens), t(targets))
            losses.append((loss.item(),
                           tl.psum_loss(loss, cfg, mesh).item()))
        res = dict(losses=losses, sizes=mesh.shape,
                   coords={a: mesh.index(a) for a in mesh.axis_names},
                   params={k: v.detach().numpy() for k, v in named})
        shards.shutdown()
        mesh.shutdown()
        return res

    for key, (sizes, kw, params) in job["llama"].items():
        case(key)
        calls = []
        real = tl._layer_apply

        def counting(*a, **k):
            calls.append(1)
            return real(*a, **k)
        tl._layer_apply = counting
        try:
            out[key] = train(sizes, kw, tl.params_from_jax(params))
        finally:
            tl._layer_apply = real
        out[key]["layer_calls"] = len(calls)
        done(key)

    if n == 2:
        # Remat with router noise: the stored and the recomputed pipeline.
        case("noise")
        # The same step twice, with and without remat, on one generator
        # seed: the loss and every parameter after the step.
        res = {}
        for remat in (False, True):
            mesh = parallel.make_mesh({"pp": 2})
            cfg = tl.tiny(dtype=torch.float32, remat_stages=remat,
                          **job["noise"])
            params = tl.shard_params(
                tl.init_params(cfg, torch.Generator().manual_seed(5)), cfg,
                mesh)
            named = list(tl.named_parameters(params))
            rep, sh = parallel.split_named(named, tl.param_specs(cfg),
                                           ("pp",))
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD([v for _, v in rep], lr=0.1),
                named_parameters=rep)
            shards = parallel.ShardedParallel(
                mesh, torch.optim.SGD([v for _, v in sh], lr=0.1), sh,
                tl.param_specs(cfg))
            step = tl.make_train_step(cfg, opt, mesh, shards)
            loss = step(params, t(tokens[:4]), t(targets[:4]),
                        torch.Generator().manual_seed(11))
            res[remat] = dict(loss=loss.item(), params={
                k: v.detach().numpy() for k, v in named})
            shards.shutdown()
            mesh.shutdown()
        out["noise"] = res
        done("noise")

        # The gradient rule's trap: embed's gradient after the world
        # average, with the rule and with it switched off.
        case("trap")
        cfg0 = tl.tiny(dtype=torch.float32)
        full = tl.params_from_jax(job["trap"])
        named0 = list(tl.named_parameters(full))
        for _, v in named0:
            v.requires_grad_(True)
        tl.loss_fn(full, t(tokens), t(targets), cfg0).backward()
        ref = full["embed"].grad.numpy().copy()
        trap = dict(ref=ref)
        for rule in (True, False):
            mesh = parallel.make_mesh({"pp": 2})
            cfg = tl.tiny(dtype=torch.float32, pp_axis="pp")
            params = tl.shard_params(
                tl.stack_layers(tl.params_from_jax(job["trap"])), cfg, mesh)
            named = list(tl.named_parameters(params))
            for _, v in named:
                v.requires_grad_(True)
            rep, sh = parallel.split_named(named, tl.param_specs(cfg),
                                           ("pp",))
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD([v for _, v in rep], lr=0.1),
                named_parameters=rep)
            real = tl._pp_grad_scale
            if not rule:
                tl._pp_grad_scale = lambda x, cfg, mesh: x
            try:
                tl.loss_fn(params, t(tokens), t(targets), cfg,
                           mesh).backward()
                opt.synchronize()
            finally:
                tl._pp_grad_scale = real
            trap["rule" if rule else "off"] = params["embed"].grad.numpy()
            opt.zero_grad()
            mesh.shutdown()
        out["trap"] = trap
        done("trap")

        # Refusals.
        case("refusals")

        def refused(fn):
            try:
                fn()
            except (ValueError, NotImplementedError) as exc:
                return str(exc)
            return None

        ref = {}
        mesh = parallel.make_mesh({"pp": 2})
        cfg = tl.tiny(dtype=torch.float32, pp_axis="pp")
        p = tl.shard_params(tl.init_params(
            cfg, torch.Generator().manual_seed(0)), cfg, mesh)
        named = list(tl.named_parameters(p))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([v for _, v in named], lr=0.1),
            named_parameters=named)
        toks = torch.zeros(2, 8, dtype=torch.int64)
        ref["slab"] = refused(lambda: tl.make_train_step(cfg, opt, mesh)(
            p, toks, toks))
        c0 = tl.tiny(dtype=torch.float32)
        p0 = tl.init_params(c0, torch.Generator().manual_seed(0))
        ref["decode"] = refused(lambda: tl.generate(p0, toks, 2, c0,
                                                    mesh=mesh))
        # Blocks of different trees: rank 1 keeps the whole embedding.
        q = {"a": torch.zeros(4, 2) if r == 0 else torch.zeros(8, 2)}
        ref["blocks"] = refused(lambda: parallel.make_sharded_train_step(
            lambda p, x: None, mesh, {"a": "pp"})(q, toks))
        mesh.shutdown()
        out["refusals"] = ref
        done("refusals")

        # ResNet and MNIST over the harness.
        case("family")
        p, s, images, mp, digits = job["family"]
        mesh = parallel.make_mesh({"dp": 2})
        cfg = tr.ResNetConfig(depth=18, width=8, num_classes=10,
                              compute_dtype=torch.float32)
        params, stats = tr.params_from_jax(p, s)
        named = list(tr.named_parameters(params))
        for _, v in named:
            v.requires_grad_(True)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([v for _, v in named], lr=job["lr"],
                            momentum=0.9), named_parameters=named)
        step = tr.make_sharded_train_step(cfg, opt, mesh)
        losses = []
        for x, y in images:
            loss, stats = step(params, stats, t(x), t(y))
            losses.append(tl.psum_loss(loss, None, mesh).item())
        fam = out["family"] = {}
        fam["resnet"] = dict(losses=losses, stats=stats, params={
            k: v.detach().numpy() for k, v in named})
        for zero in (False, True):
            params = tm.params_from_jax(mp)
            named = list(tm.named_parameters(params))
            for _, v in named:
                v.requires_grad_(True)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD([v for _, v in named], lr=job["lr"],
                                momentum=0.9), named_parameters=named,
                sharded=zero)
            step = tm.make_sharded_train_step(opt, mesh)
            losses = [tl.psum_loss(step(params, t(x), t(y)), None,
                                   mesh).item() for x, y in digits]
            fam["mnist_zero" if zero else "mnist"] = dict(
                losses=losses, params={k: v.detach().numpy()
                                       for k, v in named},
                sharded=getattr(opt, "sharded", False))
        mesh.shutdown()
        done("family")
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("PP_OK", r)
""")


def _start(tmp, n, port, port2):
    job = dict(
        case_timeout=CASE_TIMEOUT_S, axes=LLAMA_AXES, data=_data(),
        lr=FAMILY_LR, noise=NOISE,
        toy={k: (m, b, _toy_inputs(k)) for k, (w, m, b) in TOY.items()
             if w == n},
        llama={k: (sizes, kw, _llama_params(k))
               for k, (w, sizes, kw) in LLAMA.items() if w == n},
        trap=_trap_params(), family=_family_job())
    with open(tmp / "job.pkl", "wb") as fh:
        pickle.dump(job, fh)
    script = tmp / "pp.py"
    script.write_text(_WORKER)
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


@functools.lru_cache(maxsize=None)
def _trap_params():
    cfg = jl.tiny(dtype=jnp.float32, dp_axis=None, tp_axis=None,
                  sp_axis=None)
    return _np(jl.init_params(cfg, jax.random.PRNGKey(9)))


def _collect(tmp, procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    outs = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or f"PP_OK {r}" not in log:
            outs.append(dict(log=log))
            continue
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(dict(pickle.load(fh), log=log))
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmps = {n: tmp_path_factory.mktemp(f"pp{n}") for n in (2, 4)}
    procs = {}
    # One reservation for both worlds, held until they exit.
    held = reserve_ports(4)
    try:
        for n, ports in ((2, held.ports[:2]), (4, held.ports[2:])):
            procs[n] = _start(tmps[n], n, *ports)
        # The JAX references while the worlds run.
        for key in TOY:
            _jax_toy(key)
        for key in LLAMA:
            _jax_llama(key)
        _jax_family()
        return {n: _collect(tmps[n], procs[n]) for n in (2, 4)}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
        held.release()


def _ran(outs, key):
    """Every rank's record of ``key``; fails naming a case that did not
    end (a hang's watchdog) or a world that died."""
    for r, o in enumerate(outs):
        assert f"CASE {key} END" in o["log"], (
            f"rank {r}: case {key} did not end:\n" + o["log"][-3000:])
        assert key in o, o["log"][-3000:]
    return [o[key] for o in outs]


# ------------------------------------------------------------ the toy
@pytest.mark.parametrize("key", sorted(TOY))
def test_torch_pipeline_apply_matches_jax_and_a_loop(worlds, key):
    world, m, bcast = TOY[key]
    runs = _ran(worlds[world], key)
    outs, aux, (gw, gb, gx) = _jax_toy(key)
    seq = _sequential(key)
    for s, o in enumerate(runs):
        if bcast or s == world - 1:
            np.testing.assert_allclose(o["outs"], seq, **TOY_TOL)
        else:
            assert not o["outs"].any()
        np.testing.assert_allclose(o["outs"], outs[s], **TOY_TOL)
        np.testing.assert_allclose(o["aux"], aux[s], **TOY_TOL)
        np.testing.assert_allclose(o["gw"], gw[s:s + 1], **TOY_TOL)
        np.testing.assert_allclose(o["gb"], gb[s:s + 1], **TOY_TOL)
        # Stage 0 alone reads the input: the others' cotangent is zero.
        want = gx if s == 0 else np.zeros_like(gx)
        np.testing.assert_allclose(o["gx"], want, **TOY_TOL)
    # The first hop rotates one element around the group; then one
    # exchange a tick that sends or receives, each way, and the sum for
    # broadcast_out.
    for s, o in enumerate(runs):
        fwd, bwd = _hops(world, s, m)
        assert o["fwd_hops"] == 1 + fwd + bool(bcast), o
        assert o["hops"] == 1 + fwd + bwd + bool(bcast), o


def test_torch_pipeline_ppermute_backward_is_the_inverse_rotation(worlds):
    for n, outs in worlds.items():
        runs = _ran(outs, "ppermute")
        for r, o in enumerate(runs):
            # Rank r received rank r - 1's; its cotangent went back there,
            # so rank r's gradient is rank r + 1's weights.
            np.testing.assert_array_equal(o["y"], np.full(3, (r - 1) % n
                                                          + 1.0))
            np.testing.assert_array_equal(
                o["g"], np.arange(3.0) * ((r + 1) % n + 1))


def test_torch_microbatch_refuses_an_indivisible_batch():
    x = torch.zeros(6, 3)
    assert tp.microbatch(x, 3).shape == (3, 2, 3)
    with pytest.raises(ValueError, match="batch 6 not divisible into 4 "
                                         "microbatches"):
        tp.microbatch(x, 4)
    with pytest.raises(ValueError, match="not divisible into 4"):
        jp.microbatch(jnp.zeros((6, 3)), 4)


def test_torch_pipeline_one_stage_without_a_mesh_is_the_loop():
    """No mesh: the one stage runs the microbatches in turn, and its
    gradients are the loop's."""
    w, b, x, c = _toy_inputs("s2_m4")
    ws = torch.from_numpy(w[:1]).requires_grad_()
    bs = torch.from_numpy(b[:1]).requires_grad_()
    xs = torch.from_numpy(x).requires_grad_()
    outs = tp.pipeline_apply(lambda p, xm: torch.tanh(xm @ p[0][0] + p[1][0]),
                             (ws, bs), xs, None)
    (outs * torch.from_numpy(c)).sum().backward()
    w2, b2, x2 = (torch.from_numpy(a).requires_grad_() for a in
                  (w[:1], b[:1], x))
    ref = torch.tanh(x2 @ w2[0] + b2[0])
    (ref * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(outs.detach().numpy(), ref.detach().numpy(),
                               **TOY_TOL)
    for got, want in ((ws, w2), (bs, b2), (xs, x2)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   **TOY_TOL)


# ------------------------------------------------------------------ Llama
def _want(ref, name, spec, o):
    """The block of the JAX leaf ``ref[name]`` that rank ``o`` holds."""
    want = ref[name]
    for part in expert.splits_of(spec[name]):
        if o["sizes"].get(part.axis, 1) > 1:
            want = expert.shard_tree(want, part, o["coords"][part.axis],
                                     o["sizes"][part.axis], part.axis)
    return want


def _tcfg(kw):
    return tl.tiny(dtype=torch.float32, **kw)


@pytest.mark.parametrize("key", sorted(LLAMA))
def test_torch_llama_pipeline_matches_jax(worlds, key):
    world, sizes, kw = LLAMA[key]
    runs = _ran(worlds[world], key)
    ref_losses, ref = _jax_llama(key)
    cfg = _tcfg(kw)
    spec = expert.spec_of(tl.param_specs(cfg))
    for i in range(2):
        means = {o["losses"][i][1] for o in runs}
        assert len(means) == 1, (i, means)
        np.testing.assert_allclose(means.pop(), ref_losses[i], **LOSS_TOL)
        # Every stage (and tp rank) of a data shard holds its loss,
        # bitwise, under both placements.
        shard = {}
        for o in runs:
            data = tuple(o["coords"][a] for a in ("dp", "ep", "sp"))
            shard.setdefault(data, set()).add(o["losses"][i][0])
        assert all(len(v) == 1 for v in shard.values()), shard
    for o in runs:
        assert sorted(o["params"]) == sorted(ref)
        for name, got in o["params"].items():
            np.testing.assert_allclose(got, _want(ref, name, spec, o),
                                       err_msg=name, **PARAM_TOL)
    for name in ref:
        vals = [o["params"][name] for o in runs]
        if not expert.splits_of(spec[name]):
            assert all(np.array_equal(v, vals[0]) for v in vals), name
    pp = dict(zip(LLAMA_AXES, sizes))["pp"]
    if pp > 1:
        # A stage runs its layers once a microbatch: M x layers a stage
        # each step, twice with remat (the recomputation).
        lps = cfg.n_layers // pp
        per_step = cfg.n_microbatches * lps * (2 if cfg.remat_stages else 1)
        for o in runs:
            assert o["layer_calls"] == 2 * per_step, (o["layer_calls"],
                                                      per_step)
        s0 = [o for o in runs if o["coords"]["pp"] == 0][0]
        s1 = [o for o in runs if o["coords"]["pp"] == 1][0]
        assert not np.array_equal(s0["params"]["layers.wq"],
                                  s1["params"]["layers.wq"])


@pytest.mark.parametrize("grid", sorted(GRID))
def test_torch_llama_pipeline_placements_agree(worlds, grid):
    """``broadcast`` and ``last_stage`` land on the same parameters."""
    world = LLAMA[f"{grid}_broadcast"][0]
    a = _ran(worlds[world], f"{grid}_broadcast")
    b = _ran(worlds[world], f"{grid}_last_stage")
    for x, y in zip(a, b):
        for name in x["params"]:
            np.testing.assert_allclose(x["params"][name], y["params"][name],
                                       err_msg=name, **PARAM_TOL)


def test_torch_llama_pipeline_gradient_rule(worlds):
    """``embed``'s step-1 gradient at pp = 2 after the world average is the
    pp-off port's; with the rule off it is half of it."""
    for o in _ran(worlds[2], "trap"):
        np.testing.assert_allclose(o["rule"], o["ref"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(o["off"], o["ref"] / 2, rtol=1e-5,
                                   atol=1e-7)
        assert not np.allclose(o["off"], o["ref"], rtol=1e-3, atol=1e-6)


def test_torch_llama_pipeline_remat_redraws_the_router_noise(worlds):
    """``remat_stages`` with router noise > 0: the recomputed stages draw
    what the stored ones drew, so the loss and every parameter after a
    step are equal."""
    for o in _ran(worlds[2], "noise"):
        stored, remat = o[False], o[True]
        assert stored["loss"] == remat["loss"]
        for name, v in stored["params"].items():
            np.testing.assert_array_equal(v, remat["params"][name],
                                          err_msg=name)


@pytest.mark.parametrize("what,match", [
    ("slab", "split over the mesh"),
    ("decode", "supports tp only"),
    ("blocks", "not blocks of one tree"),
])
def test_torch_pipeline_refusals_on_the_mesh(worlds, what, match):
    for o in _ran(worlds[2], "refusals"):
        assert o[what] is not None, what
        assert match in o[what], o[what]


def test_torch_llama_pipeline_config_refusals():
    with pytest.raises(ValueError, match="pp_loss must be"):
        tl.tiny(pp_axis="pp", pp_loss="first_stage")
    cfg = tl.tiny(dtype=torch.float32, pp_axis="pp")
    p = tl.init_params(cfg, torch.Generator().manual_seed(0))
    assert p["layers"]["wq"].shape[0] == cfg.n_layers
    with pytest.raises(ValueError, match="stacks the layers"):
        tl.generate(p, torch.zeros(1, 4, dtype=torch.int64), 2, cfg)

    class Stage1:
        axis_names = ("pp",)

        def size(self, ax):
            return 2

        def index(self, ax):
            return 1

    # The whole stack on a stage would run every layer on every stage.
    with pytest.raises(ValueError, match="holds 2 of 2 layers over pp=2"):
        tl.loss_fn(p, torch.zeros(2, 4, dtype=torch.int64),
                   torch.zeros(2, 4, dtype=torch.int64), cfg, Stage1())


def test_torch_llama_pipeline_specs_and_stacking_match_jax():
    """The pp specs are the JAX ``P(pp, *spec)`` (pp on dim 0, the rest one
    further), ``stack_layers`` is the JAX stacked tree and
    ``unstack_layers`` its inverse."""
    for kw in (dict(), dict(n_experts=4, ep_axis="ep")):
        jspec = jl.param_specs(jl.tiny(pp_axis="pp", **kw))
        tspec = expert.spec_of(tl.param_specs(tl.tiny(pp_axis="pp", **kw)))
        leaves = jax.tree_util.tree_leaves_with_path(
            jspec, is_leaf=lambda x: isinstance(x, P))
        assert len(leaves) == len(tspec)
        for path, p in leaves:
            name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            want = tuple(expert.Split(ax, d) for d, ax in enumerate(p)
                         if ax is not None)
            assert expert.splits_of(tspec[name]) == want, (name, p)
    cfg = jl.tiny(dtype=jnp.float32, pp_axis="pp")
    stacked = _np(jl.init_params(cfg, jax.random.PRNGKey(0)))
    flat = _np(jl.init_params(jl.tiny(dtype=jnp.float32),
                              jax.random.PRNGKey(0)))
    ours = tl.stack_layers(tl.params_from_jax(flat))
    for name, v in tl.named_parameters(tl.params_from_jax(stacked)):
        np.testing.assert_array_equal(v.numpy(), dict(
            tl.named_parameters(ours))[name].detach().numpy())
    back = tl.unstack_layers(ours)
    for name, v in tl.named_parameters(tl.params_from_jax(flat)):
        assert torch.equal(v, dict(tl.named_parameters(back))[name])


# ---------------------------------------------------------- the harness
def test_torch_family_sharded_steps_match_jax(worlds):
    ref = _jax_family()
    outs = _ran(worlds[2], "family")
    for key in ("resnet", "mnist", "mnist_zero"):
        losses, params = ref[key][:2]
        x, y = (o[key] for o in outs)
        np.testing.assert_allclose(x["losses"], losses, **FAMILY_TOL)
        assert x["losses"] == y["losses"]
        for name, v in x["params"].items():
            np.testing.assert_array_equal(v, y["params"][name])
            np.testing.assert_allclose(v, params[name], err_msg=name,
                                       **FAMILY_TOL)
    assert outs[0]["mnist_zero"]["sharded"] is True
    stats = ref["resnet"][2]
    got = jax.tree_util.tree_map(lambda v: v.numpy(),
                                 outs[0]["resnet"]["stats"])
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(stats)):
        np.testing.assert_allclose(g, w, **FAMILY_TOL)


def test_torch_spmd_local_batch_is_the_data_spec_block():
    class Mesh2:
        axis_names = ("dp", "ep", "sp")

        def __init__(self, dp, ep, sp):
            self.c = dict(dp=dp, ep=ep, sp=sp)

        def size(self, ax):
            return 2

        def index(self, ax):
            return self.c[ax]

    x = np.arange(8 * 4).reshape(8, 4)
    # P(("dp", "ep"), "sp"): dp major over the batch, sp over the sequence.
    got = spmd.local_batch(x, Mesh2(1, 0, 1))
    np.testing.assert_array_equal(got, x[4:6, 2:4])
    got = spmd.local_batch(torch.from_numpy(x), Mesh2(0, 1, 0))
    assert torch.equal(got, torch.from_numpy(x[2:4, 0:2]))
    np.testing.assert_array_equal(spmd.local_batch(x, None), x)
    with pytest.raises(ValueError, match="does not divide"):
        spmd.local_batch(np.zeros((6, 4)), Mesh2(0, 0, 0))


def test_torch_spmd_refusals_and_specs_like():
    # check= audits the first call's step: "strict" refuses a psum over an
    # axis nothing binds before it runs; check=True audits and runs.
    from horovod_tpu_torch.analysis.trace_check import AbstractMesh
    from horovod_tpu_torch.parallel.mesh import psum
    tp = AbstractMesh({"tp": 2})
    bad = spmd.make_sharded_train_step(lambda p, x: psum(x, tp, "tq"), None,
                                       check="strict")
    with pytest.raises(RuntimeError, match="HVD201"):
        bad({"w": torch.zeros(2)}, torch.ones(2, 2))
    ok = spmd.make_sharded_train_step(lambda p, x: p["w"] * x, None,
                                      check=True)
    assert torch.equal(ok({"w": torch.full((2,), 3.0)}, torch.ones(2, 2)),
                       torch.full((2, 2), 3.0))
    # A spec tree of another layout: the pp specs over unstacked layers.
    cfg = tl.tiny(dtype=torch.float32)
    flat = tl.init_params(cfg, torch.Generator().manual_seed(0))
    pp_specs = tl.param_specs(tl.tiny(dtype=torch.float32, pp_axis="pp"))
    with pytest.raises(ValueError, match="not blocks of one tree"):
        spmd.check_blocks(flat, pp_specs, None)
    spmd.check_blocks(flat, tl.param_specs(cfg), None)
    spmd.check_blocks(tl.stack_layers(flat), pp_specs, None)
    params = {"a": torch.zeros(2, 3), "b": [torch.zeros(4)]}
    pspecs = {"a": "tp", "b": [None]}
    state = {"step": torch.zeros(()), "mu": {"a": torch.ones(2, 3),
                                             "b": [torch.ones(4)]}}
    got = spmd.infer_specs_like(state, params, pspecs)
    assert got == {"step": None, "mu": pspecs}
    # The JAX harness names it the same way.
    jgot = jspmd.infer_specs_like(
        {"step": jnp.zeros(()), "mu": {"a": jnp.ones((2, 3)),
                                       "b": [jnp.ones(4)]}},
        {"a": jnp.zeros((2, 3)), "b": [jnp.zeros(4)]},
        {"a": P("tp"), "b": [P()]})
    assert jgot["mu"] == {"a": P("tp"), "b": [P()]}
    assert jgot["step"] == P()


def test_torch_spmd_shard_params_is_the_jax_placement():
    """``shard_params`` keeps the block that ``shard_map`` hands a device
    for the spec: a pp slab of stacked layers and its tp columns."""
    class MeshPT:
        axis_names = ("pp", "tp")

        def __init__(self, pp, tp_):
            self.c = dict(pp=pp, tp=tp_)

        def size(self, ax):
            return 2

        def index(self, ax):
            return self.c[ax]

    cfg = tl.tiny(dtype=torch.float32, n_layers=4, pp_axis="pp")
    full = tl.init_params(cfg, torch.Generator().manual_seed(1))
    for pp_i in range(2):
        for tp_i in range(2):
            part = spmd.shard_params(full, tl.param_specs(cfg),
                                     MeshPT(pp_i, tp_i))
            wq = full["layers"]["wq"]
            c = wq.shape[2] // 2
            assert torch.equal(part["layers"]["wq"],
                               wq[2 * pp_i:2 * pp_i + 2, :,
                                  tp_i * c:(tp_i + 1) * c])
            assert torch.equal(part["layers"]["attn_norm"],
                               full["layers"]["attn_norm"][2 * pp_i:
                                                           2 * pp_i + 2])
            assert part["embed"] is full["embed"]
