"""Port parity: the tensor-parallel slice against the JAX package.

Two gloo worlds, of 2 and 4 processes (side by side, each started once for
the module), run the port's Megatron tensor parallelism on seeded numpy
inputs; the tests hold them against the JAX package in this process, under
``shard_map`` on the same mesh of the 8 virtual CPU devices:

- Llama, two SGD(0.1) steps in float32 at (tp, sp) = (2, 1), (2, 2) ring
  and (2, 2) Ulysses (8/4 heads), (dp, tp) = (2, 2), and the MoE Llama
  (gated top-2 experts with the aux and z losses) at (ep, tp) = (2, 2):
  the global mean loss within rtol 2e-4 and every rank's parameters after
  two steps within rtol 3e-3 / atol 3e-5 of the matching block of the JAX
  ones (``tests/test_llama_parallel.py``'s tolerances: the same arithmetic
  summed in another order); the replicated leaves bitwise equal on every
  rank and the tp blocks not;
- tp = 2 decode: ``generate`` token for token as JAX's sharded
  ``generate`` and the prefill logits within 1e-5, as
  ``tests/test_llama_parallel.py::test_tp_decode_matches_single_device``,
  the cache holding K/tp kv heads, seeded sampling equal on both ranks;
- BERT at (tp, sp) = (2, 1), (1, 2), (2, 2), ViT and GPT-2 at tp = 2, two
  SGD(0.5) steps: losses and parameters within 1e-4 (``tests/
  test_torch_bert_vit.py``'s tolerance), and BERT's mask count summed over
  the data ranks alone where tp ranks are present and the data ranks'
  counts differ;
- the mesh's reduction and Megatron's pair against a two-rank sum, and the
  refusals: heads or kv heads that tp does not divide, decode on a mesh
  with a dp, sp or ep axis, ViT with sp, GPT-2 decode with tp, and a tp
  shard handed to ``DistributedOptimizer``.
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
from horovod_tpu.models import bert as jb, gpt2 as jg, llama as jl, vit as jv
from horovod_tpu.parallel import spmd
from horovod_tpu_torch.common.net import free_ports
from horovod_tpu_torch.models import bert as tb, gpt2 as tg, llama as tl
from horovod_tpu_torch.models import vit as tv
from horovod_tpu_torch.parallel import expert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=2e-4)
PARAM_TOL = dict(rtol=3e-3, atol=3e-5)
FAMILY_TOL = dict(rtol=1e-4, atol=1e-4)
LLAMA_AXES = ("dp", "pp", "ep", "sp", "tp")
AUX = dict(n_experts=4, capacity_factor=4.0, aux_weight=0.05,
           router_top_k=2, router_z_weight=1e-3, moe_gated=True)
# Llama runs: key -> (world, axis sizes in LLAMA_AXES order, config).
LLAMA = {
    "tp2": (2, (1, 1, 1, 1, 2), {}),
    "tp2_sp2_ring": (4, (1, 1, 1, 2, 2), {}),
    "tp2_sp2_ulysses": (4, (1, 1, 1, 2, 2),
                        dict(n_heads=8, n_kv_heads=4, sp_impl="ulysses")),
    "dp2_tp2": (4, (2, 1, 1, 1, 2), {}),
    "moe_ep2_tp2": (4, (1, 1, 2, 1, 2), AUX),
}
FAMILY_LR = 0.5
# Family runs: key -> (world, module name, (dp, sp, tp)).
FAMILIES = {
    "bert_tp2": (2, "bert", (1, 1, 2)),
    "bert_sp2": (2, "bert", (1, 2, 1)),
    "bert_tp2_sp2": (4, "bert", (1, 2, 2)),
    "bert_dp2_tp2": (4, "bert", (2, 1, 2)),
    "vit_tp2": (2, "vit", (1, 1, 2)),
    "gpt2_tp2": (2, "gpt2", (1, 1, 2)),
}
# BERT's data ranks hold these masked counts in (dp, tp) = (2, 2): the
# count must be their sum, not the world's.
MASKED = (3, 17)
DECODE_N = 5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {n: t.numpy() for n, t in tl.named_parameters(
        tl.params_from_jax(_np(tree)))}


def _llama_data(batch=8, seq=16, seed=0):
    """``tests/test_llama_parallel.py``'s ``_data``, as numpy."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(batch, seq)).astype(np.int32),
            rng.randint(0, 256, size=(batch, seq)).astype(np.int32))


def _jllama_cfg(kw, **axes):
    return jl.tiny(dtype=jnp.float32, **kw, **axes)


@functools.lru_cache(maxsize=None)
def _llama_params(key):
    kw = LLAMA[key][2]
    cfg = _jllama_cfg(kw, dp_axis=None, tp_axis=None, sp_axis=None)
    return _np(jl.init_params(cfg, jax.random.PRNGKey(0)))


def _jax_train(step_fn, params, pspecs, mesh, data, data_specs, lr,
               steps=2):
    """``steps`` SGD steps of a JAX ``make_train_step`` under
    ``shard_map``: the global losses and the parameters."""
    opt = optax.sgd(lr)
    opt_state = opt.init(params)
    os_specs = spmd.infer_specs_like(opt_state, params, pspecs)
    step = jax.jit(shard_map(
        step_fn, mesh=mesh, in_specs=(pspecs, os_specs) + tuple(data_specs),
        out_specs=(pspecs, os_specs, P()), check_vma=False))
    data = [jnp.asarray(a) for a in data]
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, *data)
        losses.append(float(loss))
    return losses, _flat(params)


@functools.lru_cache(maxsize=None)
def _jax_llama(key):
    _, sizes, kw = LLAMA[key]
    cfg = _jllama_cfg(kw, ep_axis="ep" if kw.get("n_experts") else None)
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(
        sizes), LLAMA_AXES)
    spec = P(("dp", "ep", "pp"), "sp")
    return _jax_train(jl.make_train_step(cfg, optax.sgd(0.1)),
                      _llama_params(key), jl.param_specs(cfg), mesh,
                      _llama_data(), (spec, spec), 0.1)


@functools.lru_cache(maxsize=None)
def _decode_case():
    """``tests/test_llama_parallel.py:368-414``: the params, the prompt,
    and JAX's tp = 2 ``generate`` and ``prefill`` logits under
    ``shard_map``."""
    cfg0 = jl.tiny(dtype=jnp.float32, max_seq=32, dp_axis=None,
                   tp_axis=None, sp_axis=None, use_flash=False)
    cfg = jl.tiny(dtype=jnp.float32, max_seq=32, dp_axis=None,
                  tp_axis="tp", sp_axis=None, use_flash=False)
    params = _np(jl.init_params(cfg0, jax.random.PRNGKey(21)))
    prompt = np.random.RandomState(22).randint(0, 256, (2, 6)).astype(
        np.int32)
    mesh = Mesh(np.array(jax.devices()[:2]), ("tp",))
    pspecs = jl.param_specs(cfg)

    def on_tp(fn):
        return jax.jit(shard_map(fn, mesh=mesh,
                                 in_specs=(pspecs, P(None, None)),
                                 out_specs=P(None, None), check_vma=False))

    gen = on_tp(lambda p, t: jl.generate(p, t, DECODE_N, cfg))(
        params, jnp.asarray(prompt))
    logits = on_tp(lambda p, t: jl.prefill(
        p, jl.init_cache(cfg, 2, 32), t, cfg)[0])(params, jnp.asarray(prompt))
    return params, prompt, np.asarray(gen), np.asarray(logits)


def _family_mods(name):
    return {"bert": (jb, tb), "vit": (jv, tv), "gpt2": (jg, tg)}[name]


def _family_batch(name, seed, masked=None):
    rng = np.random.RandomState(seed)
    if name == "vit":
        return (rng.randn(4, 32, 32, 3).astype(np.float32),
                rng.randint(0, 10, (4,)).astype(np.int32))
    toks = rng.randint(0, 256, (4, 16)).astype(np.int32)
    tgts = rng.randint(0, 256, (4, 16)).astype(np.int32)
    if name == "gpt2":
        return toks, tgts
    mask = (rng.rand(4, 16) < 0.3).astype(np.float32)
    if masked is not None:
        mask[:] = 0
        for r, n in enumerate(masked):
            flat = mask[2 * r:2 * r + 2].reshape(-1)
            flat[rng.choice(flat.size, n, replace=False)] = 1
            mask[2 * r:2 * r + 2] = flat.reshape(2, 16)
    return toks, tgts, mask


@functools.lru_cache(maxsize=None)
def _family_params(name):
    mod = _family_mods(name)[0]
    cfg = mod.tiny(dtype=jnp.float32, dp_axis=None, tp_axis=None,
                   **({"sp_axis": None} if name == "bert" else {}))
    return _np(mod.init_params(cfg, jax.random.PRNGKey(7)))


def _family_job(key):
    _, name, _ = FAMILIES[key]
    masked = MASKED if key == "bert_dp2_tp2" else None
    return _family_params(name), [_family_batch(name, 30 + i, masked)
                                  for i in range(2)]


@functools.lru_cache(maxsize=None)
def _jax_family(key):
    _, name, (dp, sp, tp) = FAMILIES[key]
    mod = _family_mods(name)[0]
    axes = ("dp", "sp", "tp") if name == "bert" else ("dp", "tp")
    sizes = (dp, sp, tp) if name == "bert" else (dp, tp)
    mesh = Mesh(np.array(jax.devices()[:dp * sp * tp]).reshape(sizes), axes)
    cfg = mod.tiny(dtype=jnp.float32)
    params, batches = _family_job(key)
    if name == "bert":
        spec = (P("dp", "sp"),) * 3
    else:
        spec = (P("dp"),) * 2
    step = jax.jit(shard_map(
        mod.make_train_step(cfg, optax.sgd(FAMILY_LR)), mesh=mesh,
        in_specs=(mod.param_specs(cfg), P()) + spec,
        out_specs=(mod.param_specs(cfg), P(), P()), check_vma=False))
    state, losses = optax.sgd(FAMILY_LR).init(params), []
    for batch in batches:
        params, state, loss = step(params, state,
                                   *(jnp.asarray(a) for a in batch))
        losses.append(float(loss))
    return losses, _flat(params)


_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import bert as tb, gpt2 as tg
    from horovod_tpu_torch.models import llama as tl, vit as tv

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    with open(sys.argv[2], "rb") as fh:
        job = pickle.load(fh)
    out = {}

    def block(a, mesh, dims):
        # This rank's block of a along each (dim, axes) pair; several axes
        # on one dim: the first major.
        t = torch.from_numpy(np.ascontiguousarray(a))
        for dim, axes in dims:
            idx, size = 0, 1
            for ax in axes:
                idx, size = idx * mesh.size(ax) + mesh.index(ax), \\
                    size * mesh.size(ax)
            c = t.shape[dim] // size
            t = t.narrow(dim, idx * c, c)
        return t.contiguous()

    def trainable(params, mod, specs, mesh):
        named = list(mod.named_parameters(params))
        for _, t in named:
            t.requires_grad_(True)
        rep, sh = parallel.split_named(named, specs, ("tp", "ep"))
        return named, rep, sh

    def record(mesh, named, losses):
        return dict(losses=losses, coords={a: mesh.index(a)
                                           for a in mesh.axis_names},
                    sizes=mesh.shape,
                    params={k: t.detach().numpy() for k, t in named})

    # Llama training.
    tokens, targets = job["llama_data"]
    for key, (sizes, kw, params) in job["llama"].items():
        mesh = parallel.make_mesh(dict(zip(job["llama_axes"], sizes)))
        cfg = tl.tiny(dtype=torch.float32,
                      ep_axis="ep" if kw.get("n_experts") else None, **kw)
        specs = tl.param_specs(cfg)
        params = tl.shard_params(tl.params_from_jax(params), cfg, mesh)
        named, rep, sh = trainable(params, tl, specs, mesh)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in rep], lr=0.1),
            named_parameters=rep)
        shards = parallel.ShardedParallel(
            mesh, torch.optim.SGD([t for _, t in sh], lr=0.1), sh, specs)
        shards.broadcast_parameters(named, specs)
        step = tl.make_train_step(cfg, opt, mesh, shards)
        dims = [(0, ("dp", "ep")), (1, ("sp",))]
        x, y = block(tokens, mesh, dims), block(targets, mesh, dims)
        losses = []
        for _ in range(2):
            loss = step(params, x, y)
            losses.append((loss.item(),
                           tl.psum_loss(loss, cfg, mesh).item()))
        out[key] = record(mesh, named, losses)
        shards.shutdown()
        mesh.shutdown()

    # BERT, ViT, GPT-2 training.
    mods = {"bert": tb, "vit": tv, "gpt2": tg}
    for key, (name, (dp, sp, tp), params, batches) in job["family"].items():
        mod = mods[name]
        axes = {"dp": dp, "sp": sp, "tp": tp} if name == "bert" else \\
            {"dp": dp, "tp": tp}
        mesh = parallel.make_mesh(axes)
        cfg = mod.tiny(dtype=torch.float32)
        specs = mod.param_specs(cfg)
        params = parallel.shard_on_mesh(mod.params_from_jax(params), specs,
                                        mesh)
        named, rep, sh = trainable(params, mod, specs, mesh)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in rep], lr=job["family_lr"]),
            named_parameters=rep)
        shards = parallel.ShardedParallel(
            mesh, torch.optim.SGD([t for _, t in sh], lr=job["family_lr"]),
            sh, specs)
        step = mod.make_train_step(cfg, opt, mesh, shards)
        # BERT's batches [B, T] split over dp and sp, the others' over dp.
        dims = [(0, ("dp",))] + ([(1, ("sp",))] if name == "bert" else [])
        losses, counts = [], []
        for batch in batches:
            local = [block(a, mesh, dims) for a in batch]
            if name == "bert":
                count, ranks = tb.dp_total(local[2].sum(), cfg, "c", mesh)
                counts.append((float(count), ranks))
            loss = step(params, *local)
            losses.append((loss.item(),
                           mod.psum_loss(loss, cfg, mesh=mesh).item()))
        out[key] = record(mesh, named, losses)
        out[key]["counts"] = counts
        shards.shutdown()
        mesh.shutdown()

    if n == 2:
        # tp = 2 decode.
        mesh = parallel.make_mesh({"tp": 2})
        params, prompt = job["decode"]
        cfg = tl.tiny(dtype=torch.float32, max_seq=32)
        params = tl.shard_params(tl.params_from_jax(params), cfg, mesh)
        prompt = torch.from_numpy(prompt)
        gen = tl.generate(params, prompt, job["decode_n"], cfg, mesh=mesh)
        cache = tl.init_cache(cfg, 2, 32, mesh=mesh)
        logits, cache = tl.prefill(params, cache, prompt, cfg, mesh)
        sampled = tl.generate(params, prompt, job["decode_n"], cfg,
                              temperature=0.8, top_k=20,
                              generator=torch.Generator().manual_seed(5),
                              mesh=mesh)
        out["decode"] = dict(gen=gen.numpy(), logits=logits.numpy(),
                             cache=tuple(cache[0]["k"].shape),
                             sampled=sampled.numpy())

        # The mesh's reduction and Megatron's pair.
        x0, w0 = (torch.from_numpy(a[r]) for a in job["ops"])
        mesh.timing = []
        total = parallel.psum(x0, mesh, "tp")
        marks, mesh.timing = len(mesh.timing), None
        x = x0.clone().requires_grad_()
        g = parallel.ReduceOutput.apply(x, mesh, "tp")
        (g * w0).sum().backward()
        x2 = x0.clone().requires_grad_()
        f = parallel.CopyInput.apply(x2, mesh, "tp")
        (f * w0).sum().backward()
        out["ops"] = dict(total=total.numpy(), marks=marks,
                          g=g.detach().numpy(), g_grad=x.grad.numpy(),
                          f=f.detach().numpy(), f_grad=x2.grad.numpy())

        # Refusals on a tp mesh.
        def refused(fn):
            try:
                fn()
            except ValueError as exc:
                return str(exc)
            return None

        toks = torch.zeros(1, 8, dtype=torch.int64)
        gen0 = torch.Generator().manual_seed(0)
        ref = {}
        for what, kw in (("heads", dict(n_heads=6, n_kv_heads=3,
                                        d_model=48)),
                         ("kv_heads", dict(n_heads=4, n_kv_heads=1))):
            c = tl.tiny(dtype=torch.float32, **kw)
            p = tl.init_params(c, gen0)
            ref["llama_" + what] = refused(
                lambda: tl.forward(p, toks, c, mesh=mesh))
        c = tb.tiny(dtype=torch.float32, n_heads=3, d_model=48)
        p = tb.init_params(c, gen0)
        ref["bert_heads"] = refused(lambda: tb.forward(p, toks, c, mesh))
        c = tg.tiny(dtype=torch.float32)
        p = tg.init_params(c, gen0)
        ref["gpt2_decode"] = refused(
            lambda: tg.decode_step(p, tg.init_cache(c, 1), toks[:, 0], 0, c,
                                   mesh=mesh))
        ref["gpt2_generate"] = refused(
            lambda: tg.generate(p, toks, 2, c, mesh=mesh))
        # The trap: a tp shard handed to DistributedOptimizer.
        c = tl.tiny(dtype=torch.float32)
        p = tl.shard_params(tl.init_params(c, gen0), c, mesh)
        named = list(tl.named_parameters(p))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in named], lr=0.1),
            named_parameters=named)
        ref["trap"] = refused(lambda: tl.make_train_step(c, opt, mesh)(
            p, toks, toks))
        mesh.shutdown()
        for ax in ("sp", "dp", "ep"):
            other = parallel.make_mesh({ax: 2})
            c = tl.tiny(dtype=torch.float32)
            p = tl.init_params(c, gen0)
            ref["prefill_" + ax] = refused(lambda: tl.prefill(
                p, tl.init_cache(c, 1, 8), toks, c, other))
            ref["generate_" + ax] = refused(
                lambda: tl.generate(p, toks, 2, c, mesh=other))
            if ax == "sp":
                c = tv.tiny(dtype=torch.float32)
                p = tv.init_params(c, gen0)
                ref["vit_sp"] = refused(lambda: tv.forward(
                    p, torch.zeros(1, 32, 32, 3), c, other))
            other.shutdown()
        out["refusals"] = ref
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("TP_OK", r)
""")


def _ops_inputs():
    rng = np.random.RandomState(3)
    return (rng.randn(2, 3, 5).astype(np.float32),
            rng.randn(2, 3, 5).astype(np.float32))


def _start(tmp, n):
    job = dict(
        llama_axes=LLAMA_AXES, llama_data=_llama_data(),
        llama={k: (sizes, kw, _llama_params(k))
               for k, (w, sizes, kw) in LLAMA.items() if w == n},
        family_lr=FAMILY_LR,
        family={k: (name, sizes) + _family_job(k)
                for k, (w, name, sizes) in FAMILIES.items() if w == n},
        decode=_decode_case()[:2], decode_n=DECODE_N, ops=_ops_inputs())
    with open(tmp / "job.pkl", "wb") as fh:
        pickle.dump(job, fh)
    script = tmp / "tp.py"
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
        assert f"TP_OK {r}" in log, log
    outs = []
    for r in range(len(procs)):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmps = {n: tmp_path_factory.mktemp(f"tp{n}") for n in (2, 4)}
    procs = {}
    try:
        for n in (2, 4):
            procs[n] = _start(tmps[n], n)
        return {n: _collect(tmps[n], procs[n]) for n in (2, 4)}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()


def _want(ref, name, spec, o):
    """The block of the JAX leaf ``ref[name]`` that rank ``o`` holds."""
    s = expert.split_of(spec[name])
    want = ref[name]
    if s is not None and o["sizes"].get(s.axis, 1) > 1:
        want = expert.shard_tree(want, s, o["coords"][s.axis],
                                 o["sizes"][s.axis], s.axis)
    return want


def _hold(outs, key, ref_losses, ref, specs, loss_tol, param_tol):
    """Every rank's global losses equal and within ``loss_tol`` of the
    JAX ones, its parameters within ``param_tol`` of the JAX blocks; the
    replicated leaves bitwise on every rank, every tp block differing from
    its neighbour's."""
    spec = expert.spec_of(specs)
    for s in range(2):
        means = {o[key]["losses"][s][1] for o in outs}
        assert len(means) == 1, (s, means)
        np.testing.assert_allclose(means.pop(), ref_losses[s], **loss_tol)
    for o in outs:
        assert sorted(o[key]["params"]) == sorted(ref)
        for name, got in o[key]["params"].items():
            np.testing.assert_allclose(got, _want(ref, name, spec, o[key]),
                                       err_msg=name, **param_tol)
    split = 0
    for name in ref:
        s = expert.split_of(spec[name])
        vals = [o[key]["params"][name] for o in outs]
        if s is None:
            assert all(np.array_equal(v, vals[0]) for v in vals), name
        elif s.axis == "tp" and outs[0][key]["sizes"]["tp"] > 1:
            split += 1
            tp1 = [o for o in outs if o[key]["coords"]["tp"] == 1][0]
            assert not np.array_equal(vals[0], tp1[key]["params"][name])
    return split


# ------------------------------------------------------------------ Llama
@pytest.mark.parametrize("key", sorted(LLAMA))
def test_torch_llama_tensor_parallel_matches_jax(worlds, key):
    world, _, kw = LLAMA[key]
    outs = worlds[world]
    ref_losses, ref = _jax_llama(key)
    cfg = tl.tiny(dtype=torch.float32,
                  ep_axis="ep" if kw.get("n_experts") else None, **kw)
    split = _hold(outs, key, ref_losses, ref, tl.param_specs(cfg),
                  LOSS_TOL, PARAM_TOL)
    # wq wk wv wo a layer, and w1 w3 w2 for a dense MLP.
    assert split == cfg.n_layers * (4 if kw.get("n_experts") else 7)


def test_torch_llama_tp_decode_matches_jax_sharded_generate(worlds):
    _, _, gen, logits = _decode_case()
    a, b = (o["decode"] for o in worlds[2])
    np.testing.assert_array_equal(a["gen"], gen)
    np.testing.assert_array_equal(b["gen"], gen)
    for o in (a, b):
        np.testing.assert_allclose(o["logits"], logits, rtol=1e-5,
                                   atol=1e-5)
        assert o["cache"] == (2, 32, 1, 16)     # 2 kv heads over tp = 2
    np.testing.assert_array_equal(a["sampled"], b["sampled"])


def test_torch_llama_tp_decode_matches_the_unsplit_port(worlds):
    """The same generation with every head on one rank."""
    params, prompt, gen, _ = _decode_case()
    cfg = tl.tiny(dtype=torch.float32, max_seq=32)
    got = tl.generate(tl.params_from_jax(params), torch.from_numpy(prompt),
                      DECODE_N, cfg)
    np.testing.assert_array_equal(got.numpy(), worlds[2][0]["decode"]["gen"])


# ---------------------------------------------------- BERT, ViT, GPT-2
@pytest.mark.parametrize("key", sorted(FAMILIES))
def test_torch_family_tensor_parallel_matches_jax(worlds, key):
    world, name, _ = FAMILIES[key]
    outs = worlds[world]
    ref_losses, ref = _jax_family(key)
    mod = _family_mods(name)[1]
    _hold(outs, key, ref_losses, ref, mod.param_specs(mod.tiny()),
          FAMILY_TOL, FAMILY_TOL)


def test_torch_bert_counts_masks_over_the_data_ranks_only(worlds):
    """(dp, tp) = (2, 2), the data ranks' masked counts 3 and 17: every
    rank's count is 20 over 2 data ranks, not the world's 40 over 4."""
    outs = worlds[4]
    for o in outs:
        assert o["bert_dp2_tp2"]["counts"][0] == (float(sum(MASKED)), 2)
        assert o["bert_dp2_tp2"]["sizes"] == {"dp": 2, "sp": 1, "tp": 2}
    by_dp = {}
    for o in outs:
        by_dp.setdefault(o["bert_dp2_tp2"]["coords"]["dp"], set()).add(
            o["bert_dp2_tp2"]["losses"][0][0])
    # The tp ranks of a data rank hold one loss; the data ranks differ.
    assert all(len(v) == 1 for v in by_dp.values())
    assert by_dp[0] != by_dp[1]


def test_torch_family_param_specs_match_jax():
    """Every family's split leaves are the JAX specs' (axis and dim)."""
    for name in ("bert", "vit", "gpt2", "llama"):
        jmod, tmod = {"llama": (jl, tl)}.get(name) or _family_mods(name)
        jspec = {".".join(map(str, k)): v for k, v in _spec_leaves(
            jmod.param_specs(jmod.tiny()))}
        tspec = expert.spec_of(tmod.param_specs(tmod.tiny()))
        assert sorted(jspec) == sorted(tspec), name
        for leaf, p in jspec.items():
            want = None
            for dim, ax in enumerate(p):
                if ax is not None:
                    want = expert.Split(ax, dim)
            assert tspec[leaf] == want, (name, leaf, p)


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (i,))
    else:
        yield path, tree


# --------------------------------------------------------------- the mesh
def test_torch_mesh_reduction_and_megatron_pair(worlds):
    x, w = _ops_inputs()
    for r, o in enumerate(worlds[2]):
        ops = o["ops"]
        np.testing.assert_allclose(ops["total"], x[0] + x[1], rtol=1e-6)
        assert ops["marks"] == 1
        np.testing.assert_allclose(ops["g"], x[0] + x[1], rtol=1e-6)
        np.testing.assert_array_equal(ops["g_grad"], w[r])
        np.testing.assert_array_equal(ops["f"], x[r])
        np.testing.assert_allclose(ops["f_grad"], w[0] + w[1], rtol=1e-6)


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("what,match", [
    ("llama_heads", "must be divisible by tp=2"),
    ("llama_kv_heads", "must be divisible by tp=2"),
    ("bert_heads", "not divisible by tp=2"),
    ("gpt2_decode", "single-rank"),
    ("gpt2_generate", "single-rank"),
    ("prefill_sp", "supports tp only"),
    ("prefill_dp", "supports tp only"),
    ("prefill_ep", "supports tp only"),
    ("generate_sp", "supports tp only"),
    ("generate_dp", "supports tp only"),
    ("generate_ep", "supports tp only"),
    ("vit_sp", "'sp' axis has size 2"),
    ("trap", "split over the mesh"),
])
def test_torch_tensor_parallel_refusals(worlds, what, match):
    for o in worlds[2]:
        assert o["refusals"][what] is not None, what
        assert match in o["refusals"][what], o["refusals"][what]


def test_torch_llama_refuses_tp_shards_in_distributed_optimizer_by_name():
    """The trap's check alone: it names the leaves and their axis, and lets
    a plain torch optimizer (no average) and a mesh without tp pass."""
    class Mesh2:
        axis_names = ("dp", "tp")

        def size(self, ax):
            return 2 if ax == "tp" else 1

    cfg = tl.tiny(dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    named = list(tl.named_parameters(params))

    class Averaging(torch.optim.SGD):
        def synchronize(self):
            pass

    opt = Averaging([t for _, t in named], lr=0.1)
    with pytest.raises(ValueError, match=r"layers\.0\.wq \(tp\)"):
        expert.refuse_world_averaged(opt, params, tl.param_specs(cfg),
                                     Mesh2())
    expert.refuse_world_averaged(torch.optim.SGD([t for _, t in named],
                                                 lr=0.1),
                                 params, tl.param_specs(cfg), Mesh2())
    rep, _ = expert.split_named(named, tl.param_specs(cfg), ("tp",))
    expert.refuse_world_averaged(Averaging([t for _, t in rep], lr=0.1),
                                 params, tl.param_specs(cfg), Mesh2())


def test_torch_shard_params_cuts_contiguous_head_blocks():
    """Rank r's wq columns are q heads [r·H/tp, (r+1)·H/tp), its wk/wv
    columns kv heads [r·K/tp, (r+1)·K/tp), wo its rows of those q heads;
    the cache spec splits the kv-head axis."""
    class Mesh1:
        axis_names = ("tp",)

        def __init__(self, r):
            self.r = r

        def size(self, ax):
            return 2

        def index(self, ax):
            return self.r

    cfg = tl.tiny(dtype=torch.float32, n_heads=8, n_kv_heads=4)
    full = tl.params_from_jax(_llama_params("tp2_sp2_ulysses"))
    Hd = cfg.head_dim
    for r in range(2):
        part = tl.shard_params(full, cfg, Mesh1(r))
        lay, whole = part["layers"][0], full["layers"][0]
        assert torch.equal(lay["wq"], whole["wq"][:, r * 4 * Hd:
                                                   (r + 1) * 4 * Hd])
        assert torch.equal(lay["wk"], whole["wk"][:, r * 2 * Hd:
                                                   (r + 1) * 2 * Hd])
        assert torch.equal(lay["wo"], whole["wo"][r * 4 * Hd:
                                                  (r + 1) * 4 * Hd])
        assert lay["wq"].is_contiguous()
        assert part["embed"] is full["embed"]
    assert tl.cache_specs(cfg)[0]["k"] == expert.Split("tp", 2)
