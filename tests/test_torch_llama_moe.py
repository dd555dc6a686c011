"""Port parity: Llama's mixture-of-experts MLP and ``mixtral_8x7b()``
against the JAX package.

In this process (ep off): the MoE Llama's loss and every gradient, gated
top-2 with the aux and z losses, against ``horovod_tpu.models.llama``
(rtol 2e-4 / atol 2e-5); two SGD steps through ``make_train_step`` with an
``ExpertParallel`` of one rank against the unsharded JAX run; cached
greedy decode through the MoE MLP against the argmax of the full forward
at every position and against the JAX ``generate``; ``mixtral_8x7b()``'s
fields; ``param_specs`` and ``shard_experts`` on a JAX tree.

Two gloo worlds, of 2 and 4 processes (side by side), train tiny
Llama-MoE two SGD(0.1) steps at (ep, dp) = (2, 1), (2, 2), (4, 1), each
rank its block of the batch (dp major, ep fastest): with ``aux_weight`` 0
against the unsharded JAX run of ``tests/test_llama_parallel.py``
``test_llama_moe_matches_reference`` (losses within rtol 2e-4, parameters
within rtol 3e-3 / atol 3e-5); with aux, z-loss, top-2 and gated experts
against the JAX run under ``shard_map`` on the same (dp, ep) mesh.
"""

import dataclasses
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
from horovod_tpu.models import llama as jl
from horovod_tpu.parallel import spmd
from horovod_tpu_torch.common.net import reserve_ports
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.parallel import expert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_llama_parallel.py:212's MoE: capacity_factor = n_experts, no
# drops, so sharded and unsharded layouts keep every token.
BASE = dict(n_experts=4, capacity_factor=4.0, aux_weight=0.0)
AUX = dict(n_experts=4, capacity_factor=4.0, aux_weight=0.05,
           router_top_k=2, router_z_weight=1e-3, moe_gated=True)
MESHES = {2: [(2, 1)], 4: [(2, 2), (4, 1)]}


def _data(batch=16, seq=16, seed=0):
    """``tests/test_llama_parallel.py``'s ``_data``, as numpy."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(batch, seq)).astype(np.int32),
            rng.randint(0, 256, size=(batch, seq)).astype(np.int32))


def _jcfg(kw, ep_axis=None, dp_axis=None):
    return jl.tiny(dtype=jnp.float32, dp_axis=dp_axis, tp_axis=None,
                   sp_axis=None, ep_axis=ep_axis, **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(aux):
    cfg = _jcfg(AUX if aux else BASE)
    return jax.tree_util.tree_map(np.asarray, jl.init_params(
        cfg, jax.random.PRNGKey(0)))


def _flat(tree):
    return {n: t.numpy() for n, t in tl.named_parameters(
        tl.params_from_jax(jax.tree_util.tree_map(np.asarray, tree)))}


@functools.lru_cache(maxsize=None)
def _jax_run(aux, ep=1, dp=1):
    """Two SGD(0.1) steps: unsharded (every axis off) when ``ep`` is 1,
    else under shard_map on the (dp, ep) mesh."""
    kw = AUX if aux else BASE
    params = jl.init_params(_jcfg(kw), jax.random.PRNGKey(0))
    opt = optax.sgd(0.1)
    opt_state = opt.init(params)
    tokens, targets = map(jnp.asarray, _data())
    if ep == 1:
        step = jax.jit(jl.make_train_step(_jcfg(kw), opt))
    else:
        cfg = _jcfg(kw, ep_axis="ep", dp_axis="dp")
        mesh = Mesh(np.array(jax.devices()[:ep * dp]).reshape(dp, ep),
                    ("dp", "ep"))
        pspecs = jl.param_specs(cfg)
        os_specs = spmd.infer_specs_like(opt_state, params, pspecs)
        data = P(("dp", "ep"))
        step = jax.jit(shard_map(
            jl.make_train_step(cfg, opt), mesh=mesh,
            in_specs=(pspecs, os_specs, data, data),
            out_specs=(pspecs, os_specs, P()), check_vma=False))
    losses = []
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        losses.append(float(loss))
    return losses, _flat(params)


_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import expert

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    with open(sys.argv[2], "rb") as fh:
        job = pickle.load(fh)
    out = {}

    def block(a):
        c = a.shape[0] // n
        return torch.from_numpy(np.ascontiguousarray(a[r * c:(r + 1) * c]))

    tokens, targets = job["data"]
    for (ep, dp), aux in job["runs"]:
        mesh = parallel.make_mesh({"dp": dp, "ep": ep})
        cfg = tl.tiny(dtype=torch.float32, ep_axis="ep", **job["kw"][aux])
        specs = tl.param_specs(cfg)
        params = tl.shard_experts(tl.params_from_jax(job["params"][aux]),
                                  cfg, mesh)
        named = list(tl.named_parameters(params))
        for _, t in named:
            t.requires_grad_(True)
        rep, sh = expert.split_named(named, specs)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in rep], lr=0.1),
            named_parameters=rep)
        eps = expert.ExpertParallel(
            mesh, torch.optim.SGD([t for _, t in sh], lr=0.1))
        step = tl.make_train_step(cfg, opt, mesh, eps)
        x, y = block(tokens), block(targets)
        losses = []
        for _ in range(2):
            loss = step(params, x, y)
            losses.append((loss.item(), tl.psum_loss(loss, cfg, mesh).item()))
        out[(ep, dp, aux)] = (losses,
                              {nm: t.detach().numpy() for nm, t in named})
        eps.shutdown()
        mesh.shutdown()
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("LLAMA_MOE_OK", r)
""")


def _start(tmp, n, port, port2):
    job = dict(params={a: _jax_params(a) for a in (False, True)},
               kw={False: BASE, True: AUX}, data=_data(),
               runs=[(m, a) for m in MESHES[n] for a in (False, True)])
    with open(tmp / "job.pkl", "wb") as fh:
        pickle.dump(job, fh)
    script = tmp / "llama_moe.py"
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


def _collect(tmp, procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        finally:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log
        assert f"LLAMA_MOE_OK {r}" in log, log
    outs = []
    for r in range(len(procs)):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmps = {n: tmp_path_factory.mktemp(f"llama_moe{n}") for n in (2, 4)}
    procs = {}
    # One reservation for both worlds, held until they exit.
    held = reserve_ports(4)
    try:
        for n, ports in ((2, held.ports[:2]), (4, held.ports[2:])):
            procs[n] = _start(tmps[n], n, *ports)
        return {n: _collect(tmps[n], procs[n]) for n in (2, 4)}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
        held.release()


def _is_slab(name):
    return ".moe.w" in name


# -------------------------------------------------------------- ep off
def test_torch_llama_moe_loss_and_grads_match_jax():
    """Gated top-2 experts with the aux and z losses, ep off."""
    params = _jax_params(True)
    tokens, targets = _data(batch=4)
    loss, grads = jax.value_and_grad(jl.loss_fn)(
        params, jnp.asarray(tokens), jnp.asarray(targets), _jcfg(AUX))
    tp = tl.params_from_jax(params)
    named = list(tl.named_parameters(tp))
    for _, t in named:
        t.requires_grad_(True)
    cfg = tl.tiny(dtype=torch.float32, **AUX)
    tloss = tl.loss_fn(tp, torch.from_numpy(tokens),
                       torch.from_numpy(targets), cfg)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=2e-4)
    want = _flat(grads)
    assert sorted(want) == sorted(n for n, _ in named)
    for name, t in named:
        np.testing.assert_allclose(t.grad.numpy(), want[name], rtol=2e-4,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("aux", [False, True], ids=["no-aux", "aux-z-top2"])
def test_torch_llama_moe_train_step_ep_off_matches_jax(aux):
    """``make_train_step`` with an ``ExpertParallel`` of one rank (no
    mesh: the rule is the identity) against the unsharded JAX steps."""
    kw = AUX if aux else BASE
    cfg = tl.tiny(dtype=torch.float32, ep_axis="ep", **kw)
    params = tl.params_from_jax(_jax_params(aux))
    named = list(tl.named_parameters(params))
    for _, t in named:
        t.requires_grad_(True)
    rep, sh = expert.split_named(named, tl.param_specs(cfg))
    assert [n for n, _ in sh] == [n for n, _ in named if _is_slab(n)]
    opt = torch.optim.SGD([t for _, t in rep], lr=0.1)
    eps = expert.ExpertParallel(None, torch.optim.SGD([t for _, t in sh],
                                                      lr=0.1))
    step = tl.make_train_step(cfg, opt, experts=eps)
    x, y = map(torch.from_numpy, _data())
    losses = [step(params, x, y).item() for _ in range(2)]
    ref_losses, ref = _jax_run(aux)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    for name, t in named:
        np.testing.assert_allclose(t.detach().numpy(), ref[name], rtol=3e-3,
                                   atol=3e-5, err_msg=name)


def test_torch_llama_moe_decode_matches_forward_argmax():
    """Cached greedy decode through the MoE MLP (every expert local) ==
    the argmax of the full forward at every generated position, and the
    JAX ``generate``'s tokens."""
    kw = dict(n_experts=4, capacity_factor=4.0)
    jcfg = jl.tiny(dtype=jnp.float32, max_seq=32, dp_axis=None,
                   tp_axis=None, sp_axis=None, use_flash=False, **kw)
    params = jax.tree_util.tree_map(np.asarray, jl.init_params(
        jcfg, jax.random.PRNGKey(7)))
    prompt = np.random.RandomState(8).randint(0, 256, (2, 5)).astype(
        np.int32)
    N = 4
    jgen = np.asarray(jax.jit(lambda p, t: jl.generate(p, t, N, jcfg))(
        params, jnp.asarray(prompt)))
    cfg = tl.tiny(dtype=torch.float32, max_seq=32, **kw)
    tp = tl.params_from_jax(params)
    gen = tl.generate(tp, torch.from_numpy(prompt), N, cfg)
    np.testing.assert_array_equal(gen.numpy(), jgen)
    seq = torch.from_numpy(prompt).long()
    with torch.no_grad():
        for i in range(N):
            nxt = tl.forward(tp, seq, cfg)[:, -1, :].argmax(-1)
            np.testing.assert_array_equal(gen[:, i].numpy(), nxt.numpy(),
                                          err_msg=f"token {i}")
            seq = torch.cat([seq, nxt[:, None]], dim=1)


def test_torch_mixtral_8x7b_has_the_jax_fields():
    """Every field of the port's ``mixtral_8x7b()`` equals the JAX one's
    (the dtype by name); the one JAX field the port lacks is the TPU
    routing knob ``use_flash`` (the pp fields came with the pipeline slice,
    the rolling cache's with the serving surface)."""
    t, j = tl.mixtral_8x7b(), jl.mixtral_8x7b()
    names = [f.name for f in dataclasses.fields(t)]
    for name in names:
        a, b = getattr(t, name), getattr(j, name)
        if name == "dtype":
            assert str(a).split(".")[-1] == np.dtype(b).name
        else:
            assert a == b, name
    missing = {f.name for f in dataclasses.fields(j)} - set(names)
    assert missing == {"use_flash"}
    assert t.head_dim == j.head_dim == 128
    assert tl.mixtral_8x7b(n_layers=1).n_layers == 1


def test_torch_llama_moe_param_specs_and_shard_experts():
    """The specs name exactly the expert slabs as split over ep, and
    ``shard_experts`` cuts a JAX tree to each coordinate's rows."""
    from horovod_tpu_torch.parallel import make_mesh
    cfg = tl.tiny(dtype=torch.float32, ep_axis="ep", **AUX)
    spec = expert.spec_of(tl.param_specs(cfg))
    params = tl.params_from_jax(_jax_params(True))
    assert sorted(spec) == sorted(n for n, _ in tl.named_parameters(params))
    assert {n for n, s in spec.items() if s == "ep"} == {
        f"layers.{i}.moe.{w}" for i in range(2) for w in ("w1", "w2", "w3")}
    assert tl.shard_experts(params, cfg, make_mesh({"dp": 1})) is params
    for i in range(2):
        part = expert.shard_tree(params, tl.param_specs(cfg), i, 2)
        got = dict(tl.named_parameters(part))
        for name, t in tl.named_parameters(params):
            want = t[2 * i:2 * i + 2] if _is_slab(name) else t
            assert torch.equal(got[name], want), name
    dense = tl.tiny(dtype=torch.float32)
    # A dense model splits no leaf over ep (only its tp blocks).
    assert {expert.split_of(s).axis for s in expert.spec_of(
        tl.param_specs(dense)).values() if s is not None} == {"tp"}


# ------------------------------------------------------------ the worlds
@pytest.mark.parametrize("aux", [False, True], ids=["no-aux", "aux-z-top2"])
@pytest.mark.parametrize("ep,dp", [(2, 1), (2, 2), (4, 1)])
def test_torch_llama_moe_expert_parallel_matches_jax(worlds, ep, dp, aux):
    outs = worlds[ep * dp]
    key = (ep, dp, aux)
    ref_losses, ref = _jax_run(aux, *((ep, dp) if aux else (1, 1)))
    for s in range(2):
        np.testing.assert_allclose(np.mean([o[key][0][s][0] for o in outs]),
                                   ref_losses[s], rtol=2e-4)
        for o in outs:
            np.testing.assert_allclose(o[key][0][s][1], ref_losses[s],
                                       rtol=2e-4)
    got = dict(outs[0][key][1])
    for name in got:
        if _is_slab(name):
            got[name] = np.concatenate([outs[e][key][1][name]
                                        for e in range(ep)])
    assert sorted(got) == sorted(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(got[name], want, rtol=3e-3, atol=3e-5,
                                   err_msg=name)
    for r, o in enumerate(outs):
        for name, t in o[key][1].items():
            np.testing.assert_array_equal(t, outs[r % ep][key][1][name],
                                          err_msg=name)
