"""Port parity: the sequence-parallel slice against the JAX package.

Two gloo worlds, of 2 and 4 processes, run the port's ``parallel/`` and
sequence-parallel Llama on seeded numpy inputs (each rank its shard of the
sequence, in rank order along the mesh's ``sp`` axis); the tests gather
the shards and hold them against the JAX package in this process, under
``shard_map`` on 2 and 4 of the 8 virtual CPU devices:

- ``ring_attention`` against the JAX flash ring (its Pallas kernels in
  interpret mode, ``use_flash=True``) and its blockwise ring
  (``use_flash=False``): values and the gradients of q, k and v of
  ``sum(o²)``, causal and not, with GQA; float32, values within rtol 2e-4
  / atol 2e-5 and gradients within 2e-4 / 2e-4, the tolerances of
  ``tests/test_parallel_primitives.py`` (the same arithmetic, summed in
  another order);
- ``ulysses_attention`` against the JAX one, with GQA, same tolerances;
- two steps of Llama training (``DistributedOptimizer(SGD(0.1))``) with the
  sequence split over sp = 2 (ring and Ulysses) and over dp × sp = 2 × 2,
  against the unsharded JAX run of ``tests/test_llama_parallel.py``
  (``_reference_run``): the global mean loss within rtol 2e-4, the
  parameters after two steps within rtol 3e-3 / atol 3e-5, as there;
- the refusals (Ulysses with heads that do not divide by sp, a sliding
  window with sp > 1, decode on an sp mesh), and the mesh: every rank creates
  every axis group in one order, and no mesh group is a process set's.
"""

import importlib
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.models import llama as jl
from horovod_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from horovod_tpu_torch.common.net import reserve_ports
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.parallel import local_flash_attention, make_mesh
from horovod_tpu_torch.parallel import ring_attention

# The module, not the function the package exports under its name.
jra = importlib.import_module("horovod_tpu.parallel.ring_attention")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
B, T, D = 2, 32, 16
# (q heads, kv heads): MHA and GQA; both divide by 4 for Ulysses.
HEADS = {"mha": (8, 8), "gqa": (8, 4)}


def _qkv(heads, seed=11):
    rng = np.random.RandomState(seed)
    H, K = HEADS[heads]
    return tuple(rng.randn(B, T, h, D).astype(np.float32)
                 for h in (H, K, K))


def _data(vocab, batch=8, seq=16, seed=0):
    """``tests/test_llama_parallel.py``'s ``_data``, as numpy."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
    targets = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
    return tokens, targets


def _jax_params():
    cfg = jl.tiny(dtype=jnp.float32, n_layers=2, dp_axis=None, tp_axis=None,
                  sp_axis=None)
    return jax.tree_util.tree_map(np.asarray, jl.init_params(
        cfg, jax.random.PRNGKey(0)))


# The port's side: one script, every job of a world, results by key.
_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch import parallel

    made = []
    _new_group = dist.new_group

    def new_group(ranks, *a, **k):
        made.append(list(ranks))
        return _new_group(ranks, *a, **k)

    dist.new_group = new_group
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    with open(sys.argv[2], "rb") as fh:
        job = pickle.load(fh)
    out = {}

    def shard(x, mesh, dims):
        # This rank's block of x along each (dim, axis) pair.
        t = torch.from_numpy(np.ascontiguousarray(x))
        for dim, axis in dims:
            c = t.shape[dim] // mesh.size(axis)
            t = t.narrow(dim, mesh.index(axis) * c, c)
        return t.contiguous()

    sp = parallel.make_mesh({"sp": n})
    for key, (q, k, v) in job["attn"].items():
        kind, heads, causal = key
        loc = [shard(x, sp, [(1, "sp")]).requires_grad_() for x in (q, k, v)]
        if kind == "ring":
            o = parallel.ring_attention(*loc, sp, causal=causal)
        else:
            o = parallel.ulysses_attention(*loc, sp, causal=causal)
        (o.float() ** 2).sum().backward()
        out[key] = [o.detach().numpy()] + [x.grad.numpy() for x in loc]
    # Refusals.
    x = torch.zeros(1, 4, 2, 8)
    try:
        parallel.ulysses_attention(x, x[:, :, :1], x[:, :, :1], sp)
    except ValueError as exc:
        out["ulysses heads"] = str(exc)
    cfg_w = tl.tiny(dtype=torch.float32, sliding_window=4)
    params_w = tl.init_params(cfg_w, torch.Generator().manual_seed(0))
    toks = torch.zeros(1, 8, dtype=torch.int64)
    try:
        tl.forward(params_w, toks, cfg_w, mesh=sp)
    except ValueError as exc:
        out["window"] = str(exc)
    try:
        tl.prefill(params_w, tl.init_cache(cfg_w, 1, 8), toks, cfg_w,
                   mesh=sp)
    except ValueError as exc:
        out["decode"] = str(exc)
    sp.shutdown()
    # Llama training steps.
    tokens, targets = job["data"]
    for axes, impl in job["llama"]:
        mesh = parallel.make_mesh(axes)
        cfg = tl.tiny(dtype=torch.float32, sp_impl=impl)
        params = tl.params_from_jax(job["params"])
        named = list(tl.named_parameters(params))
        for _, t in named:
            t.requires_grad_(True)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in named], lr=0.1),
            named_parameters=named)
        step = tl.make_train_step(cfg, opt, mesh)
        dims = [(0, "dp")] if "dp" in axes else []
        x, y = (shard(a, mesh, dims + [(1, "sp")]) for a in (tokens, targets))
        losses = []
        for _ in range(2):
            loss = step(params, x, y)
            losses.append((loss.item(),
                           tl.psum_loss(loss, cfg, mesh).item()))
        out[("llama", tuple(axes.items()), impl)] = (
            losses, {nm: t.detach().numpy() for nm, t in named})
        if tuple(axes) == ("dp", "sp") and "mesh" not in out:
            ps = hvd.add_process_set([0, 1])
            groups = {a: mesh.axis(a).group for a in axes}
            out["mesh"] = dict(
                made=list(made),
                ranks={a: mesh.axis(a).ranks for a in axes},
                shared=[a for a, g in groups.items()
                        if g is ps.group or g is hvd.global_process_set.group
                        or g is None])
            hvd.remove_process_set(ps)
        mesh.shutdown()
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("SP_OK", r)
""")


def _attn_jobs(n):
    jobs = {}
    for heads in HEADS:
        for causal in (False, True):
            jobs[("ring", heads, causal)] = _qkv(heads)
            jobs[("ulysses", heads, causal)] = _qkv(heads)
    return jobs


def _start(tmp, n, port, port2):
    vocab = jl.tiny().vocab_size
    llama = [({"sp": 2}, "ring"), ({"sp": 2}, "ulysses")] if n == 2 else \
        [({"dp": 2, "sp": 2}, "ring"), ({"dp": 2, "sp": 2}, "ulysses")]
    job = dict(attn=_attn_jobs(n), params=_jax_params(), data=_data(vocab),
               llama=llama)
    with open(tmp / "job.pkl", "wb") as fh:
        pickle.dump(job, fh)
    script = tmp / "sp.py"
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
    n, logs = len(procs), []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        finally:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log
        assert f"SP_OK {r}" in log, log
    outs = []
    for r in range(n):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, run side by side."""
    tmps = {n: tmp_path_factory.mktemp(f"sp{n}") for n in (2, 4)}
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


def _gathered(outs, key, i):
    """Output ``i`` of ``key`` from every rank, concatenated along T."""
    return np.concatenate([o[key][i] for o in outs], axis=1)


# ------------------------------------------------------------- attention
def _jax_sp(fn, n, q, k, v):
    """``fn`` under shard_map over n CPU devices, the sequence split: the
    output and the gradients of psum(sum(o²))."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    spec = (P(None, "sp"),) * 3
    run = jax.jit(shard_map(fn, mesh=mesh, in_specs=spec,
                            out_specs=P(None, "sp"), check_vma=False))

    def loss(q, k, v):
        return jax.jit(shard_map(
            lambda q, k, v: jax.lax.psum(
                jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2), "sp"),
            mesh=mesh, in_specs=spec, out_specs=P(),
            check_vma=False))(q, k, v)

    args = [jnp.asarray(x) for x in (q, k, v)]
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(run(*args))] + [np.asarray(g) for g in grads]


def _hold(got, want):
    np.testing.assert_allclose(got[0], want[0], **VAL_TOL)
    for g, w, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("use_flash", [True, False],
                         ids=["jax-flash-ring", "jax-blockwise-ring"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("n", [2, 4])
def test_torch_ring_attention_matches_jax(worlds, n, heads, causal,
                                          use_flash):
    key = ("ring", heads, causal)
    q, k, v = _qkv(heads)
    want = _jax_sp(lambda q, k, v: jra.ring_attention(
        q, k, v, axis_name="sp", causal=causal, use_flash=use_flash),
        n, q, k, v)
    _hold([_gathered(worlds[n], key, i) for i in range(4)], want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("n", [2, 4])
def test_torch_ulysses_attention_matches_jax(worlds, n, heads, causal):
    key = ("ulysses", heads, causal)
    q, k, v = _qkv(heads)
    want = _jax_sp(lambda q, k, v: j_ulysses(
        q, k, v, axis_name="sp", causal=causal), n, q, k, v)
    _hold([_gathered(worlds[n], key, i) for i in range(4)], want)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("heads", list(HEADS))
def test_torch_local_flash_attention_matches_jax(heads, window):
    q, k, v = _qkv(heads, seed=3)
    want = jra.local_flash_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=True, window=window)
    got = local_flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL_TOL)


def test_torch_ring_of_one_rank_is_flash_attention():
    """A mesh of one rank (no process group): the ring is step 0 alone,
    the flash attention of the whole sequence, values and gradients."""
    mesh = make_mesh({"sp": 1})
    assert mesh.axis("sp").group is None
    q, k, v = _qkv("gqa")
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = ring_attention(*ins, mesh, causal=True)
    o_ref = local_flash_attention(*ref, causal=True)
    (o ** 2).sum().backward()
    (o_ref ** 2).sum().backward()
    _hold([t.detach().numpy() for t in [o] + [x.grad for x in ins]],
          [t.detach().numpy() for t in [o_ref] + [x.grad for x in ref]])


# ----------------------------------------------------------------- llama
@pytest.fixture(scope="module")
def reference():
    from test_llama_parallel import _reference_run
    losses, params = _reference_run()
    return losses, {n: t.numpy() for n, t in tl.named_parameters(
        tl.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))}


@pytest.mark.parametrize("axes,impl", [
    ((("sp", 2),), "ring"), ((("sp", 2),), "ulysses"),
    ((("dp", 2), ("sp", 2)), "ring"), ((("dp", 2), ("sp", 2)), "ulysses")],
    ids=["sp2-ring", "sp2-ulysses", "dp2xsp2-ring", "dp2xsp2-ulysses"])
def test_torch_llama_sequence_parallel_matches_jax(worlds, reference, axes,
                                                   impl):
    ref_losses, ref_params = reference
    outs = worlds[int(np.prod([n for _, n in axes]))]
    runs = [o[("llama", axes, impl)] for o in outs]
    for step in range(2):
        # The mean of the ranks' losses, by the engine on every rank.
        logged = {round(losses[step][1], 12) for losses, _ in runs}
        assert len(logged) == 1
        np.testing.assert_allclose(
            np.mean([losses[step][0] for losses, _ in runs]),
            ref_losses[step], rtol=2e-4)
        np.testing.assert_allclose(runs[0][0][step][1], ref_losses[step],
                                   rtol=2e-4)
    for _, params in runs:
        assert sorted(params) == sorted(ref_params)
        for name, t in params.items():
            np.testing.assert_allclose(t, ref_params[name], rtol=3e-3,
                                       atol=3e-5, err_msg=name)


# -------------------------------------------------------------- refusals
def test_torch_ulysses_refuses_heads_sp_does_not_divide(worlds):
    for o in worlds[2]:
        assert "kv heads (1) divisible by the 'sp' axis size (2)" in \
            o["ulysses heads"]


def test_torch_llama_refuses_window_and_decode_with_sp(worlds):
    """A window is refused with sp > 1, and so is a sequence-parallel
    prefill: decode takes a mesh for tp only."""
    for o in worlds[2]:
        assert "sliding_window" in o["window"]
        assert "supports tp only" in o["decode"]


def test_torch_llama_config_refuses_unknown_sp_impl():
    with pytest.raises(ValueError, match="sp_impl must be"):
        tl.tiny(sp_impl="zigzag")


# ------------------------------------------------------------------ mesh
def test_torch_mesh_every_rank_creates_every_group(worlds):
    """dp × sp = 2 × 2 over ranks [[0, 1], [2, 3]]: the dp groups {0, 2},
    {1, 3}, then the sp groups {0, 1}, {2, 3}, created on every rank in
    that order, after the sp = 4 mesh's one group."""
    # The last is the process set [0, 1] that the worker adds.
    want = [[0, 1, 2, 3], [0, 2], [1, 3], [0, 1], [2, 3], [0, 1]]
    for r, o in enumerate(worlds[4]):
        assert o["mesh"]["made"] == want
        assert o["mesh"]["ranks"] == {"dp": (r % 2, r % 2 + 2),
                                      "sp": (r - r % 2, r - r % 2 + 1)}


def test_torch_mesh_groups_are_not_process_set_groups(worlds):
    for o in worlds[4]:
        assert o["mesh"]["shared"] == []


def test_torch_mesh_refuses_wrong_sizes_and_axes():
    with pytest.raises(ValueError, match="require 2 ranks, have 1"):
        make_mesh({"sp": 2})
    mesh = make_mesh({"dp": 1, "sp": 1})
    assert mesh.axis_names == ("dp", "sp") and mesh.shape == {"dp": 1,
                                                              "sp": 1}
    with pytest.raises(ValueError, match="not bound by this mesh"):
        mesh.axis("tp")
