"""Port parity: BERT and ViT against the JAX package.

The same seeded numpy inputs go through ``horovod_tpu.models.bert`` /
``vit`` and their ports (``tiny`` configurations; ViT at image 32 and
patch 8, so T = 17 rows with the CLS token):

- the encoder states, the loss and every leaf gradient, in float32 within
  1e-4 absolute and relative, with the JAX attention on its Pallas
  kernels in interpret mode (``use_flash=True``) and on its jnp reference
  (``use_flash=False``); the bfloat16 forward within 2e-2 of the
  reference's largest value;
- the FFN's GELU is the tanh approximation (float32 within 1e-6; the
  exact GELU is more than 1e-4 off), and the bfloat16 LayerNorm applies
  its affine after the cast, as the JAX ``_layernorm`` does (bitwise
  equal; a fused ``F.layer_norm`` then cast is not);
- a two-process gloo world through the port's launcher: two masked-LM SGD
  steps with unequal mask counts on the two ranks, and two ViT steps,
  against the JAX steps under ``shard_map`` with ``dp = 2`` on 2 of the 8
  virtual CPU devices: the global losses and the parameters after the
  steps within 1e-4, bitwise equal across the ranks;
- the refusals: a mesh with a tensor- or sequence-parallel axis above 1,
  and ViT's ``sp_axis``.
"""

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
import torch.nn.functional as F
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.models import bert as jb
from horovod_tpu.models import vit as jv
from horovod_tpu_torch.models import bert as tb
from horovod_tpu_torch.models import vit as tv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 2e-2          # of the reference's largest |value|
LR = 0.5
B, T = 4, 24


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcfg(mod, use_flash=None, dtype=jnp.float32, dp=None):
    kw = dict(dtype=dtype, dp_axis=dp, tp_axis=None, use_flash=use_flash)
    if mod is jb:
        kw["sp_axis"] = None
    return mod.tiny(**kw)


def _tcfg(mod, dtype=torch.float32):
    return mod.tiny(dtype=dtype)


def _mlm_batch(seed=0, batch=B, masked=None):
    """Tokens, targets and a 0/1 mask; ``masked``: the masked count of each
    half of the batch (rank 0's rows, rank 1's rows)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 256, (batch, T)).astype(np.int32)
    tgts = rng.randint(0, 256, (batch, T)).astype(np.int32)
    mask = (rng.rand(batch, T) < 0.15).astype(np.float32)
    if masked is not None:
        mask[:] = 0
        half = batch // 2
        for r, n in enumerate(masked):
            flat = mask[r * half:(r + 1) * half].reshape(-1)
            flat[rng.choice(flat.size, n, replace=False)] = 1
            mask[r * half:(r + 1) * half] = flat.reshape(half, T)
    return toks, tgts, mask


def _vit_batch(seed=0, batch=B):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, (batch,)).astype(np.int32))


def _grads_match(named, jgrads, mod):
    ref = {n: t.numpy() for n, t in mod.named_parameters(
        mod.params_from_jax(_np(jgrads)))}
    assert sorted(ref) == sorted(named)
    for n, t in named.items():
        np.testing.assert_allclose(t.grad.numpy(), ref[n], err_msg=n, **TOL)


def _trainable(mod, jparams):
    params = mod.params_from_jax(_np(jparams))
    named = dict(mod.named_parameters(params))
    for t in named.values():
        t.requires_grad_(True)
    return params, named


# -------------------------------------------------------------------- BERT
@pytest.mark.parametrize("use_flash", [True, False])
def test_torch_bert_forward_loss_and_grads_match_jax(use_flash):
    jcfg = _jcfg(jb, use_flash)
    jp = jb.init_params(jcfg, jax.random.PRNGKey(0))
    toks, tgts, mask = _mlm_batch(1)
    params, named = _trainable(tb, jp)
    np.testing.assert_allclose(
        tb.forward(params, torch.from_numpy(toks), _tcfg(tb)).detach()
        .numpy(), np.asarray(jb.forward(jp, jnp.asarray(toks), jcfg)),
        **TOL)
    jloss, jgrads = jax.value_and_grad(jb.mlm_loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jnp.asarray(mask), jcfg)
    loss = tb.mlm_loss_fn(params, torch.from_numpy(toks),
                          torch.from_numpy(tgts), torch.from_numpy(mask),
                          _tcfg(tb))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert len(named) == 5 + 12 * jcfg.n_layers
    _grads_match(named, jgrads, tb)


def test_torch_bert_bf16_forward_matches_jax():
    jcfg = _jcfg(jb, dtype=jnp.bfloat16)
    jp = _np(jb.init_params(jcfg, jax.random.PRNGKey(3)))
    toks, _, _ = _mlm_batch(2)
    want = np.asarray(jb.forward(jp, jnp.asarray(toks), jcfg), np.float32)
    got = tb.forward(tb.params_from_jax(jp), torch.from_numpy(toks),
                     _tcfg(tb, torch.bfloat16)).float().numpy()
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def test_torch_bert_ffn_gelu_is_tanh():
    """float32: the port's FFN against the JAX ``_ffn`` (whose
    ``jax.nn.gelu`` is the tanh approximation) on pre-activations in
    [-4, 4]; PyTorch's exact GELU would be more than 1e-4 off."""
    rng = np.random.RandomState(4)
    D, Fd = 8, 64
    x = rng.randn(16, D).astype(np.float32)
    p = {"w_in": (rng.randn(D, Fd) * 1.5).astype(np.float32),
         "b_in": rng.uniform(-1, 1, Fd).astype(np.float32),
         "w_out": np.eye(Fd, D, dtype=np.float32),
         "b_out": np.zeros(D, np.float32)}
    cfg = _jcfg(jb)
    want = np.asarray(jb._ffn(jnp.asarray(x), p, cfg))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tb._ffn(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    h = torch.from_numpy(x) @ tp["w_in"] + tp["b_in"]
    exact = (F.gelu(h) @ tp["w_out"]).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_torch_bert_layernorm_applies_affine_after_the_cast():
    rng = np.random.RandomState(5)
    x, sc, bi = (jnp.asarray(a).astype(jnp.bfloat16) for a in (
        rng.randn(4, 16, 64) * 3 + 1, rng.randn(64) * 2, rng.randn(64) * 3))

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)

    want = np.asarray(jb._layernorm(x, sc, bi).astype(jnp.float32))
    got = tb._layernorm(t(x), t(sc), t(bi)).float().numpy()
    assert np.array_equal(got, want)
    fused = F.layer_norm(t(x).float(), (64,), t(sc).float(), t(bi).float(),
                         1e-5).to(torch.bfloat16).float().numpy()
    assert (fused == want).mean() < 0.95


@pytest.mark.parametrize("case", ["heads-tp-does-not-divide", "vit-sp"])
def test_torch_bert_refuses_tensor_and_sequence_parallel_meshes(case):
    """What the reference refuses of tp and sp: heads that tp does not
    divide (JAX ``bert.py:119-121``), and ViT with sequence parallelism,
    in its config (``vit.py:61-69``) or from a mesh; a data-parallel mesh
    passes.  (The tp and sp paths themselves are held against JAX in
    ``tests/test_torch_tensor_parallel.py``.)"""
    class Mesh2:
        axis_names = ("dp", "tp", "sp")

        def __init__(self, sizes):
            self.sizes = sizes

        def size(self, ax):
            return self.sizes[ax]

    toks = torch.zeros(1, 8, dtype=torch.int64)
    if case == "heads-tp-does-not-divide":
        cfg = tb.tiny(dtype=torch.float32, n_heads=3, d_model=48)
        params = tb.init_params(cfg, torch.Generator().manual_seed(0))
        tb.forward(params, toks, cfg, mesh=Mesh2(dict(dp=2, tp=1, sp=1)))
        with pytest.raises(ValueError, match="not divisible by tp=2"):
            tb.forward(params, toks, cfg, mesh=Mesh2(dict(dp=1, tp=2, sp=1)))
    else:
        with pytest.raises(ValueError, match="sequence parallelism"):
            tv.tiny(sp_axis="sp")
        cfg = _tcfg(tv)
        params = tv.init_params(cfg, torch.Generator().manual_seed(0))
        images = torch.zeros(1, 32, 32, 3)
        tv.forward(params, images, cfg, mesh=Mesh2(dict(dp=2, tp=1, sp=1)))
        with pytest.raises(ValueError, match="'sp' axis has size 2"):
            tv.forward(params, images, cfg,
                       mesh=Mesh2(dict(dp=1, tp=1, sp=2)))


# --------------------------------------------------------------------- ViT
@pytest.mark.parametrize("use_flash", [True, False])
def test_torch_vit_forward_loss_and_grads_match_jax(use_flash):
    jcfg = _jcfg(jv, use_flash)
    assert jcfg.n_patches + 1 == 17
    jp = jv.init_params(jcfg, jax.random.PRNGKey(1))
    # A CLS token off zero, so that its path is exercised.
    jp["cls"] = jnp.asarray(np.random.RandomState(6).randn(1, 1, 64),
                            jnp.float32)
    x, y = _vit_batch(2)
    params, named = _trainable(tv, jp)
    np.testing.assert_allclose(
        tv.forward(params, torch.from_numpy(x), _tcfg(tv)).detach().numpy(),
        np.asarray(jv.forward(jp, jnp.asarray(x), jcfg)), **TOL)
    jloss, jgrads = jax.value_and_grad(jv.loss_fn)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    loss = tv.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y),
                      _tcfg(tv))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    _grads_match(named, jgrads, tv)


def test_torch_vit_bf16_logits_match_jax():
    jcfg = _jcfg(jv, dtype=jnp.bfloat16)
    jp = _np(jv.init_params(jcfg, jax.random.PRNGKey(3)))
    x, _ = _vit_batch(3)
    want = np.asarray(jv.logits(jp, jnp.asarray(x), jcfg))
    got = tv.logits(tv.params_from_jax(jp), torch.from_numpy(x),
                    _tcfg(tv, torch.bfloat16)).numpy()
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


# ------------------------------------------- two ranks over gloo, vs JAX
STEPS = 2
# Rank 0's rows hold 3 masked positions, rank 1's 17: the per-rank means
# of the masked NLL would weigh the ranks' positions unequally.
MASKED = (3, 17)

_WORKER = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np, torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as tb, vit as tv

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    with open(sys.argv[1], "rb") as fh:
        job = pickle.load(fh)

    def local(a):
        c = a.shape[0] // n
        return torch.from_numpy(np.ascontiguousarray(a[r * c:(r + 1) * c]))

    out = {}
    for name, mod in (("bert", tb), ("vit", tv)):
        cfg = mod.tiny(dtype=torch.float32)
        params = mod.params_from_jax(job[name]["params"])
        named = list(mod.named_parameters(params))
        for _, t in named:
            t.requires_grad_(True)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in named], lr=job["lr"]),
            named_parameters=named)
        step = mod.make_train_step(cfg, opt)
        losses = []
        for batch in job[name]["batches"]:
            loss = step(params, *(local(a) for a in batch))
            losses.append((loss.item(), mod.psum_loss(loss, cfg).item()))
        out[name] = dict(losses=losses,
                         params={k: t.detach() for k, t in named})
    hvd.shutdown()
    with open(sys.argv[2] + "." + os.environ["HOROVOD_RANK"], "wb") as fh:
        pickle.dump(out, fh)
    print("BERT2_OK", r)
""")


def _job():
    jp_b = _np(jb.init_params(_jcfg(jb), jax.random.PRNGKey(7)))
    jp_v = _np(jv.init_params(_jcfg(jv), jax.random.PRNGKey(8)))
    return dict(
        lr=LR,
        bert=dict(params=jp_b, batches=[_mlm_batch(20 + i, masked=MASKED)
                                        for i in range(STEPS)]),
        vit=dict(params=jp_v, batches=[_vit_batch(30 + i)
                                       for i in range(STEPS)]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bert2")
    with open(tmp / "job.pkl", "wb") as fh:
        pickle.dump(_job(), fh)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, str(script), str(tmp / "job.pkl"),
         str(tmp / "out")], env=env, capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0 and res.stdout.count("BERT2_OK") == 2, (
        res.stdout[-4000:] + res.stderr[-4000:])
    outs = []
    for r in range(2):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


def _jax_dp2(mod, params, batches):
    """The JAX ``make_train_step`` with ``dp = 2`` under ``shard_map``:
    the parameters after the batches and the global losses."""
    cfg = _jcfg(mod, dp="dp")
    tx = optax.sgd(LR)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    n_in = len(batches[0])
    step = jax.jit(shard_map(
        mod.make_train_step(cfg, tx), mesh=mesh,
        in_specs=(P(), P()) + (P("dp"),) * n_in, out_specs=(P(), P(), P()),
        check_vma=False))
    state, losses = tx.init(params), []
    for batch in batches:
        params, state, loss = step(params, state,
                                   *(jnp.asarray(a) for a in batch))
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("family", ["bert", "vit"])
def test_torch_two_ranks_match_jax_dp2(world, family):
    mod_j, mod_t = {"bert": (jb, tb), "vit": (jv, tv)}[family]
    job = _job()[family]
    if family == "bert":
        masks = [b[2] for b in job["batches"]]
        assert all(m[:B // 2].sum() == MASKED[0]
                   and m[B // 2:].sum() == MASKED[1] for m in masks)
    jp, jlosses = _jax_dp2(mod_j, job["params"], job["batches"])
    a, b = (o[family] for o in world)
    for (la, ga), (lb, gb), want in zip(a["losses"], b["losses"], jlosses):
        assert ga == gb
        np.testing.assert_allclose(ga, want, **TOL)
        np.testing.assert_allclose((la + lb) / 2, want, **TOL)
    ref = {n: t.numpy() for n, t in mod_t.named_parameters(
        mod_t.params_from_jax(_np(jp)))}
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name
        np.testing.assert_allclose(t.numpy(), ref[name], err_msg=name,
                                   **TOL)
