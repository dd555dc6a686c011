"""Port parity: ResNet and the MNIST convnet against the JAX package.

The same seeded numpy inputs go through ``horovod_tpu.models.resnet`` /
``mnist`` and their ports in ``horovod_tpu_torch.models``:

- ResNet-18 and ResNet-50 (bottleneck) at width 8, on 32² and 33²
  images: ``forward`` in training and eval mode with its ``new_stats``,
  and ``loss_fn``'s loss and every leaf gradient against ``jax.grad``, in
  float32 within 1e-4 absolute and relative;
- in bfloat16 compute, every layer of both depths fed the JAX layer's
  input (convolution, batch norm, max-pool, residual) within 2e-2 of the
  reference's largest value, and the whole eval-mode forward within the
  same;
- ``SAME`` padding: a symmetric rule (``k // 2`` a side) shifts the grid
  at 32² and the ``k - s`` rule mis-sizes 33², and each, patched into the
  port, must move the logits off the JAX ones;
- a two-process gloo world, through the port's launcher, of two SGD
  (momentum 0.9) steps with the cross-rank batch norm, against
  ``resnet.make_sharded_train_step`` on 2 of the 8 virtual CPU devices:
  the parameters after the steps, the running statistics and the losses,
  within 1e-4; and the MNIST convnet's two steps against its
  ``make_sharded_train_step`` in the same world.

Why the float32 comparisons of whole networks scale each block's last
batch-norm ``scale`` by 0.2 (the zero-init-residual practice of
large-batch ResNet training): at the plain initialisation a width-8
ResNet-50 in training mode amplifies last-bit differences of summation
order.  Fed the same inputs, each of its layers agrees with the JAX layer
to the last bit or one rounding (the bf16 layer test holds that), yet the
logits drift 1e-4 to 4e-4 apart in float32 and 0.1 to 0.4 in bfloat16.
With the scaled residuals the whole float32 network agrees within 2e-5.

Why the gradient cases draw their images from ``GRAD_SEED``: with the
images of seed 2, an element of the depth-50 33² network lies within
about 1e-5 of a ReLU or max-pool kink, where the gradient jumps.  There a
1e-5 relative change of the images moves the port's own gradients by
9e-4, and the JAX float32 forward and the port's float64 one differ by
1.5e-5, so the two gradients end 2e-3 apart; yet the JAX whole-network
gradient of the last block equals the JAX gradient of that block fed the
same activations, which the port's float64 block matches within 3e-9.
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
from jax.sharding import Mesh

from horovod_tpu.models import mnist as jm
from horovod_tpu.models import resnet as jr
from horovod_tpu_torch.models import mnist as tm
from horovod_tpu_torch.models import resnet as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 2e-2          # of the reference's largest |value|
RES_SCALE = 0.2
LR = 0.1
BATCH = 8
# See the module's docstring for why this seed.
GRAD_SEED = 3


def _cfgs(depth, dtype="float32", sync=None):
    jcfg = jr.ResNetConfig(depth=depth, width=8, num_classes=10,
                           compute_dtype=getattr(jnp, dtype),
                           sync_bn_axis=sync)
    tcfg = tr.ResNetConfig(depth=depth, width=8, num_classes=10,
                           compute_dtype=getattr(torch, dtype),
                           sync_bn_axis=sync)
    return jcfg, tcfg


def _last_conv(depth):
    return "conv2" if depth in jr.BOTTLENECK else "conv1"


def _jax_params(depth, res_scale=RES_SCALE, seed=0):
    """The JAX ``(params, stats)`` as numpy, each block's last batch-norm
    scale times ``res_scale``, the running statistics moved off 0/1 so
    that eval mode reads them."""
    jcfg, _ = _cfgs(depth)
    p, s = jax.tree_util.tree_map(
        np.asarray, jr.init_params(jcfg, jax.random.PRNGKey(seed)))
    for si in range(len(jr.BLOCKS[depth])):
        for bp in p[f"stage{si}"]:
            bn = bp[_last_conv(depth)]["bn"]
            bn["scale"] = bn["scale"] * np.float32(res_scale)
    rng = np.random.RandomState(seed + 1)
    s = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.rand(*a.shape)).astype(np.float32), s)
    return p, s


def _images(size, seed=1, batch=BATCH):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, size, size, 3).astype(np.float32)
    return x, (np.arange(batch) % 10).astype(np.int32)


def _np(tree):
    return jax.tree_util.tree_map(
        lambda t: t.detach().float().numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t, np.float32), tree)


def _assert_tree_close(got, want, **tol):
    got, want = _np(got), _np(want)
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten(want)
    assert g_def == w_def
    for a, b in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(a, b, **tol)


def _rel(got, want):
    """Largest difference over the reference's largest |value|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------------ ResNet
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("depth", [18, 50])
def test_torch_resnet_forward_matches_jax(depth, size, train):
    jcfg, tcfg = _cfgs(depth)
    p, s = _jax_params(depth)
    x, _ = _images(size)
    jlog, jst = jax.jit(lambda p, s, x: jr.forward(p, s, x, jcfg, train))(
        p, s, jnp.asarray(x))
    tp, ts = tr.params_from_jax(p, s)
    tlog, tst = tr.forward(tp, ts, torch.from_numpy(x), tcfg, train)
    assert tlog.dtype == torch.float32 and tlog.shape == (BATCH, 10)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               **TOL)
    _assert_tree_close(tst, jst, **TOL)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("depth", [18, 50])
def test_torch_resnet_grads_match_jax(depth, size):
    jcfg, tcfg = _cfgs(depth)
    p, s = _jax_params(depth)
    x, y = _images(size, seed=GRAD_SEED)
    (jloss, jst), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jr.loss_fn(p, s, jnp.asarray(x), jnp.asarray(y), jcfg,
                             None), has_aux=True))(p)
    tp, ts = tr.params_from_jax(p, s)
    named = dict(tr.named_parameters(tp))
    for t in named.values():
        t.requires_grad_(True)
    loss, tst = tr.loss_fn(tp, ts, torch.from_numpy(x), torch.from_numpy(y),
                           tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    _assert_tree_close(tst, jst, **TOL)
    ref = {n: t.numpy() for n, t in tr.named_parameters(
        tr.params_from_jax(_np(jgrads), s)[0])}
    assert sorted(ref) == sorted(named)
    for n, t in named.items():
        np.testing.assert_allclose(t.grad.numpy(), ref[n], err_msg=n, **TOL)


def _layers_bf16(depth, size):
    """Every layer of the bf16 network, the port fed the JAX layer's
    input: ``[(name, port output, JAX output)]``."""
    jcfg, tcfg = _cfgs(depth, "bfloat16")
    p, s = _jax_params(depth, res_scale=1.0)
    x, _ = _images(size)

    def t(a):             # a JAX NHWC activation as the port's NCHW view
        a = np.array(jnp.asarray(a).astype(jnp.float32))
        return torch.from_numpy(a).to(torch.bfloat16).permute(0, 3, 1, 2)

    def n(a):
        return a.permute(0, 2, 3, 1).float().detach().numpy()

    out = []
    h = jnp.asarray(x).astype(jnp.bfloat16)
    y = jr._conv(h, p["stem"]["w"], 2)
    out.append(("stem conv", n(tr._conv(t(h), torch.tensor(
        p["stem"]["w"]), 2)), y))
    yb, _ = jr._batch_norm(y, p["stem"]["bn"], s["stem"], jcfg, True)
    stem_bn = tr.params_from_jax(p["stem"]["bn"], s["stem"])
    out.append(("stem bn", n(tr._batch_norm(t(y), *stem_bn, tcfg, True,
                                            "")[0]), yb))
    y = jax.nn.relu(yb)
    pooled = jax.lax.reduce_window(y, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                   (1, 2, 2, 1), "SAME")
    out.append(("max-pool", n(tr._max_pool(t(y))), pooled))
    y = pooled
    bottleneck = depth in jr.BOTTLENECK
    for si in range(len(jr.BLOCKS[depth])):
        for bi, (bp, bs) in enumerate(zip(p[f"stage{si}"],
                                          s[f"stage{si}"])):
            stride = 2 if (si > 0 and bi == 0) else 1
            h, res = y, y
            convs = ["conv0", "conv1", "conv2"][:3 if bottleneck else 2]
            if "proj" in bp:
                convs.append("proj")
            for ci, name in enumerate(convs):
                where = f"stage{si}.{bi}.{name}"
                src = y if name == "proj" else h
                st = stride if name == "proj" or \
                    ci == (1 if bottleneck else 0) else 1
                c = jr._conv(src, bp[name]["w"], st)
                out.append((where + " conv", n(tr._conv(
                    t(src), torch.tensor(bp[name]["w"]), st)), c))
                b, _ = jr._batch_norm(c, bp[name]["bn"], bs[name], jcfg,
                                      True)
                bn = tr.params_from_jax(bp[name]["bn"], bs[name])
                out.append((where + " bn", n(tr._batch_norm(
                    t(c), *bn, tcfg, True, "")[0]), b))
                if name == "proj":
                    res = b
                elif ci < len(convs) - 1 - ("proj" in bp):
                    h = jax.nn.relu(b)
                else:
                    h = b
            y = jax.nn.relu(h + res)
            out.append((f"stage{si}.{bi} residual",
                        n(torch.relu(t(h) + t(res))), y))
    return out


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("depth", [18, 50])
def test_torch_resnet_bf16_layers_match_jax(depth, size):
    layers = _layers_bf16(depth, size)
    n_convs = len(list(tr._conv_shapes(_cfgs(depth)[1])))
    assert sum(name.endswith(" bn") for name, _, _ in layers) == n_convs
    for name, got, want in layers:
        assert got.shape == want.shape, name
        assert _rel(got, want) <= BF16_TOL, (name, _rel(got, want))
    # The whole network in eval mode (fixed statistics: no amplification).
    jcfg, tcfg = _cfgs(depth, "bfloat16")
    p, s = _jax_params(depth, res_scale=1.0)
    x, _ = _images(size)
    jlog, _ = jr.forward(p, s, jnp.asarray(x), jcfg, False)
    tlog, _ = tr.forward(*tr.params_from_jax(p, s), torch.from_numpy(x),
                         tcfg, False)
    assert _rel(tlog.detach().numpy(), jlog) <= BF16_TOL


def test_torch_resnet_same_pads_are_xla_s():
    # The 7x7/2 stem on 224, a 3x3/2 convolution and the 3x3/2 pool on an
    # even size, a 1x1/2 projection, stride-1 3x3, and odd sizes.
    assert tr._same_pads(224, 7, 2) == (2, 3)
    assert tr._same_pads(56, 3, 2) == (0, 1)
    assert tr._same_pads(112, 3, 2) == (0, 1)
    assert tr._same_pads(56, 1, 2) == (0, 0)
    assert tr._same_pads(56, 3, 1) == (1, 1)
    assert tr._same_pads(33, 7, 2) == (3, 3)
    assert tr._same_pads(9, 3, 2) == (1, 1)


def _symmetric(n, k, s):
    return k // 2, k // 2


def _k_minus_s(n, k, s):
    total = max(k - s, 0)
    return total // 2, total - total // 2


@pytest.mark.parametrize("size,rule", [(32, _symmetric), (33, _k_minus_s)],
                         ids=["32-symmetric", "33-k-minus-s"])
def test_torch_resnet_other_padding_rules_fail(monkeypatch, size, rule):
    """The parity cases pin XLA's SAME rule: at 32² a symmetric padding
    shifts the stride-2 grids, at 33² the ``k - s`` rule (right only when
    the stride divides the size) mis-sizes them, and either moves the
    logits off the JAX ones."""
    jcfg, tcfg = _cfgs(50)
    p, s = _jax_params(50)
    x, _ = _images(size)
    jlog, _ = jax.jit(lambda p, s, x: jr.forward(p, s, x, jcfg, False))(
        p, s, jnp.asarray(x))
    monkeypatch.setattr(tr, "_same_pads", rule)
    tlog, _ = tr.forward(*tr.params_from_jax(p, s), torch.from_numpy(x),
                         tcfg, False)
    assert _rel(tlog.detach().numpy(), jlog) > 1e-2


def test_torch_resnet_init_and_names():
    cfg = tr.ResNetConfig()
    params, stats = tr.init_params(cfg, torch.Generator().manual_seed(0))
    jp, js = jax.eval_shape(lambda k: jr.init_params(jr.ResNetConfig(), k),
                            jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), (params, stats))
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                            (jp, js))
    named = list(tr.named_parameters(params))
    # 53 convolutions with a batch norm each, and the classifier.
    assert len(named) == 53 * 3 + 2
    assert sum(t.numel() for _, t in named) == 25_557_032
    assert all(t.dtype == torch.float32 and t.requires_grad
               for _, t in named)


# ------------------------------------------------------------------- MNIST
def _mnist_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(seed)))


def test_torch_mnist_synthetic_batch_is_the_jax_one():
    for a, b in zip(tm.synthetic_batch(16, seed=3),
                    jm.synthetic_batch(16, seed=3)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_torch_mnist_forward_loss_and_grads_match_jax():
    p = _mnist_params()
    x, y = jm.synthetic_batch(8, seed=1)
    np.testing.assert_allclose(
        tm.forward(tm.params_from_jax(p), torch.from_numpy(x))
        .detach().numpy(), np.asarray(jm.forward(p, jnp.asarray(x))), **TOL)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        p, jnp.asarray(x), jnp.asarray(y), None)
    tp = tm.params_from_jax(p)
    named = dict(tm.named_parameters(tp))
    for t in named.values():
        t.requires_grad_(True)
    loss = tm.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    ref = dict(tm.named_parameters(tm.params_from_jax(_np(jgrads))))
    assert sorted(ref) == sorted(named) and len(named) == 8
    for n, t in named.items():
        np.testing.assert_allclose(t.grad.numpy(), ref[n].numpy(),
                                   err_msg=n, **TOL)


# ------------------------------------------- two ranks over gloo, vs JAX
_WORKER = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np, torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import mnist as tm, resnet as tr

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    with open(sys.argv[1], "rb") as fh:
        job = pickle.load(fh)

    def local(a):
        c = a.shape[0] // n
        return torch.from_numpy(np.ascontiguousarray(a[r * c:(r + 1) * c]))

    def optimizer(named):
        return hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in named], lr=job["lr"],
                            momentum=0.9),
            named_parameters=named)

    out = {}
    for depth, (p, s, batches) in job["resnet"].items():
        cfg = tr.ResNetConfig(depth=depth, width=8, num_classes=10,
                              compute_dtype=torch.float32)
        params, stats = tr.params_from_jax(p, s)
        named = list(tr.named_parameters(params))
        for _, t in named:
            t.requires_grad_(True)
        step = tr.make_train_step(cfg, optimizer(named))
        ex0 = tr.cross_rank_moments.exchanges
        losses = []
        for x, y in batches:
            loss, stats = step(params, stats, local(x), local(y))
            losses.append(loss.item())
        out[("resnet", depth)] = dict(
            losses=losses, stats=stats,
            params={k: t.detach() for k, t in named},
            exchanges=tr.cross_rank_moments.exchanges - ex0)
    p, batches = job["mnist"]
    params = tm.params_from_jax(p)
    named = list(tm.named_parameters(params))
    for _, t in named:
        t.requires_grad_(True)
    step = tm.make_train_step(optimizer(named))
    losses = [step(params, local(x), local(y)).item() for x, y in batches]
    out["mnist"] = dict(losses=losses,
                        params={k: t.detach() for k, t in named})
    hvd.shutdown()
    with open(sys.argv[2] + "." + os.environ["HOROVOD_RANK"], "wb") as fh:
        pickle.dump(out, fh)
    print("RESNET2_OK", r)
""")

DEPTHS_2 = (18, 50)


def _resnet_job(depth):
    p, s = _jax_params(depth)
    return p, s, [_images(32, seed=10 + i) for i in range(2)]


def _mnist_job():
    return _mnist_params(), [jm.synthetic_batch(BATCH, seed=20 + i)
                             for i in range(2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resnet2")
    job = dict(lr=LR, resnet={d: _resnet_job(d) for d in DEPTHS_2},
               mnist=_mnist_job())
    with open(tmp / "job.pkl", "wb") as fh:
        pickle.dump(job, fh)
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
    assert res.returncode == 0 and res.stdout.count("RESNET2_OK") == 2, (
        res.stdout[-4000:] + res.stderr[-4000:])
    outs = []
    for r in range(2):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.mark.parametrize("depth", DEPTHS_2)
def test_torch_resnet_two_ranks_match_jax_sharded_step(world, depth):
    p, s, batches = _resnet_job(depth)
    jcfg, _ = _cfgs(depth, sync="hvd")
    tx = optax.sgd(LR, momentum=0.9)
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    step = jr.make_sharded_train_step(jcfg, tx, mesh)
    jp, js, jstate = p, s, tx.init(p)
    losses = []
    for x, y in batches:
        jp, js, jstate, loss = step(jp, js, jstate, jnp.asarray(x),
                                    jnp.asarray(y))
        losses.append(float(loss))
    ref = {n: t.numpy() for n, t in tr.named_parameters(
        tr.params_from_jax(_np(jp), s)[0])}
    a, b = (o[("resnet", depth)] for o in world)
    # 2 exchanges (forward, backward) a batch-norm layer and step.
    n_bn = sum(1 for n in ref if n.endswith(".bn.scale"))
    assert a["exchanges"] == b["exchanges"] == 2 * 2 * n_bn
    np.testing.assert_allclose(
        [(u + v) / 2 for u, v in zip(a["losses"], b["losses"])], losses,
        **TOL)
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name
        np.testing.assert_allclose(t.numpy(), ref[name], err_msg=name,
                                   **TOL)
    _assert_tree_close(a["stats"], b["stats"], atol=0, rtol=0)
    _assert_tree_close(a["stats"], _np(js), **TOL)


def test_torch_mnist_two_ranks_match_jax_sharded_step(world):
    p, batches = _mnist_job()
    tx = optax.sgd(LR, momentum=0.9)
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    step = jm.make_sharded_train_step(tx, mesh)
    jp, jstate = p, tx.init(p)
    losses = []
    for x, y in batches:
        jp, jstate, loss = step(jp, jstate, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    a, b = (o["mnist"] for o in world)
    np.testing.assert_allclose(
        [(u + v) / 2 for u, v in zip(a["losses"], b["losses"])], losses,
        **TOL)
    ref = dict(tm.named_parameters(tm.params_from_jax(_np(jp))))
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(),
                                   err_msg=name, **TOL)
