"""Port parity: the port's training path against the JAX package's.

``loss_fn`` and every leaf gradient against ``jax.value_and_grad`` of the
JAX ``loss_fn`` on ``llama.tiny`` (float32, every mesh axis off), with
``use_flash`` True (the Pallas kernels in interpret mode) and False (the
jnp reference); three steps of ``make_train_step`` with
``DistributedOptimizer(SGD)`` against the JAX ``make_train_step`` with
``optax.sgd``; the ``DistributedOptimizer`` and ``mpi_ops`` surface in a
world of one process; and a real two-process gloo world, where one step on
half the batch per rank equals the single-process step on the whole batch,
the allreduce family gives numpy's answers, and ``broadcast_optimizer_state``
carries SGD momentum to a rank that has none.

Tolerances: 1e-4 on losses, gradients and parameters against JAX (float32
on both sides, matmuls summed in another order by XLA's CPU backend than by
PyTorch's, through two layers and three steps); 1e-5 between the two-rank
and the single-process step (the same PyTorch arithmetic, with the
gradient mean taken as two half-batch means averaged).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import llama as jl
from horovod_tpu_torch.common.net import free_ports
from horovod_tpu_torch.models import llama as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
LR = 0.5


def _models(use_flash, seed=0):
    jcfg = jl.tiny(dtype=jnp.float32, dp_axis=None, tp_axis=None,
                   sp_axis=None, use_flash=use_flash)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for _, t in tl.named_parameters(tparams):
        t.requires_grad_(True)
    return jcfg, jparams, tl.tiny(dtype=torch.float32), tparams


def _batch(seed, B=2, T=24, vocab=256):
    toks = np.random.RandomState(seed).randint(0, vocab, (B, T + 1)).astype(
        np.int32)
    return toks[:, :-1], toks[:, 1:]


def _named_numpy(tree):
    """A JAX tree's leaves by the port's parameter names."""
    return {n: t.numpy() for n, t in tl.named_parameters(
        tl.params_from_jax(jax.tree_util.tree_map(np.asarray, tree)))}


@pytest.fixture()
def world():
    hvd.init(device="cpu")
    return hvd


@pytest.mark.parametrize("use_flash", [True, False])
def test_torch_loss_and_grads_match_jax(use_flash):
    jcfg, jparams, tcfg, tparams = _models(use_flash)
    x, y = _batch(1)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(
        jparams, jnp.asarray(x), jnp.asarray(y), jcfg)
    loss = tl.loss_fn(tparams, torch.from_numpy(x), torch.from_numpy(y),
                      tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    ref = _named_numpy(jgrads)
    named = dict(tl.named_parameters(tparams))
    assert sorted(named) == sorted(ref) and len(named) == 3 + 9 * 2
    for n, t in named.items():
        np.testing.assert_allclose(t.grad.numpy(), ref[n], err_msg=n, **TOL)


@pytest.mark.parametrize("use_flash", [True, False])
def test_torch_train_steps_match_jax(world, use_flash):
    """make_train_step + DistributedOptimizer(SGD) against the JAX
    make_train_step + optax.sgd: the same losses (each the loss before its
    step's update) and parameters after three steps."""
    jcfg, jparams, tcfg, tparams = _models(use_flash, seed=2)
    tx = optax.sgd(LR)
    jstep = jax.jit(jl.make_train_step(jcfg, tx))
    jstate = tx.init(jparams)
    named = list(tl.named_parameters(tparams))
    opt = world.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=LR),
        named_parameters=named)
    step = tl.make_train_step(tcfg, opt)
    for i in range(3):
        x, y = _batch(10 + i)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(x),
                                       jnp.asarray(y))
        loss = step(tparams, torch.from_numpy(x), torch.from_numpy(y))
        assert not loss.requires_grad
        np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    ref = _named_numpy(jparams)
    for n, t in named:
        np.testing.assert_allclose(t.detach().numpy(), ref[n], err_msg=n,
                                   **TOL)


def test_torch_named_parameters_order_and_leaves():
    cfg = tl.tiny(dtype=torch.float32, n_layers=12)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    names = [n for n, _ in tl.named_parameters(params)]
    # Sorted by path, list positions numerically (layer 10 after layer 9).
    assert names[:3] == ["embed", "final_norm", "layers.0.attn_norm"]
    assert names.index("layers.10.wq") > names.index("layers.9.wv")
    assert names[-1] == "lm_head" and len(names) == 3 + 9 * 12
    assert all(t.requires_grad and t.is_leaf
               for _, t in tl.named_parameters(params))


# --------------------------------------------- DistributedOptimizer surface
def _make_model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))


def test_torch_distributed_optimizer_matches_local_sgd(world):
    model, ref_model = _make_model(), _make_model()
    opt = world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    ref_opt = torch.optim.SGD(ref_model.parameters(), lr=0.1)
    x, y = torch.randn(16, 4), torch.randn(16, 2)
    for _ in range(3):
        for m, o in ((model, opt), (ref_model, ref_opt)):
            o.zero_grad()
            torch.nn.functional.mse_loss(m(x), y).backward()
            o.step()
    for p, q in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(p, q)


def test_torch_distributed_optimizer_backward_passes_per_step(world):
    model = _make_model(1)
    opt = world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2)
    x, y = torch.randn(8, 4), torch.randn(8, 2)
    before = [p.clone() for p in model.parameters()]
    for _ in range(2):
        torch.nn.functional.mse_loss(model(x), y).backward()
    opt.step()
    assert all(not torch.allclose(b, a)
               for b, a in zip(before, model.parameters()))


def test_torch_distributed_optimizer_compression(world):
    model = _make_model(2)
    opt = world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        compression=world.Compression.fp16)
    torch.nn.functional.mse_loss(model(torch.randn(4, 4)),
                                 torch.randn(4, 2)).backward()
    opt.step()
    for p in model.parameters():
        assert p.grad.dtype == torch.float32


def test_torch_distributed_optimizer_isinstance_and_checks(world):
    model = _make_model(3)
    opt = world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    assert isinstance(opt, torch.optim.SGD)
    with pytest.raises(NotImplementedError, match="analyzer"):
        world.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1), check=True)
    with pytest.raises(ValueError, match="predivide"):
        world.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), op=world.Sum,
            gradient_predivide_factor=2.0)
    with pytest.raises(ValueError, match="not unique"):
        world.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=[("w", p) for p in model.parameters()])


def test_torch_distributed_optimizer_skip_synchronize(world):
    model = _make_model(4)
    opt = world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    torch.nn.functional.mse_loss(model(torch.randn(4, 4)),
                                 torch.randn(4, 2)).backward()
    before = [p.clone() for p in model.parameters()]
    opt.synchronize()
    with opt.skip_synchronize():
        opt.step()
    assert all(not torch.equal(b, a)
               for b, a in zip(before, model.parameters()))


def test_torch_allreduce_single_process(world):
    """A world of one: the tensor comes back with only the scale factors
    applied, in its own dtype, never aliasing the input; Adasum too (the
    JAX engine's Adasum of one rank is its tensor)."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = world.allreduce(t, op=world.Sum, prescale_factor=2.0,
                          postscale_factor=3.0)
    assert torch.equal(out, t * 6) and out.data_ptr() != t.data_ptr()
    avg = world.allreduce(t)
    assert torch.equal(avg, t) and avg.data_ptr() != t.data_ptr()
    ints = torch.arange(5, dtype=torch.int32)
    assert torch.equal(world.allreduce(ints, op=world.Max,
                                       prescale_factor=2.0), ints * 2)
    x = t.clone()
    assert world.allreduce_(x, op=world.Sum, postscale_factor=0.5) is x
    assert torch.equal(x, t * 0.5)
    h = world.allreduce_async(t, op=world.Min, compression="bf16")
    assert isinstance(h, int) and world.poll(h)
    assert torch.equal(world.synchronize(h), t)
    outs = world.grouped_allreduce([t, ints], op=world.Sum)
    assert torch.equal(outs[0], t) and torch.equal(outs[1], ints)
    ys = [t.clone(), t.clone()]
    assert world.grouped_allreduce_(ys, postscale_factor=2.0)[1] is ys[1]
    assert torch.equal(ys[0], t * 2)
    assert int(world.Average) == 0 and int(world.Adasum) == 2
    ada = world.allreduce(t, op=world.Adasum, prescale_factor=2.0)
    assert torch.equal(ada, t * 2) and ada.data_ptr() != t.data_ptr()
    with pytest.raises(ValueError, match="compression"):
        world.allreduce_async(t, compression="int8")


def test_torch_broadcast_single_process_accepts_binding_forms(world):
    model = _make_model(5)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    assert world.broadcast_parameters(model) is model
    assert world.broadcast_optimizer_state(opt) is opt
    pairs = list(model.named_parameters())
    assert world.broadcast_parameters(pairs) is pairs


# ------------------------------------------------- two-process gloo world
_WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama as tl
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    assert n == 2

    # The allreduce family against numpy over both ranks' arrays.
    arrs = [np.random.RandomState(100 + i).randn(3, 5).astype(np.float32)
            for i in range(n)]
    mine = torch.from_numpy(arrs[r].copy())
    for op, ref in ((hvd.Sum, np.sum), (hvd.Min, np.min), (hvd.Max, np.max)):
        out = hvd.allreduce(mine, op=op)
        assert np.array_equal(out.numpy(), ref(np.stack(arrs), 0)), op
    avg = hvd.allreduce(mine, prescale_factor=2.0, postscale_factor=0.5)
    assert np.allclose(avg.numpy(), np.mean(np.stack(arrs), 0), atol=1e-6)
    ints = torch.arange(4, dtype=torch.int64) * (r + 1)
    assert hvd.allreduce_(ints, op=hvd.Sum) is ints
    assert ints.tolist() == [0, 3, 6, 9]
    hs = hvd.grouped_allreduce_async([mine, mine * 2], op=hvd.Sum)
    outs = hvd.synchronize(hs)
    assert np.array_equal(outs[1].numpy(), 2 * np.sum(np.stack(arrs), 0))
    assert np.array_equal(mine.numpy(), arrs[r])     # inputs untouched

    # Parameters: rank 1 starts from other weights; broadcast makes them
    # rank 0's.
    cfg = tl.tiny(dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(r))
    hvd.broadcast_parameters(params, root_rank=0)
    ref_params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    for (_, a), (_, b) in zip(tl.named_parameters(params),
                              tl.named_parameters(ref_params)):
        assert torch.equal(a, b)

    # One step on half the batch per rank against the single-process step
    # on the whole batch.
    toks = np.random.RandomState(7).randint(0, 256, (4, 25)).astype(np.int64)
    x, y = torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])
    named = list(tl.named_parameters(params))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=0.5),
        named_parameters=named)
    loss = tl.make_train_step(cfg, opt)(params, x[2 * r:2 * r + 2],
                                        y[2 * r:2 * r + 2])
    ref_named = list(tl.named_parameters(ref_params))
    ref_opt = torch.optim.SGD([t for _, t in ref_named], lr=0.5)
    ref_loss = tl.make_train_step(cfg, ref_opt)(ref_params, x, y)
    both = hvd.allreduce(loss.reshape(1))
    assert abs(both.item() - ref_loss.item()) <= 1e-5, (both, ref_loss)
    worst = max((a - b).abs().max().item()
                for (_, a), (_, b) in zip(named, ref_named))
    assert worst <= 1e-5, worst

    # The zero_grad guard and Sum with local aggregation (no 1/bpps).
    lin = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        lin.weight.fill_(1.0)
    lopt = hvd.DistributedOptimizer(
        torch.optim.SGD(lin.parameters(), lr=1.0),
        named_parameters=lin.named_parameters(), op=hvd.Sum,
        backward_passes_per_step=2)
    for _ in range(2):
        lin(torch.ones(1, 2)).sum().backward()
    try:
        lopt.zero_grad()
        raise SystemExit("zero_grad after backward did not raise")
    except AssertionError:
        pass
    lopt.step()
    assert torch.equal(lin.weight.detach(), torch.full((1, 2), -3.0))

    # Optimizer state: SGD momentum exists on rank 0 only, with another lr
    # on rank 1; the broadcast gives rank 1 rank 0's buffers and lr.
    model = torch.nn.Linear(3, 2)
    hvd.broadcast_parameters(model, root_rank=0)
    sgd = torch.optim.SGD(model.parameters(), lr=0.1 if r == 0 else 0.3,
                          momentum=0.9)
    if r == 0:
        model(torch.ones(4, 3)).sum().backward()
        sgd.step()
    hvd.broadcast_optimizer_state(sgd, root_rank=0)
    assert sgd.param_groups[0]["lr"] == 0.1
    bufs = [sgd.state[p]["momentum_buffer"] for p in model.parameters()]
    for b in bufs:
        sums = hvd.allreduce(b, op=hvd.Sum)
        assert torch.equal(sums, 2 * b)
    assert bufs[1].abs().sum() > 0
    hvd.shutdown()
    print("TRAIN2_OK", r)
""")


def test_torch_train_two_process_gloo(tmp_path):
    script = tmp_path / "train2.py"
    script.write_text(_WORKER)
    port, port2 = free_ports(2)
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port),
                   HOROVOD_CONTROLLER_PORT2=str(port2))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), REPO], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=90)[0])
        finally:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"TRAIN2_OK {r}" in out, out
