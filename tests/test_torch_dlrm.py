"""Port parity: DLRM (``BASELINE.json`` config 5) against the JAX package.

In this process, ep off: the forward, the loss and every gradient against
``horovod_tpu.models.dlrm`` on the same parameters (float32, rtol 2e-4 /
atol 2e-5), ``synthetic_batch`` bytewise, and a rank's tables drawn alone
(``tables=``) equal to the same rows of the whole draw.

Two gloo worlds, of 2 and 4 processes (side by side, one thread a rank;
a rank's stacks are in its log where a world outlives its limit), train the port two
SGD(0.1) steps at (ep, dp) = (2, 1), (4, 1) and (2, 2), each rank its
block of the batch (dp major, ep fastest), against
``tests/test_models.py::test_dlrm_sharded_matches_reference``'s unsharded
JAX run and tolerances: the losses within rtol 2e-4, the tables within
rtol 2e-3 / atol 1e-6 (and the MLPs with them).  The example runs under
the port's launcher.
"""

import functools
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import dlrm as jd
from horovod_tpu_torch.common.net import reserve_ports
from horovod_tpu_torch.models import dlrm as td
from horovod_tpu_torch.models import llama as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {2: [(2, 1)], 4: [(4, 1), (2, 2)]}


def _jax_params():
    cfg = jd.tiny(dp_axis=None, ep_axis=None)
    return jax.tree_util.tree_map(np.asarray, jd.init_params(
        cfg, jax.random.PRNGKey(0)))


def _flat(tree):
    return {n: t.numpy() for n, t in tl.named_parameters(
        tl.params_from_jax(jax.tree_util.tree_map(np.asarray, tree)))}


@functools.lru_cache(maxsize=None)
def _reference_run():
    """``tests/test_models.py``'s unsharded run: two SGD(0.1) steps of
    ``dlrm.tiny`` on ``synthetic_batch(cfg, 16)``."""
    cfg = jd.tiny(dp_axis=None, ep_axis=None)
    dense, sparse, labels = jd.synthetic_batch(cfg, 16)
    params = jd.init_params(cfg, jax.random.PRNGKey(0))
    opt = optax.sgd(0.1)
    step = jax.jit(jd.make_train_step(cfg, opt))
    p, s = params, opt.init(params)
    losses = []
    for _ in range(2):
        p, s, loss = step(p, s, jnp.asarray(dense), jnp.asarray(sparse),
                          jnp.asarray(labels))
        losses.append(float(loss))
    return losses, _flat(p)


_WORKER = textwrap.dedent("""
    import faulthandler, pickle, signal, sys
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import dlrm as td, llama as tl
    from horovod_tpu_torch.parallel import expert

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    with open(sys.argv[2], "rb") as fh:
        job = pickle.load(fh)
    out = {}

    def block(a):
        c = a.shape[0] // n
        return torch.from_numpy(np.ascontiguousarray(a[r * c:(r + 1) * c]))

    for ep, dp in job["meshes"]:
        mesh = parallel.make_mesh({"dp": dp, "ep": ep})
        cfg = td.tiny()
        specs = td.param_specs(cfg)
        params = expert.shard_tree(tl.params_from_jax(job["params"]), specs,
                                   mesh.index("ep"), ep)
        named = list(tl.named_parameters(params))
        for _, t in named:
            t.requires_grad_(True)
        rep, sh = expert.split_named(named, specs)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in rep], lr=0.1),
            named_parameters=rep)
        eps = expert.ExpertParallel(
            mesh, torch.optim.SGD([t for _, t in sh], lr=0.1))
        step = td.make_train_step(cfg, opt, mesh, eps)
        dense, sparse, labels = (block(a) for a in job["batch"])
        losses = []
        for _ in range(2):
            loss = step(params, dense, sparse, labels)
            losses.append((loss.item(), td.psum_loss(loss, mesh).item()))
        out[(ep, dp)] = (losses,
                         {nm: t.detach().numpy() for nm, t in named})
        eps.shutdown()
        mesh.shutdown()
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("DLRM_OK", r)
""")


def _start(tmp, n, port, port2):
    cfg = jd.tiny(dp_axis=None, ep_axis=None)
    job = dict(params=_jax_params(), batch=jd.synthetic_batch(cfg, 16),
               meshes=MESHES[n])
    with open(tmp / "job.pkl", "wb") as fh:
        pickle.dump(job, fh)
    script = tmp / "dlrm.py"
    script.write_text(_WORKER)
    procs = []
    for r in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port),
                   HOROVOD_CONTROLLER_PORT2=str(port2),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), REPO, str(tmp / "job.pkl"),
             str(tmp / "out")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _collect(tmp, procs):
    logs = {}
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=240)[0]
    except subprocess.TimeoutExpired:
        # Each rank's stacks before the kill: what the world waited on.
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGUSR1)
        time.sleep(2)
    finally:
        for r, p in enumerate(procs):
            p.kill()
            if r not in logs:
                logs[r] = p.communicate()[0]
    logs = [logs[r] for r in range(len(procs))]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log
        assert f"DLRM_OK {r}" in log, log
    outs = []
    for r in range(len(procs)):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmps = {n: tmp_path_factory.mktemp(f"dlrm{n}") for n in (2, 4)}
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


# ------------------------------------------------------------- ep off
def test_torch_dlrm_ep_off_matches_jax():
    cfg_j = jd.tiny(dp_axis=None, ep_axis=None)
    cfg_t = td.tiny(dp_axis=None, ep_axis=None)
    params = _jax_params()
    dense, sparse, labels = jd.synthetic_batch(cfg_j, 16, seed=3)
    args = (jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(labels))
    logits = np.asarray(jd.forward(params, *args[:2], cfg_j))
    loss, grads = jax.value_and_grad(jd.loss_fn)(params, *args, cfg_j)
    tp = tl.params_from_jax(params)
    named = list(tl.named_parameters(tp))
    for _, t in named:
        t.requires_grad_(True)
    targs = [torch.from_numpy(a) for a in (dense, sparse, labels)]
    np.testing.assert_allclose(
        td.forward(tp, *targs[:2], cfg_t).detach().numpy(), logits,
        rtol=2e-4, atol=2e-5)
    tloss = td.loss_fn(tp, *targs, cfg_t)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=2e-4)
    want = _flat(grads)
    for name, t in named:
        np.testing.assert_allclose(t.grad.numpy(), want[name], rtol=2e-4,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("seed", [0, 5])
def test_torch_dlrm_synthetic_batch_is_the_jax_one(seed):
    cfg = jd.tiny()
    for a, b in zip(td.synthetic_batch(td.tiny(), 32, seed),
                    jd.synthetic_batch(cfg, 32, seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_torch_dlrm_rank_draws_its_own_tables():
    """``init_params(tables=...)`` draws a block of tables alone, equal to
    the same rows of the whole draw (each table its own stream), and the
    MLPs alike; the specs name the tables alone as split."""
    cfg = td.tiny(n_tables=4, rows_per_table=50, embed_dim=8)
    full = td.init_params(cfg, torch.Generator().manual_seed(3))
    part = td.init_params(cfg, torch.Generator().manual_seed(3),
                          tables=range(2, 4))
    assert torch.equal(part["tables"], full["tables"][2:4])
    for a, b in zip(tl.named_parameters({"bottom": part["bottom"],
                                         "top": part["top"]}),
                    tl.named_parameters({"bottom": full["bottom"],
                                         "top": full["top"]})):
        assert a[0] == b[0] and torch.equal(a[1], b[1])
    specs = td.param_specs(cfg)
    assert specs["tables"] == "ep"
    assert {v for layer in specs["bottom"] + specs["top"]
            for v in layer.values()} == {None}


# ------------------------------------------------------------ the worlds
@pytest.mark.parametrize("ep,dp", [(2, 1), (4, 1), (2, 2)])
def test_torch_dlrm_expert_parallel_matches_jax(worlds, ep, dp):
    outs = worlds[ep * dp]
    ref_losses, ref = _reference_run()
    for s in range(2):
        np.testing.assert_allclose(
            np.mean([o[(ep, dp)][0][s][0] for o in outs]), ref_losses[s],
            rtol=2e-4)
        for o in outs:
            np.testing.assert_allclose(o[(ep, dp)][0][s][1], ref_losses[s],
                                       rtol=2e-4)
    tables = np.concatenate([outs[e][(ep, dp)][1]["tables"]
                             for e in range(ep)])
    np.testing.assert_allclose(tables, ref["tables"], rtol=2e-3, atol=1e-6)
    for r, o in enumerate(outs):
        for name, t in o[(ep, dp)][1].items():
            if name == "tables":
                np.testing.assert_array_equal(
                    t, outs[r % ep][(ep, dp)][1]["tables"])
            else:
                np.testing.assert_allclose(t, ref[name], rtol=2e-3,
                                           atol=1e-6, err_msg=name)


# ------------------------------------------------------------- example
def test_torch_example_dlrm_alltoall():
    """The ragged-alltoall example under the port's launcher on two gloo
    ranks (``tests/test_examples.py``'s arguments and checks)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, "-m", "horovod_tpu_torch.examples.dlrm_alltoall",
         "--cpu", "--steps", "2", "--batch-size", "16", "--vocab", "64",
         "--dim", "4"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "DONE", r.stdout
    assert "exchanged" in r.stdout
