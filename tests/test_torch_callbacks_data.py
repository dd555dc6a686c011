"""Port parity: the training-loop callbacks and the data helpers.

``horovod_tpu_torch.callbacks`` and ``horovod_tpu_torch.data`` against
``horovod_tpu.callbacks`` and ``horovod_tpu.data`` on the same seeded
numpy inputs, one counterpart for each case of
``tests/test_callbacks_data.py``:

- ``shard_indices`` and ``ShardedBatchIterator`` equal to the JAX ones
  (exactly) over a grid of n, size, rank, shuffle and drop_remainder; the
  JAX iterator in its per-process mode (``per_process_mode`` and the world
  patched), which is the port's only mode;
- the warmup and schedule values equal to the JAX callbacks' (exactly, the
  same float64 arithmetic) at sizes 1, 2 and 8, written into an
  optimizer's ``param_groups``; ``warmup_scaled_schedule`` equal to
  ``optax.linear_schedule`` and to the JAX schedule at every step
  (bitwise in float32), past the end too;
- the broadcast and metric-average callbacks at size 1, and in a gloo
  world of two through ``python -m horovod_tpu_torch.runner``: rank 1's
  parameters, optimizer state and nested trees bitwise rank 0's (the JAX
  broadcast's result for rank 0's tree), the metric average bitwise the
  float32 mean, the shards of the two ranks disjoint and each equal to
  the JAX iterator's for its rank;
- the mixin (copied) in order, disabled, propagating an error, and closed
  with a full queue, leaving no thread alive;
- ``prefetch_to_device`` on the CPU: the batches in order, as tensors
  over the same memory, with the same number of batches taken ahead as
  the JAX prefetcher at each yield.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import threading

import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu import callbacks as jcb
from horovod_tpu import data as jdata
from horovod_tpu.common import basics as jbasics
from horovod_tpu.ops import eager as jeager
from horovod_tpu_torch import callbacks as tcb
from horovod_tpu_torch import data as tdata
from horovod_tpu_torch.common import basics as tbasics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _State:
    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


@pytest.fixture()
def port():
    thvd.init(device="cpu")
    return thvd


def _world(monkeypatch, rank, size):
    """Both packages' worlds as one rank of ``size`` in per-process mode."""
    for mod in (jbasics, tbasics):
        monkeypatch.setattr(mod, "is_initialized", lambda: True)
        monkeypatch.setattr(mod, "rank", lambda: rank)
        monkeypatch.setattr(mod, "size", lambda: size)
    monkeypatch.setattr(jeager, "per_process_mode", lambda: True)


# ---------------------------------------------------------------- callbacks
def test_torch_broadcast_global_variables_callback_size1(port):
    rng = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rng.randn(3, 2).astype(np.float32)),
              "b": torch.zeros(2)}
    before = {k: v.clone() for k, v in params.items()}
    opt = torch.optim.SGD([params["w"]], lr=0.1, momentum=0.9)
    state = _State(params=params, opt_state=opt)
    tcb.BroadcastGlobalVariablesCallback(0).on_train_begin(state)
    assert state.params is params and state.opt_state is opt
    for k in params:
        assert torch.equal(params[k], before[k])


def test_torch_broadcast_pytree_nested_matches_jax(port, hvd):
    tree = {"layer": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "step": np.asarray(3, np.int32),
            "pair": [np.ones(2, np.float16), np.asarray([True, False])]}
    want = jcb.broadcast_pytree(tree)
    ttree = {"layer": {"w": torch.from_numpy(tree["layer"]["w"].copy())},
             "step": torch.from_numpy(tree["step"].copy()),
             "pair": [torch.from_numpy(a.copy()) for a in tree["pair"]]}
    out = tcb.broadcast_pytree(ttree)
    assert out is ttree
    for got, ref in ((out["layer"]["w"], want["layer"]["w"]),
                     (out["step"], want["step"]),
                     (out["pair"][0], want["pair"][0]),
                     (out["pair"][1], want["pair"][1])):
        assert got.numpy().dtype == np.asarray(ref).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_torch_metric_average_callback_size1(port, hvd):
    metrics = {"loss": 2.0, "acc": 0.5, "name": "skip-me"}
    want = dict(metrics)
    jcb.MetricAverageCallback().on_epoch_end(0, metrics=want)
    tcb.MetricAverageCallback().on_epoch_end(0, metrics=metrics)
    assert metrics == want == {"loss": 2.0, "acc": 0.5, "name": "skip-me"}


@pytest.mark.parametrize("size", [1, 2, 8])
def test_torch_lr_warmup_callback_matches_jax(monkeypatch, size):
    _world(monkeypatch, 0, size)
    js, ts = _State(lr=0.0), _State(lr=0.0)
    w = torch.zeros(2, requires_grad=True)
    ts.optimizer = torch.optim.SGD([w], lr=0.0)
    ts.optimizer.add_param_group({"params": [torch.zeros(1)], "lr": 7.0})
    jwarm = jcb.LearningRateWarmupCallback(initial_lr=0.1, warmup_epochs=4)
    twarm = tcb.LearningRateWarmupCallback(initial_lr=0.1, warmup_epochs=4)
    for epoch in range(4):
        jwarm.on_epoch_begin(epoch, js)
        twarm.on_epoch_begin(epoch, ts)
        assert ts.lr == js.lr
        assert [g["lr"] for g in ts.optimizer.param_groups] == [js.lr] * 2
    assert ts.lr == pytest.approx(0.1 * size)
    # After the warmup neither touches lr (end_epoch = warmup_epochs).
    js.lr = ts.lr = 123.0
    jwarm.on_epoch_begin(10, js)
    twarm.on_epoch_begin(10, ts)
    assert ts.lr == js.lr == 123.0
    assert ts.optimizer.param_groups[0]["lr"] == 0.1 * size


def test_torch_lr_schedule_callback_matches_jax():
    kw = dict(initial_lr=1.0, multiplier=lambda e: 0.1 ** e, start_epoch=1,
              end_epoch=3)
    js, ts = _State(lr=1.0), _State(lr=1.0)
    jsched = jcb.LearningRateScheduleCallback(**kw)
    tsched = tcb.LearningRateScheduleCallback(**kw)
    seen = []
    for epoch in range(5):
        jsched.on_epoch_begin(epoch, js)
        tsched.on_epoch_begin(epoch, ts)
        assert ts.lr == js.lr
        seen.append(ts.lr)
    assert seen[0] == 1.0 and seen[1] == pytest.approx(0.1)
    assert seen[2] == seen[3] == seen[4] == pytest.approx(0.01)
    const = tcb.LearningRateScheduleCallback(0.5, 3.0)
    const.on_epoch_begin(0, ts)
    assert ts.lr == 1.5


@pytest.mark.parametrize("size", [1, 2, 8])
@pytest.mark.parametrize("base_lr,steps_per_epoch,warmup_epochs", [
    (0.1, 10, 2), (3e-4, 7, 5), (1.0, 1, 0)])
def test_torch_warmup_scaled_schedule_matches_optax(
        size, base_lr, steps_per_epoch, warmup_epochs):
    tsched = tcb.warmup_scaled_schedule(base_lr, steps_per_epoch,
                                        warmup_epochs, size=size)
    jsched = jcb.warmup_scaled_schedule(base_lr, steps_per_epoch,
                                        warmup_epochs, size=size)
    ref = optax.linear_schedule(
        base_lr, base_lr * size, max(warmup_epochs * steps_per_epoch, 1))
    last = max(warmup_epochs * steps_per_epoch, 1)
    for step in range(last + 5):
        got = tsched(step)
        assert isinstance(got, float)
        assert np.float32(got) == np.float32(jsched(step)) \
            == np.float32(ref(step)), step
    assert tsched(last) == pytest.approx(base_lr * size)
    # As LambdaLR's factor on an optimizer at base_lr.
    w = torch.zeros(1, requires_grad=True)
    opt = torch.optim.SGD([w], lr=base_lr)
    lam = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: tsched(s) / base_lr)
    for step in range(3):
        assert opt.param_groups[0]["lr"] == pytest.approx(tsched(step))
        opt.step()
        lam.step()


# -------------------------------------------------------------------- data
class _ListLoader:
    def __init__(self, items):
        self.items = items

    def __iter__(self):
        yield from self.items


class _AsyncListLoader(tdata.AsyncDataLoaderMixin, _ListLoader):
    pass


class _JaxAsyncListLoader(jdata.AsyncDataLoaderMixin, _ListLoader):
    pass


def test_torch_async_data_loader_mixin_order():
    items = [torch.full((2,), float(i)) for i in range(100)]
    loader = _AsyncListLoader(items, async_loader_queue_size=8)
    ref = _JaxAsyncListLoader(items, async_loader_queue_size=8)
    for _ in range(2):  # re-iterable
        got = list(loader)
        assert [t is i for t, i in zip(got, items)] == [True] * 100
        assert [t is i for t, i in zip(list(ref), items)] == [True] * 100
    loader.close_async_loader()
    ref.close_async_loader()
    assert loader._async_thread is None


def test_torch_async_data_loader_disabled():
    loader = _AsyncListLoader([1, 2, 3], async_loader_queue_size=0)
    before = threading.active_count()
    assert list(loader) == [1, 2, 3]
    assert loader._async_thread is None
    assert threading.active_count() == before


def test_torch_async_data_loader_propagates_errors():
    class Bad:
        def __iter__(self):
            yield 1
            raise ValueError("boom")

    class AsyncBad(tdata.AsyncDataLoaderMixin, Bad):
        pass

    loader = AsyncBad(async_loader_queue_size=4)
    with pytest.raises(ValueError, match="boom"):
        list(loader)
    loader.close_async_loader()


def test_torch_async_data_loader_closes_with_a_full_queue():
    loader = _AsyncListLoader(list(range(1000)), async_loader_queue_size=4)
    it = iter(loader)
    assert next(it) == 0
    thread = loader._async_thread
    deadline = 50
    while loader._async_queue.qsize() < 4 and deadline:
        threading.Event().wait(0.01)
        deadline -= 1
    assert loader._async_queue.full()
    loader.close_async_loader()
    assert not thread.is_alive()
    assert loader._async_thread is None


@pytest.mark.parametrize("n", [64, 103])
@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_torch_shard_indices_match_jax(n, size, shuffle, drop_remainder):
    parts = []
    for rank in range(size):
        got = tdata.shard_indices(n, rank=rank, size=size, shuffle=shuffle,
                                  seed=1, drop_remainder=drop_remainder)
        want = jdata.shard_indices(n, rank=rank, size=size, shuffle=shuffle,
                                   seed=1, drop_remainder=drop_remainder)
        np.testing.assert_array_equal(got, want)
        parts.append(got)
    assert len({len(p) for p in parts}) == 1
    flat = np.concatenate(parts)
    if drop_remainder:
        assert len(set(flat.tolist())) == len(flat) == (n // size) * size
    else:
        assert set(flat.tolist()) == set(range(n))


@pytest.mark.parametrize("size,rank", [(1, 0), (2, 1), (4, 2)])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_torch_sharded_batch_iterator_matches_jax(monkeypatch, size, rank,
                                                  shuffle, drop_remainder):
    _world(monkeypatch, rank, size)
    rng = np.random.RandomState(5)
    x = rng.randn(61, 3).astype(np.float32)
    y = rng.randint(0, 10, 61).astype(np.int64)
    kw = dict(batch_size=4, shuffle=shuffle, seed=3,
              drop_remainder=drop_remainder)
    tit = tdata.ShardedBatchIterator([x, y], **kw)
    jit_ = jdata.ShardedBatchIterator([x, y], **kw)
    for epoch in (0, 1):
        tit.set_epoch(epoch)
        jit_.set_epoch(epoch)
        got, want = list(tit), list(jit_)
        assert len(got) == len(want) == len(tit) == len(jit_)
        for (tx, ty), (jx, jy) in zip(got, want):
            assert isinstance(tx, torch.Tensor) and tx.dtype == torch.float32
            np.testing.assert_array_equal(tx.numpy(), jx)
            np.testing.assert_array_equal(ty.numpy(), jy)
    if shuffle:
        tit.set_epoch(0)
        a = [b[0] for b in tit]
        tit.set_epoch(1)
        b = [b[0] for b in tit]
        assert not all(torch.equal(p, q) for p, q in zip(a, b))


def test_torch_sharded_batch_iterator_len_matches_iter_tail():
    x = np.arange(10, dtype=np.float32)
    # Before init(): one shard of everything; drop_remainder=False keeps a
    # short final batch, and len() counts it.
    it = tdata.ShardedBatchIterator([x], batch_size=3, shuffle=False,
                                    drop_remainder=False)
    batches = list(it)
    assert len(batches) == len(it) == 4
    assert sum(len(b[0]) for b in batches) == 10
    with pytest.raises(ValueError, match="length"):
        tdata.ShardedBatchIterator([x, x[:3]], batch_size=2)


def _counting(batches, pulled):
    for b in batches:
        pulled.append(1)
        yield b


@pytest.mark.parametrize("size", [1, 2, 3])
def test_torch_prefetch_to_device_cpu(port, hvd, size):
    batches = [(np.full((2,), i, np.float32), {"y": np.int64(i)})
               for i in range(10)]
    jpulled, tpulled, jahead, tahead = [], [], [], []
    for out in jdata.prefetch_to_device(_counting(batches, jpulled), size):
        jahead.append(len(jpulled))
    outs = []
    for out in tdata.prefetch_to_device(_counting(batches, tpulled), size):
        tahead.append(len(tpulled))
        outs.append(out)
    assert tahead == jahead
    assert len(outs) == 10
    for i, (x, d) in enumerate(outs):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), batches[i][0])
        # The host memory itself, not a copy.
        assert x.data_ptr() == batches[i][0].ctypes.data
        assert int(d["y"]) == i
    host = torch.arange(4)
    (same,) = list(tdata.prefetch_to_device([host], device="cpu"))
    assert same is host


def test_torch_prefetch_to_device_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.prefetch_to_device([np.zeros(2)], device="cuda:0")


# ------------------------------------------------- two ranks over gloo
_WORKER = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np, torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks as cb
    from horovod_tpu_torch.data import ShardedBatchIterator

    class State:
        pass

    hvd.init(device="cpu")
    r = hvd.rank()
    with open(sys.argv[1], "rb") as fh:
        job = pickle.load(fh)
    mine = job["ranks"][r]
    out = {}

    # A module with a buffer and an SGD with momentum: only rank 0 has
    # stepped, so only rank 0's optimizer holds state.
    torch.manual_seed(r)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    if r == 0:
        model(torch.randn(5, 4)).sum().backward()
        opt.step()
    tree = {"layer": {"w": torch.from_numpy(mine["w"])},
            "step": torch.from_numpy(mine["step"]),
            "pair": [torch.from_numpy(a) for a in mine["pair"]]}
    st = State()
    st.params, st.opt_state = model, opt
    cb.BroadcastGlobalVariablesCallback(0).on_train_begin(st)
    st2 = State()
    st2.params, st2.opt_state = tree, {"m": torch.from_numpy(mine["m"])}
    cb.BroadcastGlobalVariablesCallback(0).on_train_begin(st2)
    out["model"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["opt"] = {i: {k: v.clone() for k, v in s.items()}
                  for i, s in opt.state_dict()["state"].items()}
    out["tree"] = st2.params
    out["m"] = st2.opt_state["m"]

    metrics = {"loss": mine["loss"], "acc": mine["acc"], "name": "skip"}
    cb.MetricAverageCallback().on_epoch_end(0, metrics=metrics)
    out["metrics"] = metrics

    st3 = State()
    st3.lr = 0.0
    st3.optimizer = opt
    warm = cb.LearningRateWarmupCallback(0.1, warmup_epochs=2)
    out["lr"] = []
    for epoch in range(3):
        warm.on_epoch_begin(epoch, st3)
        out["lr"].append([g["lr"] for g in opt.param_groups] + [st3.lr])

    it = ShardedBatchIterator([job["x"], job["y"]], batch_size=4, seed=3)
    out["batches"] = []
    for epoch in (0, 1):
        it.set_epoch(epoch)
        out["batches"].append([tuple(t.clone() for t in b) for b in it])
    out["len"] = len(it)
    hvd.shutdown()
    with open(sys.argv[2] + "." + str(r), "wb") as fh:
        pickle.dump(out, fh)
    print("CALLBACKS2_OK", r)
""")


def _rank_inputs(r):
    rng = np.random.RandomState(40 + r)
    return dict(w=rng.randn(2, 3).astype(np.float32),
                step=np.asarray(3 + r, np.int32),
                pair=[rng.randn(2).astype(np.float16),
                      np.asarray([r == 0, r == 1])],
                m=rng.randn(4).astype(np.float32),
                loss=float(rng.rand() * 4), acc=float(rng.rand()))


def _job():
    rng = np.random.RandomState(9)
    return dict(ranks=[_rank_inputs(r) for r in range(2)],
                x=rng.randn(37, 3).astype(np.float32),
                y=np.arange(37, dtype=np.int64))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("callbacks2")
    job = _job()
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
    assert res.returncode == 0 and res.stdout.count("CALLBACKS2_OK") == 2, (
        res.stdout[-4000:] + res.stderr[-4000:])
    outs = []
    for r in range(2):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return job, outs


def test_torch_broadcast_callback_in_a_world_of_two(world2, hvd):
    job, outs = world2
    a, b = outs
    assert sorted(a["model"]) == sorted(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    # Rank 1 had taken no step: it now holds rank 0's momentum buffers.
    assert sorted(a["opt"]) == sorted(b["opt"]) and a["opt"]
    for i in a["opt"]:
        for k in a["opt"][i]:
            assert torch.equal(a["opt"][i][k], b["opt"][i][k]), (i, k)
    # The trees: what the JAX broadcast gives for rank 0's tree.
    r0 = job["ranks"][0]
    want = jcb.broadcast_pytree({"w": r0["w"], "step": r0["step"],
                                 "pair": r0["pair"], "m": r0["m"]})
    for out in outs:
        tree = out["tree"]
        for got, ref in ((tree["layer"]["w"], want["w"]),
                         (tree["step"], want["step"]),
                         (tree["pair"][0], want["pair"][0]),
                         (tree["pair"][1], want["pair"][1]),
                         (out["m"], want["m"])):
            assert got.numpy().dtype == np.asarray(ref).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_torch_metric_average_and_warmup_in_a_world_of_two(world2):
    job, outs = world2
    for key in ("loss", "acc"):
        vals = [np.float32(job["ranks"][r][key]) for r in range(2)]
        want = float((vals[0] + vals[1]) / np.float32(2))
        assert [o["metrics"][key] for o in outs] == [want, want], key
    assert all(o["metrics"]["name"] == "skip" for o in outs)
    lrs = [0.1 * (1.0 + 1.0 * (e + 1) / 2) for e in range(2)]
    for o in outs:
        assert [row[-1] for row in o["lr"][:2]] == lrs
        assert all(row[:-1] == [row[-1]] * (len(row) - 1)
                   for row in o["lr"])
        assert o["lr"][2] == o["lr"][1]      # past the warmup: untouched


def test_torch_sharded_batches_in_a_world_of_two(world2, monkeypatch):
    job, outs = world2
    for r, out in enumerate(outs):
        _world(monkeypatch, r, 2)
        it = jdata.ShardedBatchIterator([job["x"], job["y"]], batch_size=4,
                                        seed=3)
        assert out["len"] == len(it) == 4
        for epoch in (0, 1):
            it.set_epoch(epoch)
            want = list(it)
            assert len(out["batches"][epoch]) == len(want)
            for (tx, ty), (jx, jy) in zip(out["batches"][epoch], want):
                np.testing.assert_array_equal(tx.numpy(), jx)
                np.testing.assert_array_equal(ty.numpy(), jy)
    for epoch in (0, 1):
        rows = [set(int(v) for b in out["batches"][epoch]
                    for v in b[1].tolist()) for out in outs]
        assert rows[0] and rows[1] and not rows[0] & rows[1]
