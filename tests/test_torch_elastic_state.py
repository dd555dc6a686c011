"""The port's elastic state, run wrapper, sampler and checkpoints against the
JAX package's, in one process on the CPU.

- ``ObjectState`` commit → mutate → restore → sync gives equal dicts in
  both packages.
- ``TorchState(params=<dict of float32 tensors>)`` commits the same
  ``_saved_state`` (numpy arrays, the same keys) and the same blob digest
  as ``JaxState(params=<the same values>)``; a bfloat16 state makes a
  bitwise round trip through ``encode_state``/``decode_state`` and
  ``load_recovered``.
- The in-place restore: after ``restore()`` and one step the optimizer
  moved the LIVE tensors (the ones the state holds), and its state dict
  was rolled back; ``load_recovered`` never calls a collective.
- ``ElasticSampler`` gives the JAX sampler's indices over resets and
  sizes 1-4 (each module's ``basics`` patched to the same world).
- ``@run``'s control flow matches the JAX wrapper's (the
  ``tests/test_elastic.py`` patterns): restore and reset on a peer
  failure, peer restore only while stale, a drain returns, a host update
  keeps the live state; a data-plane error becomes a fault only once the
  engine latches one.
- Checkpoints: ``save``/``restore``/``latest_step``/``CheckpointManager``
  (interval, GC) and ``save_state``/``restore_state`` give the JAX
  package's values and steps for the same tree and step sequence.

Tolerance: exact everywhere (the same values, bytes and digests).
"""

import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as jckpt
from horovod_tpu.common import basics as jbasics
from horovod_tpu.elastic import state as jstate
from horovod_tpu.elastic import stateplane as jspl
from horovod_tpu.torch.elastic import sampler as jsampler
from horovod_tpu_torch import checkpoint as pckpt
from horovod_tpu_torch.common import basics as pbasics
from horovod_tpu_torch.common.exceptions import (DrainRequested,
                                                 HostsUpdatedInterrupt,
                                                 PeerFailureError)
from horovod_tpu_torch.elastic import sampler as psampler
from horovod_tpu_torch.elastic import state as pstate
from horovod_tpu_torch.elastic import stateplane as pspl


def _ident(obj, root_rank=0):
    return obj


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {"wq": rs.randn(8, 4).astype(np.float32),
            "b": rs.randn(4).astype(np.float32),
            "emb": rs.randn(3, 2).astype(np.float32)}


# ---------------------------------------------------------------- states
def test_torch_object_state_matches_jax():
    out = {}
    for name, mod in (("jax", jstate), ("torch", pstate)):
        st = mod.ObjectState(bcast_object=_ident, epoch=1, lr=[0.1, 0.2])
        st.epoch, st.lr[0] = 2, 0.5
        st.commit()
        st.epoch, st.lr[1] = 9, 9.0          # uncommitted
        st.restore()
        st.sync()
        out[name] = (st.epoch, st.lr, st._saved_state)
    assert out["torch"] == out["jax"] == (2, [0.5, 0.2],
                                          {"epoch": 2, "lr": [0.5, 0.2]})


def test_torch_state_commits_jaxstate_bytes():
    """The same parameter values in both states: equal _saved_state and
    an equal blob digest (the state plane's durable bytes)."""
    import jax.numpy as jnp
    p = _params(1)
    js = jstate.JaxState(bcast_object=_ident, step=3,
                         params={k: jnp.asarray(v) for k, v in p.items()})
    ts = pstate.TorchState(bcast_object=_ident, step=3,
                           params={k: torch.from_numpy(v.copy())
                                   for k, v in p.items()})
    js.commit()
    ts.commit()
    assert list(ts._saved_state["params"]) == list(js._saved_state["params"])
    for k in p:
        a, b = ts._saved_state["params"][k], js._saved_state["params"][k]
        assert type(a) is np.ndarray and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jb = jspl.encode_state(js._saved_state)
    pb = pspl.encode_state(ts._saved_state)
    assert pb == jb
    assert pspl.blob_digest(pb) == jspl.blob_digest(jb)


def test_torch_state_bf16_round_trip_is_bitwise():
    """bfloat16 (which numpy lacks) and an empty tensor through commit's
    blob, decode and load_recovered into another state's live tensors."""
    g = torch.Generator().manual_seed(3)
    src = {"w": torch.randn(33, 7, generator=g).to(torch.bfloat16),
           "e": torch.empty(0, dtype=torch.bfloat16),
           "v": [torch.randn(5, generator=g), torch.arange(4)]}
    a = pstate.TorchState(bcast_object=_ident, params=src, step=4)
    blob = pspl.encode_state(a._saved_state)
    dst = {"w": torch.zeros(33, 7, dtype=torch.bfloat16),
           "e": torch.empty(0, dtype=torch.bfloat16),
           "v": [torch.zeros(5), torch.zeros(4, dtype=torch.int64)]}
    ptr = dst["w"].data_ptr()
    b = pstate.TorchState(bcast_object=_ident, params=dst, step=0)
    b.load_recovered(pspl.decode_state(blob))
    assert b.step == 4 and dst["w"].data_ptr() == ptr
    assert torch.equal(dst["w"].view(torch.int16), src["w"].view(torch.int16))
    assert torch.equal(dst["v"][0], src["v"][0])
    assert torch.equal(dst["v"][1], src["v"][1])
    assert pspl.encode_state(b._saved_state) == blob
    # A restore goes back to the recovered values, into the same tensors.
    with torch.no_grad():
        dst["w"].add_(1)
    b.restore()
    assert torch.equal(dst["w"].view(torch.int16), src["w"].view(torch.int16))


@pytest.mark.parametrize("opt_cls", ["AdamW", "SGD"])
def test_torch_state_restore_is_in_place(opt_cls):
    """After restore() and one more step the optimizer moved the live
    tensors (the state's own), from the committed values, and its state
    was rolled back with them: the same as a fresh replay from the
    commit."""
    import horovod_tpu_torch as hvd

    def make(seed):
        g = torch.Generator().manual_seed(seed)
        params = {"a": torch.randn(6, 3, generator=g, requires_grad=True),
                  "b": torch.randn(3, generator=g, requires_grad=True)}
        named = sorted(params.items())
        cls = getattr(torch.optim, opt_cls)
        kw = {"lr": 0.1} if opt_cls == "AdamW" else {"lr": 0.1,
                                                      "momentum": 0.9}
        opt = hvd.DistributedOptimizer(cls([t for _, t in named], **kw),
                                       named_parameters=named)
        return params, opt

    def step(params, opt, k):
        opt.zero_grad()
        loss = ((params["a"] @ params["b"]) * (k + 1)).sum()
        loss.backward()
        opt.step()

    hvd.init(device="cpu")
    try:
        params, opt = make(0)
        st = pstate.TorchState(bcast_object=_ident, params=params,
                               optimizer=opt, step=0)
        step(params, opt, 0)
        st.step = 1
        st.commit()
        committed = {k: t.detach().clone() for k, t in params.items()}
        step(params, opt, 1)
        step(params, opt, 2)
        st.restore()
        assert st.step == 1
        for k in params:
            assert st.params[k] is params[k]
            assert torch.equal(params[k], committed[k])
        step(params, opt, 1)
        assert any(not torch.equal(params[k], committed[k]) for k in params)
        live = {id(t) for g in opt.param_groups for t in g["params"]}
        assert live == {id(t) for t in params.values()}
        # A replay from the commit, in a fresh optimizer, agrees bitwise.
        ref, ropt = make(0)
        step(ref, ropt, 0)
        step(ref, ropt, 1)
        for k in params:
            assert torch.equal(params[k], ref[k])
    finally:
        hvd.shutdown()


def test_torch_load_recovered_calls_no_collective(monkeypatch):
    """load_recovered runs only on the stale rank: it must never reach a
    collective (sync's broadcast or a sharded gather)."""
    from horovod_tpu_torch import functions
    from horovod_tpu_torch.ops import eager

    def boom(*a, **k):
        raise AssertionError("collective from load_recovered")

    for mod, names in ((functions, ("broadcast_parameters",
                                    "broadcast_optimizer_state")),
                       (eager, ("grouped_allgather", "broadcast_object"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    params = {"w": torch.zeros(4)}
    opt = torch.optim.SGD([params["w"]], lr=0.1)
    st = pstate.TorchState(bcast_object=boom, params=params, optimizer=opt,
                           step=0)
    data = {"params": {"w": np.full(4, 2.0, np.float32)}, "step": 5,
            "optimizer": pstate._host_tree(opt.state_dict())}
    st.load_recovered(data)
    assert st.step == 5 and torch.equal(params["w"], torch.full((4,), 2.0))


# --------------------------------------------------------------- sampler
@pytest.mark.parametrize("sizes", [(1, 2), (2, 4, 3), (4, 1)])
def test_torch_elastic_sampler_matches_jax(monkeypatch, sizes):
    """Both samplers over a dataset of 23 (shuffled, seed 5): the same
    indices on every rank, batch records and resets through a sequence of
    world sizes."""
    world = {"size": sizes[0], "rank": 0}
    for mod in (jsampler.basics, psampler.basics):
        monkeypatch.setattr(mod, "is_initialized", lambda: True)
        monkeypatch.setattr(mod, "size", lambda: world["size"])
        monkeypatch.setattr(mod, "rank", lambda: world["rank"])
    data = list(range(23))
    for rank in range(sizes[0]):
        world.update(size=sizes[0], rank=rank)
        js = jsampler.ElasticSampler(data, shuffle=True, seed=5)
        ps = psampler.ElasticSampler(data, shuffle=True, seed=5)
        assert list(ps) == list(js) and len(ps) == len(js)
        js.record_batch(0, 2)
        ps.record_batch(0, 2)
        for n in sizes[1:]:
            world.update(size=n, rank=min(rank, n - 1))
            js.reset()
            ps.reset()
            assert list(ps) == list(js)
            assert ps.state_dict() == js.state_dict()
        js.set_epoch(1)
        ps.set_epoch(1)
        assert list(ps) == list(js)


# ----------------------------------------------------------- run wrapper
def _script(kind, exc):
    """A train function and what it raises on each attempt (``exc``: the
    package's exceptions module)."""
    attempts = []
    PeerFailureError, HostsUpdatedInterrupt, DrainRequested = (
        exc.PeerFailureError, exc.HostsUpdatedInterrupt, exc.DrainRequested)

    def train(state):
        attempts.append(state.epoch)
        n = len(attempts)
        if kind == "peer_failure" and n == 1:
            state.epoch = 99            # uncommitted progress: rolled back
            raise PeerFailureError("HVD303 peer died", dead_ranks=[1])
        if kind == "hosts_updated" and n == 1:
            state.epoch = 6             # committed-or-not progress: kept
            raise HostsUpdatedInterrupt(skip_sync=False)
        if kind == "stale" and n == 1:
            raise HostsUpdatedInterrupt(skip_sync=False)
        if kind == "stale" and n == 2:
            raise PeerFailureError("HVD303 peer died", dead_ranks=[1])
        if kind == "drain":
            raise DrainRequested()
        return state.epoch

    return train, attempts


def _drive(mod, basics, monkeypatch, kind):
    events = []
    monkeypatch.setattr(basics, "shutdown", lambda: events.append("down"))
    monkeypatch.setattr(basics, "init", lambda **kw: events.append("up"))
    spl = mod.__name__.rsplit(".", 1)[0] + ".stateplane"
    import importlib
    spl = importlib.import_module(spl)
    plane = object()
    monkeypatch.setattr(spl, "attach", lambda state, p=None: plane)
    monkeypatch.setattr(spl, "maybe_restore",
                        lambda state, p: events.append("restore"))
    exc = importlib.import_module(
        basics.__name__.rsplit(".", 1)[0] + ".exceptions")
    train, attempts = _script(kind, exc)
    state = mod.ObjectState(bcast_object=_ident, epoch=5)
    state.commit()
    rv = mod.run(train)(state)
    return rv, attempts, events


@pytest.mark.parametrize("kind", ["peer_failure", "hosts_updated", "stale",
                                  "drain"])
def test_torch_run_control_flow_matches_jax(monkeypatch, kind):
    got = {}
    for name, mod, basics in (("jax", jstate, jbasics),
                              ("torch", pstate, pbasics)):
        got[name] = _drive(mod, basics, monkeypatch, kind)
    assert got["torch"] == got["jax"]
    rv, attempts, events = got["torch"]
    want = {"peer_failure": (5, [5, 5], ["restore", "down", "up",
                                         "restore"]),
            "hosts_updated": (5, [5, 5], ["restore", "down", "up"]),
            "stale": (5, [5, 5, 5], ["restore", "down", "up", "down", "up",
                                     "restore"]),
            "drain": (None, [5], ["restore", "down"])}[kind]
    assert (rv, attempts, events) == want


def test_torch_run_data_plane_error_waits_for_the_fault(monkeypatch):
    """A RuntimeError out of a collective is recovered as a fault once the
    engine latches one; with no fault it propagates."""
    import types
    monkeypatch.setattr(pbasics, "shutdown", lambda: None)
    monkeypatch.setattr(pbasics, "init", lambda **kw: None)
    eng = types.SimpleNamespace(controller=object(), fault=None)
    monkeypatch.setattr(pbasics, "_get_state",
                        lambda: types.SimpleNamespace(engine=eng,
                                                      requested_device=None,
                                                      config=None))
    monkeypatch.setattr(pstate, "_world_faulted",
                        lambda wait_s=10.0: eng.fault is not None)

    def train(state):
        state.epoch += 1
        if eng.fault is None and state.epoch < 10:
            eng.fault = PeerFailureError("HVD303", dead_ranks=[1])
            raise RuntimeError("gloo: connection closed by peer")
        return state.epoch

    st = pstate.ObjectState(bcast_object=_ident, epoch=1)
    assert pstate.run(train)(st) == 2          # rolled back to 1, then 2
    eng.fault = None

    def bad(state):
        raise RuntimeError("a user's own error")

    monkeypatch.setattr(pstate, "_world_faulted", lambda wait_s=10.0: False)
    with pytest.raises(RuntimeError, match="user's own"):
        pstate.run(bad)(st)


# ------------------------------------------------------------ checkpoints
def _jtree():
    import jax.numpy as jnp
    return {"params": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                       "b": jnp.ones(4, jnp.float32)},
            "step": jnp.asarray(7, jnp.int32)}


def _ptree():
    return {"params": {"w": torch.arange(12, dtype=torch.float32)
                       .reshape(3, 4), "b": torch.ones(4)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _flat(tree):
    return {k: np.asarray(v) for k, v in (
        ("w", tree["params"]["w"]), ("b", tree["params"]["b"]),
        ("step", tree["step"]))}


def test_torch_checkpoint_round_trip_matches_jax(tmp_path, hvd):
    jckpt.save(str(tmp_path / "j"), _jtree(), step=5)
    pckpt.save(str(tmp_path / "p"), _ptree(), step=5)
    assert pckpt.latest_step(str(tmp_path / "p")) == \
        jckpt.latest_step(str(tmp_path / "j")) == 5
    jout = jckpt.restore(str(tmp_path / "j"), template=_jtree())
    pout = pckpt.restore(str(tmp_path / "p"), template=_ptree())
    for k, v in _flat(jout).items():
        np.testing.assert_array_equal(_flat(pout)[k], v)
        assert _flat(pout)[k].dtype == v.dtype
    np.testing.assert_array_equal(
        _flat(pckpt.restore(str(tmp_path / "p")))["b"], 1.0)


def test_torch_checkpoint_missing_matches_jax(tmp_path):
    for mod in (jckpt, pckpt):
        with pytest.raises(FileNotFoundError):
            mod.restore(str(tmp_path / "nope"))
        assert mod.latest_step(str(tmp_path / "nope")) is None


def test_torch_checkpoint_manager_matches_jax(tmp_path, hvd):
    got = {}
    for name, mod, tree in (("jax", jckpt, _jtree()),
                            ("torch", pckpt, _ptree())):
        mgr = mod.CheckpointManager(str(tmp_path / name), max_to_keep=2,
                                    save_interval_steps=10)
        saved = [mgr.save(s, tree) for s in (5, 10, 20, 30)]
        steps, latest = mgr.all_steps(), mgr.latest_step()
        out = mgr.restore(template=tree)
        forced = mgr.save(31, tree, force=True)
        got[name] = (saved, steps, latest, int(np.asarray(out["step"])),
                     forced, mgr.all_steps())
    assert got["torch"] == got["jax"] == (
        [False, True, True, True], [20, 30], 30, 7, True, [30, 31])


def test_torch_checkpoint_skips_incomplete_step(tmp_path):
    """A step whose manifest is missing (cut off part-way) never counts."""
    pckpt.save(str(tmp_path), _ptree(), step=1)
    pckpt.save(str(tmp_path), _ptree(), step=2)
    (tmp_path / "step_2" / "manifest.json").unlink()
    assert pckpt.latest_step(str(tmp_path)) == 1
    assert not list(tmp_path.glob("**/*.tmp"))


def test_torch_checkpoint_elastic_state_matches_jax(tmp_path, hvd):
    import jax.numpy as jnp
    js = jstate.JaxState(bcast_object=_ident, params={"w": jnp.ones(4)},
                         epoch=3)
    jckpt.save_state(js, str(tmp_path / "j"), step=3)
    jf = jstate.JaxState(bcast_object=_ident, params={"w": jnp.zeros(4)},
                         epoch=0)
    jckpt.restore_state(jf, str(tmp_path / "j"))
    w = torch.zeros(4)
    ps = pstate.TorchState(bcast_object=_ident, params={"w": torch.ones(4)},
                           epoch=3)
    pckpt.save_state(ps, str(tmp_path / "p"), step=3)
    pf = pstate.TorchState(bcast_object=_ident, params={"w": w}, epoch=0)
    pckpt.restore_state(pf, str(tmp_path / "p"))
    assert pf.params["w"] is w                  # loaded in place
    np.testing.assert_array_equal(w.numpy(), np.asarray(jf.params["w"]))
    assert int(pf.epoch) == int(jf.epoch) == 3
    # The restore also rewrote the committed backup.
    jf.params = {"w": jnp.full(4, 9.0)}
    jf.restore()
    with torch.no_grad():
        w.fill_(9.0)
    pf.restore()
    np.testing.assert_array_equal(w.numpy(), np.asarray(jf.params["w"]))


def test_torch_run_frees_the_failed_steps_frames(monkeypatch):
    """The fault a dead generation's engine keeps must not keep the failed
    step's frames: after the wrapper recovers, a tensor that only the
    failed frame held is gone (on the card, the step's autograd graph and
    the dead engine's buffers)."""
    import weakref
    monkeypatch.setattr(pbasics, "shutdown", lambda: None)
    monkeypatch.setattr(pbasics, "init", lambda **kw: None)
    kept, refs = [], []

    def train(state):
        if not refs:
            big = torch.ones(1000)
            refs.append(weakref.ref(big))
            exc = PeerFailureError("HVD303 peer died", dead_ranks=[1])
            kept.append(exc)         # as the engine keeps its fault
            raise exc
        return "done"

    st = pstate.ObjectState(bcast_object=_ident, epoch=1)
    assert pstate.run(train)(st) == "done"
    assert refs[0]() is None and kept[0].__traceback__ is None
