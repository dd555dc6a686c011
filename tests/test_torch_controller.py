"""The port's control plane against the JAX package's.

- The copied ``coordinator.cc`` is ``csrc/coordinator.cc`` byte for byte
  below its header line.
- The copied ``TCPController`` keeps the response cache's steady-state
  guards of ``tests/test_response_cache.py`` (no per-tensor metadata once
  warm, the cold path learning then hitting, a shape change falling back to
  a full announce, the 13-byte warm frame), on the port's own pair of
  clients with per-rank torch entries.
- A mixed pair negotiates against one coordinator: rank 0 is the JAX
  package's controller with a stacked numpy ``[2, *S]`` entry, rank 1 the
  port's with a per-rank torch ``[*S]`` entry.  Their digests are the same
  strings, their verdicts come in the same order, and the warm frame is 13
  bytes on both.
"""

import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.common.controller import TCPController as JaxController
from horovod_tpu.ops import engine as jax_engine
from horovod_tpu_torch.common.controller import TCPController
from horovod_tpu_torch.common.net import free_ports
from horovod_tpu_torch.ops import engine as port_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class E:
    """Minimal negotiable port entry: this rank's own tensor."""

    def __init__(self, name, shape=(4,), gid=-1):
        self.name = name
        self.tensor = torch.zeros(shape)
        self.group_id = gid


class JE:
    """The JAX package's form of the same entry: the stacked array."""

    def __init__(self, name, shape=(4,), gid=-1):
        self.name = name
        self.tensor = np.zeros((2,) + tuple(shape), np.float32)
        self.group_id = gid


def _pair(fn, cls0=TCPController, cls1=TCPController):
    """Run ``fn(ctl, rank)`` on two connected controller clients (rank 0
    hosts the server and keeps it alive until rank 1 finishes)."""
    port, = free_ports(1)
    results, errors = {}, {}
    peer_done = threading.Event()

    def worker(rank):
        cls = cls0 if rank == 0 else cls1
        ctl = cls("127.0.0.1", port, rank=rank, world=2, stall_warn_s=60.0,
                  cache_capacity=2048)
        try:
            results[rank] = fn(ctl, rank)
        except Exception as exc:  # noqa: BLE001 - surfaced by the assert
            errors[rank] = exc
        finally:
            if rank == 1:
                peer_done.set()
                ctl.shutdown()
            else:
                peer_done.wait(timeout=20)
                ctl.shutdown()

    t1 = threading.Thread(target=worker, args=(1,), daemon=True)
    t1.start()
    worker(0)
    t1.join(timeout=20)
    assert not errors, errors
    assert set(results) == {0, 1}, results
    return results


def _steps(ctl, make_entries, n_steps, max_rounds=20):
    """Drive ``n_steps`` submit->negotiate-until-ready cycles; returns the
    verdict order of each."""
    orders = []
    for _ in range(n_steps):
        entries = list(make_entries())
        got = []
        for _round in range(max_rounds):
            if not entries:
                break
            ready, errs = ctl.negotiate(entries)
            assert not errs, errs
            got += [e.name for e in ready]
            entries = [e for e in entries if e.name not in set(got)]
        assert not entries, f"never became ready: {[e.name for e in entries]}"
        orders.append(tuple(got))
    return orders


def test_torch_coordinator_is_a_verbatim_copy():
    with open(os.path.join(REPO, "csrc", "coordinator.cc"), "rb") as fh:
        ref = fh.read()
    with open(os.path.join(REPO, "horovod_tpu_torch", "csrc",
                           "coordinator.cc"), "rb") as fh:
        header, copy = fh.read().split(b"\n", 1)
    assert header.startswith(b"// Copied from csrc/coordinator.cc")
    assert copy == ref


def test_torch_coordinator_builds_its_own_library():
    from horovod_tpu_torch.common import native
    path = native._build()
    assert os.path.basename(path).startswith("libhvdtpu_torch_coord.")
    assert "libhvdtpu_coord." not in path
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "coordinator")


# ------------------------------------------------ steady-state guards
def _steady_state(ctl, rank):
    names = [f"grad.{i}.block.with.a.long.parameter.path" for i in range(12)]
    mk = lambda: [E(n) for n in names]               # noqa: E731
    _steps(ctl, mk, 2)                               # warm-up: learn slots
    st = ctl.cache_stats
    full_before, bytes_before = st.full_announces, ctl.bytes_sent
    orders = _steps(ctl, mk, 5)
    assert st.full_announces == full_before, (
        "steady-state cycles sent per-tensor metadata frames")
    assert st.bit_announces >= 5 * len(names)
    # 4B n_full + 4B bv_len + 2B bitvec + 4B n_tag per cycle.
    assert (ctl.bytes_sent - bytes_before) / 5 <= 16
    assert st.hit_rate() > 0.5
    return orders


def _cold_path(ctl, rank):
    mk = lambda: [E("t", (4,))]                      # noqa: E731
    _steps(ctl, mk, 1)
    st = ctl.cache_stats
    assert st.misses == 1 and st.hits == 0
    _steps(ctl, mk, 3)
    assert st.misses == 1 and st.hits == 3
    return True


def _shape_change(ctl, rank):
    _steps(ctl, lambda: [E("t", (4,))], 2)
    st = ctl.cache_stats
    f0 = st.full_announces
    _steps(ctl, lambda: [E("t", (8,))], 1)           # miss -> full
    assert st.full_announces == f0 + 1
    b0 = st.bit_announces
    _steps(ctl, lambda: [E("t", (8,))], 2)           # relearned -> bits
    assert st.full_announces == f0 + 1
    assert st.bit_announces == b0 + 2
    return True


def _warm_frame_13b(ctl, rank):
    _steps(ctl, lambda: [E("t")], 2)
    st = ctl.cache_stats
    full_before = st.full_announces
    bytes_before, rounds_before = ctl.bytes_sent, ctl.rounds
    _steps(ctl, lambda: [E("t")], 4)
    assert st.full_announces == full_before
    # 4B n_full + 4B bv_len + 1B bitvec + 4B n_tag.
    per_round = (ctl.bytes_sent - bytes_before) / (ctl.rounds - rounds_before)
    assert per_round == 13, per_round
    return True


@pytest.mark.parametrize("case", [_steady_state, _cold_path, _shape_change,
                                  _warm_frame_13b],
                         ids=lambda f: f.__name__.strip("_"))
def test_torch_controller_response_cache_guards(case):
    res = _pair(case)
    assert res[0] == res[1]     # verdict order identical across ranks


# ------------------------------------------------------- the mixed pair
_DTYPES = [(np.float32, torch.float32), (ml_dtypes.bfloat16, torch.bfloat16),
           (np.float16, torch.float16), (np.int32, torch.int32),
           (np.int64, torch.int64)]


@pytest.mark.parametrize("np_dt,torch_dt", _DTYPES,
                         ids=[t.__name__ if hasattr(t, "__name__") else str(t)
                              for t, _ in _DTYPES])
def test_torch_digest_is_the_jax_string(np_dt, torch_dt):
    """The same collective gives the same digest in both packages: per-rank
    shape, numpy dtype names, op, root, factors and wire compression."""
    for shape in [(), (7,), (3, 5, 2)]:
        for kw in [dict(), dict(prescale_factor=0.5, postscale_factor=1 / 3),
                   dict(compression="bf16"),
                   dict(reduce_op="SUM", root_rank=1)]:
            jkw, pkw = dict(kw), dict(kw)
            if "reduce_op" in kw:
                jkw["reduce_op"] = jax_engine.C.ReduceOp.SUM
                pkw["reduce_op"] = port_engine.C.ReduceOp.SUM
            je = jax_engine.TensorTableEntry(
                handle=1, name="t", ctype=jax_engine.CollectiveType.ALLREDUCE,
                tensor=np.zeros((2,) + shape, np_dt), **jkw)
            pe = port_engine.TensorTableEntry(
                handle=1, name="t", ctype=port_engine.CollectiveType.ALLREDUCE,
                tensor=torch.zeros(shape, dtype=torch_dt), **pkw)
            assert TCPController._digest(pe) == JaxController._digest(je)
    for ctype in ("BROADCAST", "BARRIER"):
        je = jax_engine.TensorTableEntry(
            handle=1, name="b", ctype=getattr(jax_engine.CollectiveType, ctype),
            tensor=None if ctype == "BARRIER" else np.zeros((2, 3), np_dt))
        pe = port_engine.TensorTableEntry(
            handle=1, name="b", ctype=getattr(port_engine.CollectiveType,
                                              ctype),
            tensor=None if ctype == "BARRIER" else torch.zeros(
                3, dtype=torch_dt))
        assert TCPController._digest(pe) == JaxController._digest(je)


def test_torch_mixed_pair_negotiates_against_one_coordinator():
    """Rank 0: the JAX controller (its library hosts the server) with
    stacked entries; rank 1: the port's with per-rank entries.  The same
    verdicts in the same order every step, one slot each, and the 13-byte
    warm frame on both once warm."""
    names = [f"layer.{i}.w" for i in range(6)]

    def fn(ctl, rank):
        cls = JE if rank == 0 else E
        orders = _steps(ctl, lambda: [cls(n, (3, 2)) for n in names], 2)
        st = ctl.cache_stats
        assert st.misses == len(names)
        full = st.full_announces
        orders += _steps(ctl, lambda: [cls(n, (3, 2)) for n in names], 3)
        assert st.full_announces == full
        _steps(ctl, lambda: [cls("t")], 2)
        b0, r0 = ctl.bytes_sent, ctl.rounds
        orders += _steps(ctl, lambda: [cls("t")], 3)
        assert st.full_announces == full + 1
        assert (ctl.bytes_sent - b0) / (ctl.rounds - r0) == 13
        return orders

    res = _pair(fn, cls0=JaxController, cls1=TCPController)
    assert res[0] == res[1]
    assert sorted(res[0][0]) == sorted(names)


def test_torch_mixed_pair_digest_mismatch_fails_only_that_tensor():
    """A shape that differs between the packages' ranks is a per-tensor
    negotiation error on both; the other tensor of the round goes ready."""
    def fn(ctl, rank):
        cls = JE if rank == 0 else E
        bad = cls("bad", (4,) if rank == 0 else (5,))
        good = cls("good", (2,))
        ready, errs = [], []
        pending = [bad, good]
        for _ in range(10):
            r, e = ctl.negotiate(pending)
            ready += [x.name for x in r]
            errs += [x.name for x, _ in e]
            pending = [x for x in pending
                       if x.name not in ready and x.name not in errs]
            if not pending:
                break
        return ready, errs

    res = _pair(fn, cls0=JaxController, cls1=TCPController)
    assert res[0] == res[1] == (["good"], ["bad"])
