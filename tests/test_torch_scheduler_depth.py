"""The port's copies of the data-plane depth scheduling pieces
(``horovod_tpu_torch/ops/scheduler.py``) against the JAX scheduler's: the
partition plan and its names, the checkpoint lane's pop and item, the
ping-pong staging slots and the stall inspector's grouping of a
partitioned parent.  Each case runs the same inputs through both modules
and compares what they return, raise and log; the plan and the lane pops
also over hypothesis-drawn inputs.  No world, no device."""

import heapq
import logging
import threading
import time

import pytest
from hypothesis import given, settings, strategies as st

from horovod_tpu.ops import scheduler as J
from horovod_tpu_torch.ops import scheduler as P

MODS = (J, P)


# ------------------------------------------------------------ partition plan
@given(n=st.integers(0, 1 << 22), itemsize=st.sampled_from([1, 2, 4, 8]),
       thr=st.integers(-1, 1 << 22))
@settings(max_examples=300, deadline=None)
def test_torch_partition_plan_matches_jax(n, itemsize, thr):
    """The same (elements, itemsize, threshold) give the same plan; a
    plan tiles [0, n) in order with no empty part."""
    plan = P.partition_plan(n, itemsize, thr)
    assert plan == J.partition_plan(n, itemsize, thr)
    if plan:
        assert len(plan) > 1
        off = 0
        for o, ln in plan:
            assert o == off and ln > 0
            off += ln
        assert off == n


@pytest.mark.parametrize("n,itemsize,thr,parts", [
    (100, 4, 0, 0), (100, 4, 400, 0), (1, 4, 1, 0), (10, 4, 12, 4),
    (32000 * 4096, 2, (64 << 20) // 2, 8), (4096 * 14336, 2,
                                           (64 << 20) // 2, 4)])
def test_torch_partition_plan_edges_match_jax(n, itemsize, thr, parts):
    """Knob off, already fitting, a scalar, and the plans of E10's
    embedding and FFN weights at 64 MiB over two ranks."""
    assert len(P.partition_plan(n, itemsize, thr)) == parts
    assert P.partition_plan(n, itemsize, thr) == \
        J.partition_plan(n, itemsize, thr)


@pytest.mark.parametrize("parent,i,k", [("grad.0", 2, 8), ("a::b", 0, 2),
                                        ("model.embed", 7, 8)])
def test_torch_partition_names_match_jax(parent, i, k):
    name = P.partition_name(parent, i, k)
    assert name == J.partition_name(parent, i, k)
    assert P.parent_of(name) == J.parent_of(name) == parent.rsplit(
        "::part", 1)[0]


# ------------------------------------------------------------ the lanes
def test_torch_lane_constants_match_jax():
    assert (P.FAST_LANE, P.PREFETCH_LANE, P.FUSED_LANE, P.CKPT_LANE) == \
        (J.FAST_LANE, J.PREFETCH_LANE, J.FUSED_LANE, J.CKPT_LANE)


def _heap(mod, items):
    heap = []
    for seq, (lane, prio, payload) in enumerate(items):
        heapq.heappush(heap, (lane, -prio, seq, payload))
    return heap


@given(items=st.lists(st.tuples(st.integers(0, 3), st.integers(-3, 3)),
                      max_size=24),
       budget=st.integers(0, 6), ckpt_budget=st.integers(0, 6))
@settings(max_examples=300, deadline=None)
def test_torch_lane_pops_match_jax(items, budget, ckpt_budget):
    """Any backlog of the four lanes pops alike in both modules: the
    gradient lanes (fast and prefetch budget-exempt), then the checkpoint
    items only once no gradient batch is left, at most their budget."""
    items = [(lane, prio, f"{lane}.{i}") for i, (lane, prio)
             in enumerate(items)]
    outs = []
    for mod in MODS:
        heap = _heap(mod, items)
        grads = mod.pop_gradient_batches(heap, budget)
        ckpt = mod.pop_checkpoint_items(heap, ckpt_budget)
        outs.append((grads, ckpt, [x[3] for x in sorted(heap)]))
    assert outs[0] == outs[1]
    grads, ckpt, _ = outs[1]
    assert not any(p.startswith("3.") for p in grads)
    assert len(ckpt) <= ckpt_budget


def test_torch_checkpoint_items_wait_for_the_gradient_lanes():
    heap = _heap(P, [(P.CKPT_LANE, 0, "ck0"), (P.FUSED_LANE, 0, "g"),
                     (P.CKPT_LANE, 5, "ck1"), (P.PREFETCH_LANE, 0, "pf")])
    assert P.pop_checkpoint_items(heap, 10) == []
    assert P.pop_gradient_batches(heap, 1) == ["pf", "g"]
    assert P.pop_checkpoint_items(heap, 1) == ["ck1"]
    assert P.pop_checkpoint_items(heap, 1) == ["ck0"]


def test_torch_checkpoint_chunk_runs_and_fails_as_jax():
    for mod in MODS:
        ran, failed = [], []
        item = mod.CheckpointChunk("c0", lambda: ran.append(1),
                                   fail=failed.append, priority="3")
        item.run()
        exc = RuntimeError("x")
        item.fail(exc)
        assert (item.name, item.priority, ran, failed) == ("c0", 3, [1],
                                                           [exc])
        mod.CheckpointChunk("c1", lambda: None).fail(exc)   # no fail hook


# ------------------------------------------------------------ ping-pong
def _pingpong_trace(mod):
    """One scripted sequence through a module's PingPongBuffers: what it
    hands out and counts, and whether a third acquire blocks until a
    release and an abort frees a blocked acquirer."""
    pp = mod.PingPongBuffers()
    t0, t1 = pp.acquire("float32"), pp.acquire("float32")
    other = pp.acquire("bfloat16")
    out = [(t0.slot, t1.slot, other.slot), pp.in_flight("float32")]
    got, blocked = [], threading.Event()

    def third():
        got.append(pp.acquire("float32"))
        blocked.set()

    threading.Thread(target=third, daemon=True).start()
    out.append(blocked.wait(0.3))
    pp.release(t0)
    out.append(blocked.wait(5.0))
    out.append(got[0].slot)
    pp.release(t0)                        # a double settle is a no-op
    out.append((pp.in_flight("float32"), pp.acquires, pp.waits))
    woke = threading.Event()
    threading.Thread(target=lambda: (pp.acquire("float32"), woke.set()),
                     daemon=True).start()
    out.append(woke.wait(0.3))
    pp.abort()
    out.append(woke.wait(5.0))
    pp.release(t1)
    out.append((pp.in_flight("float32"), pp.aborted,
                pp.acquire("float32")._released))
    return out


def test_torch_pingpong_matches_jax():
    """Two slots a key, a third acquire blocks until a release and gets
    the freed slot, releases are idempotent, abort settles every token
    once and opens the gate for good — alike in both modules."""
    want = _pingpong_trace(J)
    got = _pingpong_trace(P)
    assert got == want
    assert got[0] == (0, 1, 0) and got[2] is False and got[3] is True


def test_torch_staging_token_matches_jax():
    for mod in MODS:
        tok = mod.StagingToken("k", 1)
        assert (tok.key, tok.slot, tok._released) == ("k", 1, False)


# ------------------------------------------------------------ stall grouping
class _Done:
    def __init__(self, done):
        self._d = done

    def is_set(self):
        return self._d


class _Part:
    def __init__(self, mod, parent, i, k, age):
        self.name = mod.partition_name(parent.name, i, k)
        self.partition = (parent.name, i, k)
        self.parent = parent
        self.enqueue_time = time.monotonic() - age
        self.done = _Done(False)


class _Parent:
    name = "model.embedding"
    parts = ()


@pytest.fixture()
def stall_logs():
    """The stall warnings each module's logger emits."""
    got = []

    class H(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())

    loggers = [J.log, P.log]
    h = H()
    for lg in loggers:
        lg.addHandler(h)
    yield got
    for lg in loggers:
        lg.removeHandler(h)


def test_torch_stall_reports_partitioned_parent_once_as_jax(stall_logs):
    """k stalled parts give ONE warning naming the parent with its parts
    settled, in both modules; a part's progress clears the parent's latch
    so the next check warns afresh."""
    results = []
    for mod in MODS:
        stall_logs.clear()
        parent = _Parent()
        waiting = [_Part(mod, parent, i, 5, 5.0) for i in range(3)]
        settled = [_Part(mod, parent, i, 5, 5.0) for i in range(3, 5)]
        for s in settled:
            s.done = _Done(True)
        parent.parts = waiting + settled
        insp = mod.StallInspector(warn_after_s=1.0, shutdown_after_s=0.0)
        insp.check(waiting)
        msgs = [m for m in stall_logs if "Stall detected" in m]
        stalled = set(insp.stalled)
        insp.progressed(waiting[0].name)
        cleared = "model.embedding" not in insp.stalled
        insp.check(waiting[1:])
        again = len([m for m in stall_logs if "Stall detected" in m])
        results.append((len(msgs), "2/5 parts settled" in msgs[0],
                        "::part" in msgs[0], stalled, cleared, again))
    assert results[0] == results[1]
    assert results[1] == (1, True, False, {"model.embedding"}, True, 2)
