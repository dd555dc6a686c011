"""The port's latency fast lane and partitioning, held to each case of
``tests/test_engine_fastlane.py``, and its ping-pong staging.

The lane fork and the split must be bitwise-invisible: the same input
with the lane (or the split) off and on gives the same bytes, with and
without a bf16 wire, and the JAX engine's bytes with the same knob (its
process set [0, 1] on the 8-device CPU mesh).  A pin engages on
resubmission and drops itself on any drift; in a world of two it is keyed
by the response-cache slot and dropped by the controller's
``slot_drop_hook``; parts never re-fuse; copy_in closes before the work on
a pin hit.  The world-of-two cases run in one gloo world of 2 through the
port's launcher; the rest at size 1 in this process.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import threading
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as phvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import engine as pengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _per_rank(rank, shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) * (r + 1)
            for r in range(2)][rank]


@pytest.fixture()
def port1(monkeypatch):
    """A fresh size-1 CPU runtime of the port in this process."""
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(basics, "_state", basics.GlobalState())
    phvd.init(device="cpu")
    yield basics._get_state().engine
    phvd.shutdown()


# ------------------------------------------------------- the world of two
_WORKER = textwrap.dedent("""
    import pickle, sys, time
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import eager
    hvd.init(device="cpu")
    r = hvd.rank()
    eng = hvd.common.basics._get_state().engine
    ctl = eng.controller

    def x(shape, seed):
        rng = np.random.RandomState(seed)
        a = [rng.randn(*shape).astype(np.float32) * (q + 1)
             for q in range(2)][r]
        return torch.from_numpy(a)

    out = {}
    # The lane off and on, fp32 and a bf16 wire.
    xs = [x((999,), 0), x((17, 5), 1)]
    for comp in (None, "bf16"):
        for thr in (0, 1 << 20):
            eng.fast_lane_threshold = thr
            out[("lane", comp, thr)] = [eager.allreduce(
                t.clone(), name=f"fl.{comp}.{thr}.{i}", op=hvd.Sum,
                compression=comp).numpy() for i, t in enumerate(xs)]
    out["lane_dispatches"] = eng.fast_lane_dispatches
    # Slot-keyed pins: cold (by name), slot learned (the name's pin moves
    # to the slot and serves), then hits; the controller's drop hook
    # takes the pin; the next use re-pins, the one after hits.
    hits = []
    p = x((501,), 2)
    for i in range(4):
        eager.allreduce(p.clone(), name="fl.pin", op=hvd.Sum)
        hits.append(eng.fast_lane_hits)
    keys = list(eng._fast_pins)
    slot = [k for k in keys if isinstance(k, int)]
    out["pins"] = dict(hits=hits, slots=len(slot),
                       by_name="fl.pin" in keys,
                       hook=ctl.slot_drop_hook == eng._on_slot_drop)
    ctl._notify_slot_drop(slot[0])
    out["pins"]["after_drop"] = slot[0] in eng._fast_pins
    for i in range(2):
        eager.allreduce(p.clone(), name="fl.pin", op=hvd.Sum)
        hits.append(eng.fast_lane_hits)
    eng.fast_lane_threshold = 0
    # Partitioning over the ops, off and on.
    big = x((100, 41), 9)                      # 32.8 KB global
    cases = [("sum", dict(op=hvd.Sum)),
             ("sum_bf16", dict(op=hvd.Sum, compression="bf16")),
             ("avg", dict(op=hvd.Average, prescale_factor=0.5,
                          postscale_factor=3.0)),
             ("min", dict(op=hvd.Min)), ("max", dict(op=hvd.Max))]
    for name, kw in cases:
        for thr in (0, 8192):
            eng.partition_threshold = thr
            out[("part", name, thr)] = eager.allreduce(
                big.clone(), name=f"pt.{name}.{thr}", **kw).numpy()
    out["splits"] = eng.partition_splits
    # The threshold counts global bytes: 4 KB a rank, 8 KB global.
    eng.partition_threshold = 6000
    s0 = eng.partition_splits
    g = x((1024,), 15)
    out["global"] = (eager.allreduce(g.clone(), name="pt.global",
                                     op=hvd.Sum).numpy(),
                     eng.partition_splits - s0)
    eng.partition_threshold = 0
    out["global_ref"] = eager.allreduce(g.clone(), name="pt.global.ref",
                                        op=hvd.Sum).numpy()
    # Async handles across parts.
    eng.partition_threshold = 8192
    a = x((5000,), 10)
    h = eager.allreduce_async(a.clone(), name="pt.async", op=hvd.Sum)
    parts = len(eng._handles[h].parts)
    polls = 0
    while not eager.poll(h):
        polls += 1
        time.sleep(0.001)
    out["async"] = (eager.synchronize(h).numpy(), parts, polls >= 0)
    eng.partition_threshold = 0
    out["async_ref"] = eager.allreduce(a.clone(), name="pt.async.ref",
                                       op=hvd.Sum).numpy()
    # Both knobs: a big tensor splits, a small one takes the lane.
    big2, small = x((4000,), 13), x((50,), 14)
    out["mix_ref"] = (eager.allreduce(big2.clone(), name="mix.rb",
                                      op=hvd.Sum).numpy(),
                      eager.allreduce(small.clone(), name="mix.rs",
                                      op=hvd.Sum).numpy())
    eng.partition_threshold, eng.fast_lane_threshold = 16384, 4096
    d0, s0 = eng.fast_lane_dispatches, eng.partition_splits
    hb = eager.allreduce_async(big2.clone(), name="mix.b", op=hvd.Sum)
    hs = eager.allreduce_async(small.clone(), name="mix.s", op=hvd.Sum,
                               priority=5)
    out["mix"] = (eager.synchronize(hb).numpy(),
                  eager.synchronize(hs).numpy(),
                  eng.fast_lane_dispatches - d0, eng.partition_splits - s0)
    eng.partition_threshold = eng.fast_lane_threshold = 0
    pp = eng._pingpong
    out["pingpong"] = dict(acquires=pp.acquires, waits=pp.waits,
                           keys=sorted(eng._staging), aborted=pp.aborted)
    hvd.shutdown()
    with open(sys.argv[2] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("FASTLANE_OK", r)
""")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fastlane")
    (tmp / "w.py").write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env.update(PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--output-filename", str(tmp / "logs"), sys.executable,
         str(tmp / "w.py"), REPO, str(tmp / "out")], env=env, cwd=str(tmp),
        timeout=180)
    logs = ""
    for r in range(2):
        for f in ("stdout", "stderr"):
            p = tmp / "logs" / f"rank.{r}" / f
            if p.exists():
                logs += p.read_text()[-3000:]
    assert proc.returncode == 0, logs
    outs = []
    for r in range(2):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture()
def jax_ps(hvd):
    ps = hvd.add_process_set([0, 1])
    yield ps
    hvd.remove_process_set(ps)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape,
                                                       b.dtype, b.shape)
    assert a.tobytes() == b.tobytes(), (a, b)


# ---------------------------------------------------------------- fast lane
def test_torch_fast_lane_bitwise_matches_fused_path(hvd, jax_ps, world2):
    """The lane off and on, fp32 and a bf16 wire: bitwise on both ranks
    and the JAX engine's bytes (its lane on)."""
    from horovod_tpu.common import basics as jbasics
    jeng = jbasics._get_state().engine
    shapes = [((999,), 0), ((17, 5), 1)]
    saved = jeng.fast_lane_threshold
    try:
        jeng.fast_lane_threshold = 1 << 20
        for comp in (None, "bf16"):
            refs = [np.asarray(hvd.allreduce(
                hvd.stack_per_rank([_per_rank(r, s, seed) for r in range(2)],
                                   jax_ps), op=hvd.Sum, compression=comp,
                process_set=jax_ps, name=f"jfl.{comp}.{i}"))
                for i, (s, seed) in enumerate(shapes)]
            for r in range(2):
                off = world2[r][("lane", comp, 0)]
                on = world2[r][("lane", comp, 1 << 20)]
                for a, b, ref in zip(off, on, refs):
                    _same(a, b)
                    _same(b, ref)
    finally:
        jeng.fast_lane_threshold = saved
    assert world2[0]["lane_dispatches"] >= 4


def test_torch_fast_lane_pin_engages_and_survives_resubmission(port1):
    """Size 1 (pins by name): the first submission pins, the second is
    served by the pin, bitwise the unpinned result."""
    eng = port1
    eng.fast_lane_threshold = 1 << 20
    x = torch.from_numpy(_per_rank(0, (501,), 2))
    phvd.allreduce(x.clone(), name="fl_pin", op=phvd.Sum)
    hits0 = eng.fast_lane_hits
    out = phvd.allreduce(x.clone(), name="fl_pin", op=phvd.Sum)
    assert eng.fast_lane_hits == hits0 + 1
    assert list(eng._fast_pins) == ["fl_pin"]
    eng.fast_lane_threshold = 0
    assert torch.equal(out, phvd.allreduce(x.clone(), name="fl_pin_ref",
                                           op=phvd.Sum))


def test_torch_fast_lane_pin_invalidates_on_shape_change(port1):
    """Name reuse under a new shape drops the stale pin and re-pins; the
    result has the new shape."""
    eng = port1
    eng.fast_lane_threshold = 1 << 20
    for _ in range(2):
        phvd.allreduce(torch.ones(64), name="fl_reshape", op=phvd.Sum)
    hits0 = eng.fast_lane_hits
    x = torch.from_numpy(_per_rank(0, (128,), 4))
    out = phvd.allreduce(x.clone(), name="fl_reshape", op=phvd.Sum)
    assert out.shape == (128,) and torch.equal(out, x)
    assert eng.fast_lane_hits == hits0, "a stale pin served a new shape"
    phvd.allreduce(x.clone(), name="fl_reshape", op=phvd.Sum)
    assert eng.fast_lane_hits == hits0 + 1
    # A retuned chunk knob is drift too.
    eng.pipeline_chunk_bytes = 64
    phvd.allreduce(x.clone(), name="fl_reshape", op=phvd.Sum)
    assert eng.fast_lane_hits == hits0 + 1
    assert eng._fast_pins["fl_reshape"].chunks == 8


def test_torch_fast_lane_pins_by_slot_and_drops_on_the_hook(world2):
    """In a world of two the pin is keyed by the response-cache slot once
    the controller has stamped it (the cold start's pin under the name
    moves to the slot and serves from the second submission on); the
    controller's ``slot_drop_hook`` is the engine's and takes the pin; the
    next submission re-pins and the one after is served."""
    for r in range(2):
        pins = world2[r]["pins"]
        assert pins["hook"] and pins["slots"] == 1 and not pins["by_name"]
        assert pins["hits"][:4] == [0, 1, 2, 3], pins["hits"]
        assert not pins["after_drop"]
        assert pins["hits"][4:] == [3, 4], pins["hits"]


def test_torch_fast_lane_skips_groups_and_big_tensors(port1):
    """Grouped members stay fused (atomicity), above-threshold tensors
    stay on the fusion path."""
    eng = port1
    eng.fast_lane_threshold = 256
    d0 = eng.fast_lane_dispatches
    phvd.grouped_allreduce([torch.ones(4), torch.ones(5)], name="fl_group",
                           op=phvd.Sum)
    phvd.allreduce(torch.ones(10000), name="fl_big", op=phvd.Sum)
    assert eng.fast_lane_dispatches == d0
    phvd.allreduce(torch.ones(10), name="fl_small", op=phvd.Sum)
    assert eng.fast_lane_dispatches == d0 + 1


def test_torch_fast_lane_trace_copy_in_collapses(port1):
    """On a pin hit copy_in closes at the pin's fetch, before the work:
    the pack and unpack land in the reduce phase, which dominates."""
    from horovod_tpu_torch.trace import TraceRecorder
    eng = port1
    eng.fast_lane_threshold = 4 << 20
    x = torch.from_numpy(_per_rank(0, (200_000,), 8))
    phvd.allreduce(x.clone(), name="fl_traced", op=phvd.Sum)    # pins
    eng.tracer = TraceRecorder(capacity=256)
    try:
        for i in range(5):
            phvd.allreduce(x * (i + 1), name="fl_traced", op=phvd.Sum)
        summary = eng.tracer.phase_summary()
    finally:
        eng.tracer = None
    ph = summary["phases_us"]
    assert summary["spans"] >= 5
    assert ph["copy_in"] < ph["reduce"], ph


# --------------------------------------------------------------- partitioning
@pytest.mark.parametrize("case", ["sum", "sum_bf16", "avg", "min", "max"])
def test_torch_partition_bitwise_matches_whole_tensor(hvd, jax_ps, world2,
                                                      case):
    """Partition-on results are the unsplit ones bit for bit — fp32, a
    bf16 wire, Average with factors, Min, Max — and the JAX engine's with
    its partitioning on."""
    from horovod_tpu.common import basics as jbasics
    jeng = jbasics._get_state().engine
    kw = {"sum": dict(op=hvd.Sum),
          "sum_bf16": dict(op=hvd.Sum, compression="bf16"),
          "avg": dict(op=hvd.Average, prescale_factor=0.5,
                      postscale_factor=3.0),
          "min": dict(op=hvd.Min), "max": dict(op=hvd.Max)}[case]
    saved = jeng.partition_threshold
    try:
        jeng.partition_threshold = 8192
        ref = np.asarray(hvd.allreduce(hvd.stack_per_rank(
            [_per_rank(r, (100, 41), 9) for r in range(2)], jax_ps),
            process_set=jax_ps, name=f"jpt.{case}", **kw))
    finally:
        jeng.partition_threshold = saved
    for r in range(2):
        _same(world2[r][("part", case, 0)], world2[r][("part", case, 8192)])
        _same(world2[r][("part", case, 8192)], ref)
    assert world2[0]["splits"] >= 5


def test_torch_partition_count_in_fusion_key():
    """The count rides the fusion key: a part never shares a key with a
    same-shaped ordinary tensor, and parts of one parent share one."""
    T = pengine.TensorTableEntry
    t = torch.zeros(100)
    plain = T(handle=1, name="t", ctype=pengine.CollectiveType.ALLREDUCE,
              tensor=t)
    part = T(handle=2, name="t::part0/4",
             ctype=pengine.CollectiveType.ALLREDUCE, tensor=t)
    part.partition = ("t", 0, 4)
    sibling = T(handle=3, name="t::part1/4",
                ctype=pengine.CollectiveType.ALLREDUCE, tensor=t)
    sibling.partition = ("t", 1, 4)
    assert pengine._fusion_key(plain) != pengine._fusion_key(part)
    assert pengine._fusion_key(part) == pengine._fusion_key(sibling)
    assert pengine._fusion_key(part)[-1] == 4


def test_torch_partition_threshold_counts_global_bytes(world2):
    """4 KB a rank, 8 KB global, threshold 6,000: it splits (the gate and
    the plan both count global bytes), bitwise the unsplit result."""
    for r in range(2):
        got, splits = world2[r]["global"]
        assert splits == 1
        _same(got, world2[r]["global_ref"])


def test_torch_partition_poll_and_async_handles(world2, port1):
    """An async partitioned submission: poll converges, synchronize
    returns the whole tensor bitwise; a timeout names the parts
    settled."""
    for r in range(2):
        got, parts, _ = world2[r]["async"]
        assert parts > 1
        _same(got, world2[r]["async_ref"])
    eng = port1
    parent = pengine.TensorTableEntry(
        handle=10**6, name="stuck", ctype=pengine.CollectiveType.ALLREDUCE,
        tensor=torch.zeros(4), output=torch.zeros(4))
    parent.parts = [types.SimpleNamespace(done=threading.Event(),
                                          error=None, done_event=None)
                    for _ in range(3)]
    parent.parts[0].done.set()
    eng._handles[parent.handle] = parent
    assert not eng.poll(parent.handle)
    with pytest.raises(TimeoutError, match=r"1/3 parts settled"):
        eng.synchronize(parent.handle, timeout=0.05)
    parent.parts[1].error = RuntimeError("part 1 failed")
    for s in parent.parts:
        s.done.set()
    assert eng.poll(parent.handle)
    with pytest.raises(RuntimeError, match="part 1 failed"):
        eng.synchronize(parent.handle)


def test_torch_partition_skips_adasum_and_groups(port1):
    """Adasum (its dot products span the whole vector) and grouped
    members (atomic) never split."""
    eng = port1
    eng.partition_threshold = 256
    s0 = eng.partition_splits
    phvd.grouped_allreduce([torch.ones(500)], name="pt_group", op=phvd.Sum)
    phvd.allreduce(torch.ones(500), name="pt_adasum", op=phvd.Adasum)
    assert eng.partition_splits == s0
    phvd.allreduce(torch.ones(500), name="pt_plain", op=phvd.Sum)
    assert eng.partition_splits == s0 + 1


def test_torch_partition_and_fast_lane_compose(world2):
    """Both knobs in one burst: the big tensor splits, the small one takes
    the lane, both bitwise their references."""
    for r in range(2):
        big, small, lane, splits = world2[r]["mix"]
        ref_big, ref_small = world2[r]["mix_ref"]
        _same(big, ref_big)
        _same(small, ref_small)
        assert lane == 1 and splits == 1


def test_torch_pingpong_stages_two_buffers_a_dtype(world2):
    """With the in-flight window the fused batches staged through the
    ping-pong slots: acquires counted, at most two buffers per dtype key,
    none aborted."""
    for r in range(2):
        pp = world2[r]["pingpong"]
        assert pp["acquires"] > 0 and not pp["aborted"]
        keys = {}
        for key, slot in pp["keys"]:
            keys.setdefault(key, set()).add(slot)
        assert keys and all(s <= {0, 1} for s in keys.values()), keys


def test_torch_partitioned_result_freed_without_the_cycle_collector(port1):
    """A partitioned parent and its parts point at each other until the
    parent's synchronize: after it, the result (and the parent's input)
    go with the caller's last reference, with the cycle collector off —
    else every step's partitioned gradients stay allocated until a
    collection (``chip_smoke.py`` E10's partitioned mode showed it in its
    memory between steps)."""
    import gc
    import weakref
    from horovod_tpu_torch.ops import eager
    eng = port1
    eng.partition_threshold = 4096
    gc.collect()
    gc.disable()
    try:
        x = torch.from_numpy(_per_rank(0, (5000,), 16))
        h = eager.allreduce_async(x, name="pt_freed", op=phvd.Sum)
        assert len(eng._handles[h].parts) > 1
        out = eager.synchronize(h)
        assert torch.equal(out, x)
        ref = weakref.ref(out)
        del out
        assert ref() is None, "the parent's output outlived its caller"
    finally:
        gc.enable()
