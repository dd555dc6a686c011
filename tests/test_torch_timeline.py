"""The port's Chrome timeline against the JAX package's.

- ``horovod_tpu_torch/utils/timeline.py`` is a copy: the same activity
  sequence (lanes, instants, counters, cycle marks) into both ``Timeline``
  classes gives the same events, apart from timestamps.
- The engines write the same lanes: a grouped allreduce of eight tensors
  at world 1 on the CPU, through the port's engine and through the JAX
  engine (8 virtual CPU devices in one process), gives each tensor the
  same sequence of activities, the JAX ``XLA_<type>`` read as the port's
  ``NCCL_<type>``.
- ``start_timeline``/``stop_timeline`` after ``init()`` behave as the JAX
  package's (``horovod_tpu/common/basics.py:522-540``).
"""

import json

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.utils.timeline import Timeline as JaxTimeline
from horovod_tpu.utils.timeline import per_rank_filename as jax_per_rank
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.utils.timeline import Timeline, per_rank_filename


@pytest.fixture(autouse=True)
def _fresh_runtime():
    """Each test starts and ends with the port's runtime shut down (an
    earlier test file in the same process may have left it up)."""
    hvd.shutdown()
    yield
    hvd.shutdown()


def _script(tl, seed):
    """A seeded activity sequence: nested lanes, instants, counters and
    cycle marks over a dozen tensors."""
    rng = np.random.RandomState(seed)
    names = [f"grad.{i}" for i in range(12)]
    for cycle in range(20):
        tl.mark_cycle(cycle)
        picked = [names[i] for i in rng.choice(12, 4, replace=False)]
        for n in picked:
            tl.start_activity(n, "QUEUE")
        for n in picked:
            tl.end_activity(n, "QUEUE")
            tl.start_activity(n, "NEGOTIATE_ALLREDUCE")
        tl.counter("negotiation", {"us": float(rng.uniform(0, 99)),
                                   "cache_hits": int(rng.randint(9))})
        for n in picked:
            tl.end_activity(n, "NEGOTIATE_ALLREDUCE")
            tl.start_activity(n, "NCCL_ALLREDUCE")
            tl.end_activity(n, "NCCL_ALLREDUCE")
        if rng.uniform() < 0.3:
            tl.instant("CHECKPOINT", {"cycle": cycle})
    tl.close()


def _events(path):
    with open(path) as fh:
        events = json.load(fh)
    for e in events:
        e.pop("ts", None)
    return events


@pytest.mark.parametrize("mark_cycles", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_timeline_events_match_jax(tmp_path, seed, mark_cycles):
    _script(JaxTimeline(str(tmp_path / "jax.json"), mark_cycles), seed)
    _script(Timeline(str(tmp_path / "port.json"), mark_cycles), seed)
    port = _events(tmp_path / "port.json")
    assert port == _events(tmp_path / "jax.json")
    marks = [e for e in port if e["name"] == "CYCLE_START"]
    assert len(marks) == (20 if mark_cycles else 0)


def test_torch_disabled_timeline_writes_nothing(tmp_path):
    tl = Timeline("")
    assert not tl.enabled
    _script(tl, 0)
    assert per_rank_filename("/x/tl", 3) == jax_per_rank("/x/tl", 3)


def _lanes(path, prefix):
    """tensor lane -> its B/E activity names in order, for the lanes whose
    name starts with ``prefix``."""
    with open(path) as fh:
        events = json.load(fh)
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    out = {}
    for e in events:
        if e.get("ph") in ("B", "E") and names[e["tid"]].startswith(prefix):
            out.setdefault(names[e["tid"]], []).append(
                (e["ph"], e["name"].replace("XLA_", "NCCL_")))
    return out


def test_torch_engine_lanes_match_jax_engine(tmp_path):
    """World 1 on the CPU: a grouped allreduce of eight tensors, twice,
    through each engine with a timeline in its state."""
    import horovod_tpu as jhvd
    jhvd.init()
    jhvd.start_timeline(str(tmp_path / "jax.json"))
    try:
        world = jhvd.size()
        for step in range(2):
            xs = [jhvd.stack_per_rank([np.full((4,), r + i, np.float32)
                                       for r in range(world)])
                  for i in range(8)]
            jhvd.grouped_allreduce(xs, name=f"g{step}", op=jhvd.Sum)
    finally:
        jhvd.stop_timeline()
    hvd.init(device="cpu")
    try:
        hvd.start_timeline(str(tmp_path / "port.json"))
        for step in range(2):
            xs = [torch.full((4,), float(i)) for i in range(8)]
            hvd.grouped_allreduce(xs, name=f"g{step}", op=hvd.Sum)
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    jl = _lanes(tmp_path / "jax.json", "g")
    pl = _lanes(tmp_path / "port.json", "g")
    assert len(pl) == len(jl) == 16
    assert list(pl.values()) == list(jl.values())
    one = list(pl.values())[0]
    assert [a for ph, a in one if ph == "B"] == [
        "QUEUE", "NEGOTIATE_ALLREDUCE", "NCCL_ALLREDUCE"]


def test_torch_start_stop_timeline(tmp_path):
    """Before ``init()`` both raise; after it ``start_timeline`` replaces
    the timeline the engine writes to, with cycle marks on request, and
    ``stop_timeline`` closes the file (valid JSON) and leaves a disabled
    one."""
    with pytest.raises(basics.NotInitializedError):
        hvd.start_timeline(str(tmp_path / "x.json"))
    with pytest.raises(basics.NotInitializedError):
        hvd.stop_timeline()
    hvd.init(device="cpu")
    try:
        path = tmp_path / "tl.json"
        hvd.start_timeline(str(path), mark_cycles=True)
        st = basics._get_state()
        assert st.timeline.enabled
        hvd.allreduce(torch.ones(3), name="t")
        hvd.start_timeline(str(tmp_path / "tl2.json"))
        json.loads(path.read_text())           # the first one was closed
        hvd.allreduce(torch.ones(3), name="t")
        hvd.stop_timeline()
        assert st.timeline is not None and not st.timeline.enabled
        events = json.loads(path.read_text())
        assert any(e["name"] == "CYCLE_START" for e in events)
        assert any(e["name"] == "NCCL_ALLREDUCE" for e in events)
        assert any(e["name"] == "reduce" and e["ph"] == "C"
                   for e in events)
        second = json.loads((tmp_path / "tl2.json").read_text())
        assert not any(e["name"] == "CYCLE_START" for e in second)
        assert any(e["name"] == "QUEUE" for e in second)
        hvd.allreduce(torch.ones(3), name="t")  # disabled: writes nothing
    finally:
        hvd.shutdown()
    assert basics._get_state().timeline is None
