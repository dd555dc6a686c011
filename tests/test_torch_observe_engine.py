"""Observability wired into the port's engine.

- A two-process gloo world through the port's launcher with the seven
  observability flags: both ranks' timelines parse with every gradient
  through ``QUEUE`` -> ``NEGOTIATE_ALLREDUCE`` -> ``NCCL_ALLREDUCE``, both
  trace files merge (``python -m horovod_tpu_torch.trace``) into two rank
  lanes with cycle flows, rank 0's monitor port answers during a step, and
  rank 0's phase sum is within 5 % of its mean lifecycle.
- Disarmed (no ``HOROVOD_TRACE``, no timeline file) the engine's tracer is
  None and it makes no reduce-phase timing; armed by either, one a batch.
- The reduce phase's stamps on the card's paths, with stand-in CUDA events
  (the CPU has none): the in-flight watcher's settle reads the events at
  once; an inline settle leaves the spans to a later cycle, which commits
  them with the card's time; the phases partition the lifecycle either
  way.  On the CPU the reduce phase is the host's time from the first
  pack to the last unpack.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
import types

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.net import free_ports
from horovod_tpu_torch.common.process_sets import ProcessSetTable
from horovod_tpu_torch.ops import engine as port_engine
from horovod_tpu_torch.trace import TraceRecorder, TraceWriter


@pytest.fixture(autouse=True)
def _fresh_runtime():
    """Each test starts and ends with the port's runtime shut down (an
    earlier test file in the same process may have left it up)."""
    hvd.shutdown()
    yield
    hvd.shutdown()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import json, os, sys, time, urllib.request
    sys.path.insert(0, {repo!r})
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    hvd.init(device="cpu")
    r = hvd.rank()
    st = basics._get_state()
    eng = st.engine
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 4))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    scraped = {{}}
    for step in range(3):
        torch.manual_seed(1 + 10 * r + step)
        x, y = torch.randn(8, 16), torch.randn(8, 4)
        opt.zero_grad()
        ((model(x) - y) ** 2).mean().backward()
        opt.step()
        if r == 0 and step == 1:
            base = "http://127.0.0.1:" + os.environ["HOROVOD_MONITOR_PORT"]
            m = urllib.request.urlopen(base + "/metrics").read().decode()
            scraped["cycles"] = "hvd_cycles_total" in m
            scraped["health"] = json.loads(urllib.request.urlopen(
                base + "/health").read())["status"]
    res = dict(rank=r, summary=eng.tracer.phase_summary(),
               timed=eng.timed_batches, batches=eng.pipeline_dispatches,
               scraped=scraped, ring=eng.tracer.capacity,
               mark=st.timeline._mark_cycles,
               interval=st.monitor.interval_s,
               sums=[float(p.sum()) for p in model.parameters()])
    hvd.shutdown()
    with open(os.path.join(sys.argv[1], "rank%d.json" % r), "w") as fh:
        json.dump(res, fh)
""")


def _lanes(path):
    with open(path) as fh:
        events = json.load(fh)
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    lanes = {}
    for e in events:
        if e.get("ph") == "B":
            lanes.setdefault(names[e["tid"]], []).append(e["name"])
    return lanes, sum(1 for e in events if e["name"] == "CYCLE_START")


def test_torch_two_ranks_with_the_seven_flags(tmp_path):
    worker = tmp_path / "w.py"
    worker.write_text(WORKER.format(repo=REPO))
    port, = free_ports(1)
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeline-filename", str(tmp_path / "tl"),
         "--timeline-mark-cycles", "--trace-filename", str(tmp_path / "tr"),
         "--trace-ring", "512", "--monitor", "--monitor-port", str(port),
         "--monitor-interval", "1", sys.executable, str(worker),
         str(tmp_path)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=180)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert res[0]["sums"] == res[1]["sums"]
    for x in res:
        assert x["ring"] == 512 and x["mark"] is True
        assert x["interval"] == 1.0
        assert x["timed"] == x["batches"] > 0
    assert res[0]["scraped"] == {"cycles": True, "health": "ok"}
    s = res[0]["summary"]
    assert s["phases_us"]["reduce"] > 0
    assert abs(s["phase_sum_us"] - s["cycle_us"]) <= 0.05 * s["cycle_us"]
    for r in range(2):
        lanes, marks = _lanes(tmp_path / f"tl.{r}")
        assert marks > 0
        grads = {n: [a for a in acts if a != "INFLIGHT"]
                 for n, acts in lanes.items() if n.startswith("allreduce.")}
        assert len(grads) == 4
        for acts in grads.values():
            assert acts == ["QUEUE", "NEGOTIATE_ALLREDUCE",
                            "NCCL_ALLREDUCE"] * 3
    merged = tmp_path / "merged.json"
    rep = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.trace",
         str(tmp_path / "tr"), "--report", "-o", str(merged)],
        env=env, capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0, rep.stderr
    assert "critical-path attribution" in rep.stdout
    ev = json.loads(merged.read_text())["traceEvents"]
    assert {e["pid"] for e in ev if e.get("name") == "process_name"} \
        == {0, 1}
    assert any(e.get("ph") == "s" for e in ev)


def _engine(monkeypatch, timeline=None, trace=False):
    cfg = Config()
    cfg.trace = trace
    table = ProcessSetTable()
    table.initialize(1, lambda ranks: None)
    eng = port_engine.CollectiveEngine(types.SimpleNamespace(
        config=cfg, process_set_table=table, device=torch.device("cpu"),
        rank=0, timeline=timeline))
    made = []
    real = port_engine._Timing.__init__

    def counted(self, host):
        made.append(host)
        real(self, host)
    monkeypatch.setattr(port_engine._Timing, "__init__", counted)
    return eng, made


def _allreduce(eng, n=4, name="x"):
    hs = [eng.enqueue(f"{name}.{i}", port_engine.CollectiveType.ALLREDUCE,
                      torch.full((5,), float(i)), group_id=1)
          for i in range(n)]
    eng.run_loop_once()
    return [eng.synchronize(h) for h in hs]


@pytest.mark.parametrize("armed", ["none", "timeline", "tracer",
                                   "disabled_timeline"])
def test_torch_disarmed_engine_times_nothing(monkeypatch, tmp_path, armed):
    from horovod_tpu_torch.utils.timeline import Timeline
    tl = {"timeline": Timeline(str(tmp_path / "tl.json")),
          "disabled_timeline": Timeline("")}.get(armed)
    eng, made = _engine(monkeypatch, tl, trace=armed == "tracer")
    for i in range(3):
        out = _allreduce(eng, name=f"s{i}")
        assert [float(o[0]) for o in out] == [0.0, 1.0, 2.0, 3.0]
    on = armed in ("timeline", "tracer")
    assert (eng.tracer is not None) == (armed == "tracer")
    assert made == ([True] * 3 if on else [])
    assert eng.timed_batches == (3 if on else 0)
    assert (eng.reduce_pack_us_total > 0) == on
    assert eng.cycle_count == 3 and eng.pipeline_dispatches == 3
    if tl is not None:
        tl.close()


class _Event:
    """A stand-in CUDA event: ``elapsed_time`` in ms from its own clock."""

    def __init__(self, t_ms, done=True):
        self.t_ms, self.done = t_ms, done

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def _card_batch(eng, n, marks_ms, done):
    """A batch of ``n`` traced entries as the card leaves it after
    dispatch: spans claimed and stamped to the launch, stand-in events."""
    now = time.monotonic()
    batch = []
    for i in range(n):
        e = port_engine.TensorTableEntry(
            handle=i, name=f"g.{i}",
            ctype=port_engine.CollectiveType.ALLREDUCE,
            tensor=torch.zeros(2), enqueue_time=now - 0.010)
        e.span = eng.tracer.begin(e.name, e.enqueue_time, now - 0.008)
        e.span.t_ready = now - 0.006
        batch.append(e)
    timing = port_engine._Timing(host=False)
    timing.marks = [_Event(t, done) for t in marks_ms]
    timing.t_launch = now - 0.004
    for e in batch:
        e.span.t_launch = timing.t_launch
    return batch, ([e.tensor for e in batch], timing.marks[-1], timing)


@pytest.mark.parametrize("inflight", [True, False])
def test_torch_card_reduce_phase_from_events(monkeypatch, inflight):
    """Two dtype groups (marks 0 | 1 2 3 | 4 5 6 ms apart: pack 1+1,
    collective 1+1, unpack 1+1): reduce is 6 ms of the card's time."""
    eng, _ = _engine(monkeypatch, trace=True)
    marks = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    batch, results = _card_batch(eng, 3, marks, done=inflight)
    eng._settle_batch(batch, results, inflight=inflight)
    assert all(e.done.is_set() for e in batch)
    if not inflight:
        # Released before the card is done: nothing committed yet.
        assert eng.tracer.spans_committed == 0 and len(eng._unread) == 1
        eng._read_timings()                    # still running: no read
        assert len(eng._unread) == 1
        for ev in results[2].marks:
            ev.done = True
        eng._read_timings()
        assert not eng._unread
    assert eng.tracer.spans_committed == 3
    assert eng.timed_batches == 1
    assert eng.reduce_pack_us_total == pytest.approx(2000.0)
    assert eng.reduce_collective_us_total == pytest.approx(2000.0)
    assert eng.reduce_unpack_us_total == pytest.approx(2000.0)
    for e in batch:
        sp = e.span
        red = (sp.t_result - sp.t_launch) * 1e6
        if inflight:
            # Never past the settle that saw it: 4 ms had passed.
            assert 3900.0 < red <= 6000.0 + 1.0
        else:
            assert red == pytest.approx(6000.0, abs=1.0)
        assert sp.t_done >= sp.t_result
        assert sum(sp.phases_us().values()) == pytest.approx(
            sp.lifecycle_us(), rel=1e-9)


def test_torch_card_settle_with_error_commits_at_once(monkeypatch):
    eng, _ = _engine(monkeypatch, trace=True)
    batch, results = _card_batch(eng, 2, [0.0, 1.0, 2.0, 3.0], done=False)
    eng._settle_batch(batch, results, RuntimeError("peer died"),
                      inflight=True)
    assert eng.tracer.spans_committed == 2 and not eng._unread
    assert eng.timed_batches == 0
    assert all(isinstance(e.error, RuntimeError) for e in batch)
    assert eng.tracer.phase_summary()["spans"] == 2


def test_torch_cpu_reduce_phase_is_pack_to_unpack(monkeypatch):
    """On the CPU the span's reduce phase is the host's time from the
    first pack to the last unpack: the sum of the three parts."""
    eng, _ = _engine(monkeypatch, trace=True)
    _allreduce(eng, n=6)
    s = eng.tracer.phase_summary()
    parts = (eng.reduce_pack_us_total + eng.reduce_collective_us_total
             + eng.reduce_unpack_us_total)
    assert s["spans"] == 6
    assert s["phases_us"]["reduce"] == pytest.approx(parts, abs=0.02)
    assert s["phase_sum_us"] == pytest.approx(s["cycle_us"], abs=0.05)


def test_torch_engine_stops_with_spans_committed(monkeypatch, tmp_path):
    """``stop`` flushes the trace file with every span in it."""
    path = tmp_path / "tr.0"
    eng, _ = _engine(monkeypatch)
    eng.tracer = TraceRecorder(writer=TraceWriter(str(path), 0))
    _allreduce(eng, n=3)
    eng.stop()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert sum(1 for x in lines if x["k"] == "s") == 3
    assert sum(1 for x in lines if x["k"] == "c") == 1


def test_torch_init_arms_from_the_environment(monkeypatch, tmp_path):
    """``init()`` builds the engine's tracer from ``HOROVOD_TRACE`` and
    opens the timeline ``HOROVOD_TIMELINE`` names; ``shutdown`` closes
    both files."""
    monkeypatch.setenv("HOROVOD_TRACE", str(tmp_path / "tr.0"))
    monkeypatch.setenv("HOROVOD_TIMELINE", str(tmp_path / "tl.0"))
    hvd.init(device="cpu")
    try:
        st = basics._get_state()
        assert st.engine.tracer is not None and st.timeline.enabled
        hvd.allreduce(torch.ones(4), name="a")
    finally:
        hvd.shutdown()
    assert json.loads((tmp_path / "tl.0").read_text())
    kinds = [json.loads(x)["k"] for x in
             (tmp_path / "tr.0").read_text().splitlines()]
    assert kinds[0] == "h" and "s" in kinds and "c" in kinds
