"""The port's copy of the autotuner (``horovod_tpu_torch/ops/autotune.py``)
held to ``tests/test_autotune.py``: the same unit cases on the port's copy
(a fake engine, an injected clock and a loopback agreement transport),
the two modules' searches and agreement payloads step for step on the same
scores, then the port's real engine under ``HOROVOD_AUTOTUNE=1`` at size 1
and in a gloo world of two, where every agreed move must land on both
ranks at the same cycle with the same knob values and the parameters stay
bitwise across the ranks."""

import math
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from horovod_tpu.ops import autotune as jtune
from horovod_tpu_torch.ops.autotune import (LogCoordinateDescent,
                                            ParameterManager)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeEngine:
    def __init__(self, thr=64 * 1024 * 1024, cyc=0.001):
        self.fusion_threshold = thr
        self.cycle_time_s = cyc
        self.fast_lane_threshold = 0


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _surface(thr_bytes: float, cyc_s: float) -> float:
    """Synthetic throughput surface (bytes/s): unimodal with its optimum at
    (64MB, 1ms), far from a deliberately bad 1KB start — shaped like the
    real tradeoff (tiny fusion = per-op overhead dominates; huge cycle =
    latency dominates)."""
    lt = math.log2(max(thr_bytes, 1.0))
    lc = math.log2(max(cyc_s, 1e-6))
    return 1e9 * math.exp(-((lt - 26.0) / 6.0) ** 2) \
        * math.exp(-((lc - math.log2(1e-3)) / 4.0) ** 2)


# The grid the pre-round-3 autotuner explored: multipliers around the start.
_OLD_GRID_THR = (0.25, 1.0, 4.0)
_OLD_GRID_CYC = (0.2, 1.0, 5.0)


def test_torch_search_converges_from_bad_start_beats_old_grid():
    """From a 1KB fusion threshold the
    online search must reach within 20% of the surface optimum — beating
    every corner of the old 3×3 multiplier grid, which can never leave the
    bad regime."""
    start_thr, start_cyc = 1024.0, 0.001
    search = LogCoordinateDescent(
        start=(math.log2(start_thr), math.log2(start_cyc)),
        bounds=((10.0, 30.0), (math.log2(1e-4), math.log2(0.1))))
    evals = 0
    while not search.done and evals < 100:
        thr, cyc = (2.0 ** p for p in search.proposal())
        search.record(_surface(thr, cyc))
        evals += 1
    assert search.done
    thr, cyc = (2.0 ** p for p in search.point)
    achieved = _surface(thr, cyc)
    optimum = _surface(64 * 1024 * 1024, 1e-3)
    assert achieved >= 0.8 * optimum, (thr, cyc, achieved / optimum)

    best_grid = max(_surface(start_thr * tm, start_cyc * cm)
                    for tm in _OLD_GRID_THR for cm in _OLD_GRID_CYC)
    assert achieved > best_grid, (achieved, best_grid)
    # The search must have moved far from the bad start.
    assert thr > 1024 * 64


def test_torch_search_respects_bounds_and_terminates():
    search = LogCoordinateDescent(start=(10.0, -13.0),
                                  bounds=((10.0, 30.0),
                                          (math.log2(1e-4), math.log2(0.1))),
                                  max_evals=200)
    evals = 0
    while not search.done and evals < 300:
        p = search.proposal()
        assert 10.0 - 1e-9 <= p[0] <= 30.0 + 1e-9
        search.record(1.0)  # flat surface: must terminate by step decay
        evals += 1
    assert search.done
    assert evals < 60  # step decay, not max_evals, ended it


def _loopback_transport():
    """Broadcast transport double: payload comes straight back (what the
    engine broadcast does for the single-process world)."""
    sent = []

    def broadcaster(payload):
        sent.append(np.asarray(payload).copy())
        return ("h", sent[-1])

    def poller(handle):
        return handle[1]

    return broadcaster, poller, sent


def _drive_sample(pm, clock, nbytes, dt):
    """One full sample window then the agreement poll cycle."""
    for _ in range(pm._steps_per_sample):
        clock.t += dt
        pm.on_cycle(nbytes)
    # One more work cycle delivers the broadcast payload.
    clock.t += dt
    pm.on_cycle(nbytes)


def test_torch_parameter_manager_tunes_on_surface(tmp_path):
    """Full sampling loop against the synthetic surface: cycle latency is
    derived from the surface, so the manager should walk the engine's
    parameters out of the bad-start regime and finish."""
    eng = FakeEngine(thr=1024, cyc=0.001)
    clock = FakeClock()
    bc, poll, sent = _loopback_transport()
    log = tmp_path / "autotune.csv"
    pm = ParameterManager(eng, warmup_samples=1, steps_per_sample=2,
                          log_path=str(log), clock=clock,
                          broadcaster=bc, poller=poll, max_evals=48)
    nbytes = 1 << 20
    for _ in range(200):
        if not pm.tuning:
            break
        score = _surface(eng.fusion_threshold, eng.cycle_time_s)
        dt = nbytes / max(score, 1.0)
        _drive_sample(pm, clock, nbytes, dt)
    assert not pm.tuning
    final = _surface(eng.fusion_threshold, eng.cycle_time_s)
    optimum = _surface(64 * 1024 * 1024, 1e-3)
    assert final >= 0.8 * optimum, (
        eng.fusion_threshold, eng.cycle_time_s, final / optimum)
    # Every move was agreed through the broadcast transport.
    assert len(sent) == pm.search.evals
    text = log.read_text()
    assert text.startswith("sample,fusion_threshold_bytes")
    assert "# final:" in text


def test_torch_parameter_manager_ignores_idle_cycles():
    eng = FakeEngine()
    clock = FakeClock()
    pm = ParameterManager(eng, warmup_samples=0, steps_per_sample=2,
                          clock=clock)
    for _ in range(100):
        pm.on_cycle(0)  # idle cycles must not advance the schedule
    assert pm._cycles_in_sample == 0
    assert pm.search.evals == 0


def test_torch_parameter_manager_pipeline_coordinates(tmp_path):
    """With a controller present the search gains the response-cache,
    chunk-bytes, in-flight, fast-lane and round-pipeline coordinates
    (7-point search, 8-float agreement payload; spec_ready_after=0 is an
    explicit opt-out, exactly like cache capacity 0 — no dead knob in the
    search); every agreed move lands on the engine knobs and stays inside
    the coordinate bounds."""

    class FakeCtl:
        cache_enabled = True
        cache_capacity = 256
        spec_ready_after = 0               # speculation off: not searched
        round_pipeline = 1

    eng = FakeEngine(thr=1 << 20, cyc=0.001)
    eng.controller = FakeCtl()
    eng.pipeline_chunk_bytes = 0           # start derives from threshold
    eng.max_inflight = 2
    clock = FakeClock()
    bc, poll, sent = _loopback_transport()
    log = tmp_path / "autotune_pipeline.csv"
    pm = ParameterManager(eng, warmup_samples=0, steps_per_sample=1,
                          log_path=str(log), clock=clock,
                          broadcaster=bc, poller=poll, max_evals=10)
    assert pm._tune_cache and pm._tune_pipeline and pm._tune_fast_lane
    assert not pm._tune_spec and pm._tune_round_pipeline
    assert len(pm.search.point) == 7
    for _ in range(40):
        if not pm.tuning:
            break
        _drive_sample(pm, clock, 1 << 20, 0.01)
    assert sent and all(len(p) == 8 for p in sent), \
        [len(p) for p in sent]      # [thr,cyc,cap,chunk,infl,fl,rp,done]
    assert 1 <= eng.max_inflight <= 8
    assert (1 << 16) <= eng.pipeline_chunk_bytes <= (1 << 30)
    assert 1 <= eng.controller.cache_capacity <= 256
    assert (1 << 8) <= eng.fast_lane_threshold <= (1 << 24)
    assert 1 <= eng.controller.round_pipeline <= 4
    header = log.read_text().splitlines()[0]
    assert "pipeline_chunk_bytes" in header and "max_inflight" in header
    assert "fast_lane_threshold" in header
    assert "round_pipeline" in header and "spec_ready_after" not in header


def test_torch_parameter_manager_hier_threshold_coordinate(tmp_path):
    """With the two-level mode ARMED the search gains the
    hier_threshold coordinate (flat-vs-hierarchical crossover, learned
    per pod instead of hand-set); it lands on engine.hier_threshold_bytes
    inside bounds and rides the log header + final line.  Mode off →
    coordinate off (no dead knob in the search)."""

    class FakeCtl:
        cache_enabled = False
        cache_capacity = 0
        spec_ready_after = 0
        round_pipeline = 1

    eng = FakeEngine(thr=1 << 20, cyc=0.001)
    eng.controller = FakeCtl()
    eng.pipeline_chunk_bytes = 0
    eng.max_inflight = 2
    eng.hierarchical_allreduce = True
    eng.hier_threshold_bytes = 0           # start derives from the floor
    clock = FakeClock()
    bc, poll, sent = _loopback_transport()
    log = tmp_path / "autotune_hier.csv"
    pm = ParameterManager(eng, warmup_samples=0, steps_per_sample=1,
                          log_path=str(log), clock=clock,
                          broadcaster=bc, poller=poll, max_evals=8)
    assert pm._tune_hier
    # thr, cyc, chunk, inflight, fast_lane, hier, round_pipeline
    assert len(pm.search.point) == 7
    for _ in range(40):
        if not pm.tuning:
            break
        _drive_sample(pm, clock, 1 << 20, 0.01)
    assert sent and all(len(p) == 8 for p in sent), [len(p) for p in sent]
    assert (1 << 10) <= eng.hier_threshold_bytes <= (1 << 28)
    text = log.read_text()
    assert "hier_threshold_bytes" in text.splitlines()[0]
    assert "hier_threshold_bytes=" in text.splitlines()[-1]

    # Mode disarmed → the coordinate never enters the search.
    eng2 = FakeEngine()
    eng2.controller = FakeCtl()
    eng2.pipeline_chunk_bytes = 0
    eng2.max_inflight = 2
    pm2 = ParameterManager(eng2, warmup_samples=0, steps_per_sample=1,
                           clock=FakeClock(), broadcaster=bc, poller=poll,
                           max_evals=4)
    assert not pm2._tune_hier
    assert len(pm2.search.point) == 6


def test_torch_parameter_manager_checkpoint_lane_coordinates(tmp_path):
    """With the state plane armed the
    search gains the checkpoint-lane pair — shard-chunk bytes and the
    per-cycle lane budget.  Gated on the plane (no dead knobs without a
    durability stream), moves land on stateplane.chunk_bytes /
    engine.ckpt_lane_budget within bounds, and the log carries the
    columns.  Controller-less engine: the gradient-side pipeline
    coordinates stay off, so the payload is [thr, cyc, chunk, budget,
    done]."""

    class FakePlane:
        chunk_bytes = 1 << 20

    eng = FakeEngine(thr=1 << 20, cyc=0.001)
    eng.stateplane = FakePlane()
    eng.ckpt_lane_budget = 2
    clock = FakeClock()
    bc, poll, sent = _loopback_transport()
    log = tmp_path / "autotune_ckpt.csv"
    pm = ParameterManager(eng, warmup_samples=0, steps_per_sample=1,
                          log_path=str(log), clock=clock,
                          broadcaster=bc, poller=poll, max_evals=10)
    assert pm._tune_ckpt
    assert not pm._tune_pipeline and not pm._tune_cache
    assert len(pm.search.point) == 4
    for _ in range(40):
        if not pm.tuning:
            break
        _drive_sample(pm, clock, 1 << 20, 0.01)
    assert sent and all(len(p) == 5 for p in sent), [len(p) for p in sent]
    assert (1 << 16) <= eng.stateplane.chunk_bytes <= (1 << 26)
    assert 1 <= eng.ckpt_lane_budget <= 8
    header = log.read_text().splitlines()[0]
    assert "ckpt_chunk_bytes" in header and "ckpt_lane_budget" in header
    assert not pm.tuning or pm.search.evals <= 10


def test_torch_parameter_manager_no_ckpt_coordinates_without_plane():
    """No state plane armed: the checkpoint pair must NOT enter the
    search (a dead coordinate would burn a third of the eval budget)."""
    eng = FakeEngine()
    pm = ParameterManager(eng, warmup_samples=0, steps_per_sample=1,
                          clock=FakeClock())
    assert not pm._tune_ckpt
    assert len(pm.search.point) == 2


def test_torch_parameter_manager_zero_rtt_coordinates(tmp_path):
    """With speculation armed (spec_ready_after > 0) the search
    gains BOTH zero-RTT coordinates (8-point search, 9-float payload);
    moves land on the controller's spec_ready_after / round_pipeline and
    respect the bounds (spec never tuned down to 0 — 0 is the config-
    level opt-out, not a search point), and the log/final paths carry
    the columns."""

    class FakeCtl:
        cache_enabled = True
        cache_capacity = 256
        spec_ready_after = 2
        round_pipeline = 1

    eng = FakeEngine(thr=1 << 20, cyc=0.001)
    eng.controller = FakeCtl()
    eng.pipeline_chunk_bytes = 0
    eng.max_inflight = 2
    clock = FakeClock()
    bc, poll, sent = _loopback_transport()
    log = tmp_path / "autotune_zero_rtt.csv"
    pm = ParameterManager(eng, warmup_samples=0, steps_per_sample=1,
                          log_path=str(log), clock=clock,
                          broadcaster=bc, poller=poll, max_evals=12)
    assert pm._tune_spec and pm._tune_round_pipeline
    assert len(pm.search.point) == 8
    for _ in range(60):
        if not pm.tuning:
            break
        _drive_sample(pm, clock, 1 << 20, 0.01)
    assert sent and all(len(p) == 9 for p in sent), [len(p) for p in sent]
    assert 1 <= eng.controller.spec_ready_after <= 32
    assert 1 <= eng.controller.round_pipeline <= 4
    text = log.read_text()
    header = text.splitlines()[0]
    assert "spec_ready_after" in header and "round_pipeline" in header
    assert "# final:" in text.splitlines()[-1]
    assert "spec_ready_after=" in text.splitlines()[-1]
    assert "round_pipeline=" in text.splitlines()[-1]


def test_torch_parameter_manager_single_controller_skips_pipeline_coords():
    """No controller -> the legacy 2-coordinate search and 3-float
    payload: single-controller mode must not tune dead knobs."""
    eng = FakeEngine()
    clock = FakeClock()
    bc, poll, sent = _loopback_transport()
    pm = ParameterManager(eng, warmup_samples=0, steps_per_sample=1,
                          clock=clock, broadcaster=bc, poller=poll,
                          max_evals=4)
    assert not pm._tune_cache and not pm._tune_pipeline
    assert not pm._tune_fast_lane
    assert not pm._tune_spec and not pm._tune_round_pipeline
    assert len(pm.search.point) == 2
    _drive_sample(pm, clock, 1 << 20, 0.01)
    assert sent and all(len(p) == 3 for p in sent)




# ------------------------------------------------------------ parity with JAX
def _drive(mod, eng, scores, n=60):
    clock = FakeClock()
    sent = []

    def bc(payload):
        sent.append(np.asarray(payload).copy())
        return ("h", sent[-1])

    pm = mod.ParameterManager(eng, warmup_samples=1, steps_per_sample=2,
                              clock=clock, broadcaster=bc,
                              poller=lambda h: h[1], max_evals=12)
    for i in range(n):
        if not pm.tuning:
            break
        for _ in range(3):
            clock.t += 1.0 / scores[i % len(scores)]
            pm.on_cycle(1 << 20)
    return sent, pm.search.point, pm.search.evals


@pytest.mark.parametrize("ctl", [None, "pipeline", "zero_rtt"])
def test_torch_search_and_payloads_match_jax(ctl):
    """The same engine knobs and the same scores give the same agreement
    payloads, bit for bit, and the same final point in both modules."""

    class FakeCtl:
        cache_enabled = True
        cache_capacity = 256
        spec_ready_after = 2 if ctl == "zero_rtt" else 0
        round_pipeline = 1

    def engine():
        eng = FakeEngine(thr=1 << 20, cyc=0.002)
        if ctl is not None:
            eng.controller = FakeCtl()
            eng.pipeline_chunk_bytes = 0
            eng.max_inflight = 2
        return eng

    scores = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0, 3.5]
    want = _drive(jtune, engine(), scores)
    got = _drive(sys.modules[ParameterManager.__module__], engine(), scores)
    assert len(got[0]) == len(want[0]) > 0
    for a, b in zip(got[0], want[0]):
        assert a.tobytes() == b.tobytes()
    assert got[1:] == want[1:]


# ------------------------------------------------------------ the real engine
def test_torch_autotune_end_to_end(monkeypatch):
    """The port's engine under HOROVOD_AUTOTUNE=1 at size 1: the tuner is
    built at the first cycle, every move's agreement broadcast goes through
    the engine itself (settled where it is dispatched), tuning completes
    and the results stay exact throughout."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(basics, "_state", basics.GlobalState())
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "2")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_MAX_EVALS", "6")
    hvd.init(device="cpu")
    try:
        eng = basics._get_state().engine
        assert eng.autotuner is None            # built at the first cycle
        x = torch.ones(128)
        for i in range(120):
            out = hvd.allreduce(x, name=f"tune.{i}", op=hvd.Sum)
            assert torch.equal(out, x)
            if not eng.autotuner.tuning:
                break
        tuner = eng.autotuner
        assert not tuner.tuning, (tuner.search.evals, tuner._sample_no)
        assert not tuner._tune_pipeline and not eng._agreements
        assert 1024 * 0.999 <= eng.fusion_threshold <= (1 << 30) * 1.001
        assert 1e-4 * 0.999 <= eng.cycle_time_s <= 0.1 * 1.001
        assert torch.equal(hvd.allreduce(x, name="after", op=hvd.Sum), x)
    finally:
        hvd.shutdown()


_WORKER = textwrap.dedent("""
    import os, pickle, sys, time
    import torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import autotune
    hvd.init(device="cpu")
    r = hvd.rank()
    eng = hvd.common.basics._get_state().engine

    def knobs():
        ctl = eng.controller
        return (eng.fusion_threshold, eng.cycle_time_s, ctl.cache_capacity,
                eng.pipeline_chunk_bytes, eng.max_inflight,
                eng.fast_lane_threshold, ctl.round_pipeline)

    # Every applied move with the lock-step round it landed at (the same
    # round number on every rank) and the knobs after it.
    moves = []
    apply = autotune.ParameterManager._apply_params

    def recorded(self, params):
        apply(self, params)
        moves.append((eng.controller.rounds, knobs()))

    autotune.ParameterManager._apply_params = recorded
    # AUTOTUNE_LAG_S: rank 1's cycle tail runs late whenever a move is due
    # (its waiters are released before the move lands), and rank 0 reads
    # its tuner only after its own tail has run.
    lag = float(os.environ.get("AUTOTUNE_LAG_S", "0"))
    if lag and r == 1:
        on_cycle = autotune.ParameterManager.on_cycle

        def late(self, nbytes):
            if self._move_handle is not None:
                time.sleep(lag)
            on_cycle(self, nbytes)

        autotune.ParameterManager.on_cycle = late
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 4))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    g = torch.Generator().manual_seed(10 + r)
    steps = []
    for i in range(40):
        x, y = torch.randn(8, 16, generator=g), torch.randn(8, 4,
                                                            generator=g)
        opt.zero_grad()
        torch.nn.functional.mse_loss(model(x), y).backward()
        opt.step()
        steps.append([float(p.double().sum()) for p in model.parameters()])
        if lag and r == 0:
            time.sleep(2 * lag)
        # The loop ends at one step on every rank: the first after which
        # every rank has seen the last move land.  A move lands at the end
        # of the cycle that dispatched its agreement, which may run after
        # the step's waiters are released, so one rank's tuner can read
        # done a step before another's.
        t = eng.autotuner
        tuned = float(t is not None and not t.tuning)
        if hvd.allreduce(torch.tensor([tuned]), op=hvd.Min,
                         name=f"tuned.{i}").item():
            break
    # Read once the cycle thread has stopped: a move lands at the end of
    # a cycle, which may still run after the step's waiters are released.
    hvd.shutdown()
    t = eng.autotuner
    out = dict(steps=steps, moves=moves, samples=t._sample_no,
               evals=t.search.evals, final=knobs(),
               coords=len(t.search.point), tune=(t._tune_cache,
               t._tune_pipeline, t._tune_fast_lane, t._tune_round_pipeline),
               params=[p.detach().numpy().copy() for p in model.parameters()])
    with open(sys.argv[2] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("AUTOTUNE_OK", r)
""")


def _run_world2(tmp, lag_s=0.0):
    (tmp / "w.py").write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env.update(PYTHONPATH=REPO, HOROVOD_AUTOTUNE_WARMUP_SAMPLES="1",
               HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="2",
               HOROVOD_AUTOTUNE_MAX_EVALS="5", AUTOTUNE_LAG_S=str(lag_s))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--autotune", "--autotune-log-file", str(tmp / "tune.csv"),
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
    return outs, {0: (tmp / "tune.csv").read_text()}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _run_world2(tmp_path_factory.mktemp("autotune"))


def test_torch_autotune_agrees_across_two_ranks(world2):
    """Two ranks under ``--autotune``: the multi-process coordinates are
    searched (cache capacity, chunk, in-flight depth, fast lane, round
    pipeline), at least two samples are taken, after every step both
    ranks hold the same knob values, tuning ends on both in the same
    step, and the parameters stay bitwise equal across the ranks."""
    outs, _ = world2
    a, b = outs
    assert a["tune"] == b["tune"] == (True, True, True, True)
    assert a["coords"] == b["coords"] == 7
    assert a["samples"] == b["samples"] >= 2
    assert len(a["steps"]) == len(b["steps"])
    assert a["steps"] == b["steps"]
    # Every agreed move landed at the same round on both ranks, with the
    # same knob values after it.
    assert a["moves"] == b["moves"] and len(a["moves"]) == a["samples"]
    assert len({k for _, k in a["moves"]}) >= 2, a["moves"]
    assert a["final"] == b["final"] == a["moves"][-1][1]
    for pa, pb in zip(a["params"], b["params"]):
        assert pa.tobytes() == pb.tobytes()


def test_torch_autotune_loop_ends_together_when_one_rank_lags(tmp_path):
    """Rank 1's cycle tail runs 0.2 s late whenever a move is due, so
    that its waiters are released before each move lands there, while
    rank 0 reads its tuner only after its own tail: rank 0 sees tuning
    done a step before rank 1 does.  The loop still ends at one step on
    both ranks (a rank that left early would fail the other's last
    collective with its clean LEAVE), every move lands at the same round
    on both, and the parameters stay bitwise equal."""
    (a, b), _ = _run_world2(tmp_path, lag_s=0.2)
    assert len(a["steps"]) == len(b["steps"]) and a["steps"] == b["steps"]
    assert a["moves"] == b["moves"] and len(a["moves"]) == a["samples"]
    assert a["final"] == b["final"] == a["moves"][-1][1]
    for pa, pb in zip(a["params"], b["params"]):
        assert pa.tobytes() == pb.tobytes()


def test_torch_autotune_log_parses(world2):
    """Rank 0's log: the header names the searched coordinates, each
    sample row parses into as many numbers, the last line is the final
    pick."""
    _, logs = world2
    lines = logs[0].strip().splitlines()
    header = lines[0].split(",")
    # Both ranks append to the file the launcher names (as the JAX
    # launcher forwards it): skip the second rank's header.
    lines = lines[:1] + [ln for ln in lines[1:]
                         if not ln.startswith("sample,")]
    assert header[:3] == ["sample", "fusion_threshold_bytes",
                          "cycle_time_s"]
    assert "pipeline_chunk_bytes" in header and "fast_lane_threshold" in \
        header and header[-1] == "score_bytes_per_s"
    rows = [ln for ln in lines[1:] if not ln.startswith("#")]
    assert len(rows) >= 2
    for row in rows:
        vals = [float(v) for v in row.split(",")]
        assert len(vals) == len(header)
    assert any(ln.startswith("# final: fusion_threshold=") for ln in lines)
