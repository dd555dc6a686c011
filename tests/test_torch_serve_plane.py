"""The serving plane's framework-free modules, the port's against the JAX
package's: the counterparts of ``tests/test_serve.py`` and
``tests/test_serve_faults.py``.

The batcher, front door and circuit breaker (``serve/``), the monitor's
registry, agent, HTTP server and aggregator, and the serving mode of the
autoscaler's ``ScalePolicy`` are copies of jax-free modules of the JAX
package.  Each scenario of the JAX tests (the same scripted clocks,
requests, failures and load) runs here against both packages, as cases of
one test (``m`` is ``jax`` or ``port``), so that the two are held to the
same outcomes: admission, padded buckets, the in-flight window, deadlines,
backpressure and drain, the HTTP status mapping, readiness against health,
percentiles and their Prometheus export, the fleet's request rate and p99,
the serving policy's scale-out and idle scale-in, the breaker's state
machine, idempotent re-submission, quarantine, retries charged to the
deadline, hedging, and the retryable replica fault.  Last, the port's
``Config`` and its front door and batcher read the serving knobs alike,
with the JAX ``Config``'s defaults.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

_MODULES = {
    "autoscale": "elastic.autoscale", "agent": "monitor.agent",
    "http": "monitor.http", "aggregator": "monitor.aggregator",
    "registry": "monitor.registry", "batcher": "serve.batcher",
    "frontdoor": "serve.frontdoor", "resilience": "serve.resilience",
}
_NAMES = {
    "autoscale": ("HOLD", "SCALE_IN", "SCALE_OUT", "ScalePolicy"),
    "agent": ("MonitorAgent",), "http": ("MonitorHTTPServer",),
    "aggregator": ("EwmaTrend", "RankAggregator", "merged_percentile"),
    "registry": ("Histogram", "MetricRegistry"),
    "batcher": ("Batch", "ContinuousBatcher", "DeadlineExceeded",
                "Draining", "QueueFull", "parse_buckets",
                "LATENCY_MS_BUCKETS", "Cancelled", "ForwardFailed",
                "ReplicaFaulted", "RequestQuarantined"),
    "frontdoor": ("FrontDoor",),
    "resilience": ("CLOSED", "HALF_OPEN", "OPEN", "CircuitBreaker"),
}


@pytest.fixture(params=["horovod_tpu", "horovod_tpu_torch"],
                ids=["jax", "port"])
def m(request):
    """The names the JAX tests import, from one package's modules."""
    import importlib
    ns = types.SimpleNamespace(package=request.param)
    for key, mod in _MODULES.items():
        module = importlib.import_module(f"{request.param}.{mod}")
        for name in _NAMES[key]:
            setattr(ns, name, getattr(module, name))
    return ns


def _clocked(m, **kw):
    """Batcher on a scripted clock; returns (batcher, tick)."""
    clock = [0.0]
    b = m.ContinuousBatcher(clock=lambda: clock[0], **kw)

    def tick(dt):
        clock[0] += dt
    return b, tick


# ----------------------------------------------------------------- batcher
def test_torch_batcher_admission_and_positional_routing(m):
    b, _ = _clocked(m, max_batch=8)
    reqs = [b.submit([i]) for i in range(3)]
    batch = b.next_batch(timeout=0.0)
    assert batch.size == 3
    assert [r.id for r in batch.requests] == [r.id for r in reqs]
    b.complete(batch, [[i * 10] for i in range(3)])
    assert [r.wait(0.0) for r in reqs] == [[0], [10], [20]]


def test_torch_batcher_padded_bucket_shapes(m):
    """Batch sizes snap UP to the bucket menu — the replica compiles one
    program per bucket, never one per ragged size."""
    b, _ = _clocked(m, max_batch=8)
    assert b.buckets == (1, 2, 4, 8)
    for n, want in ((1, 1), (2, 2), (3, 4), (5, 8), (8, 8)):
        assert b.bucket_for(n) == want, n
    for _ in range(5):
        b.submit([0])
    batch = b.next_batch(timeout=0.0)
    assert (batch.size, batch.bucket) == (5, 8)
    assert b.stats()["padding_rows_total"] == 3


def test_torch_batcher_explicit_bucket_menu(m):
    b, _ = _clocked(m, max_batch=6, buckets=(2, 6))
    assert b.buckets == (2, 6)
    assert b.bucket_for(1) == 2 and b.bucket_for(3) == 6
    assert m.parse_buckets("1,3,9", 6) == (1, 3, 6)   # 9 > max dropped
    assert m.parse_buckets("", 8) == (1, 2, 4, 8)


def test_torch_batcher_inflight_window_blocks_dispatch(m):
    """HOROVOD_MAX_INFLIGHT semantics: at most ``max_inflight`` batches
    dispatched-but-unsettled; settling reopens the window."""
    b, _ = _clocked(m, max_batch=2, max_inflight=1)
    for i in range(4):
        b.submit([i])
    first = b.next_batch(timeout=0.0)
    assert first is not None
    assert b.next_batch(timeout=0.0) is None        # window full
    b.complete(first, [[0], [0]])
    second = b.next_batch(timeout=0.0)
    assert second is not None and second.size == 2
    b.complete(second, [[0], [0]])


def test_torch_batcher_deadline_expires_queued_requests(m):
    b, tick = _clocked(m, max_batch=4, deadline_ms=100.0)
    stale = b.submit([1])
    tick(0.2)                                       # past 100ms
    fresh = b.submit([2], deadline_ms=1000.0)
    batch = b.next_batch(timeout=0.0)
    assert [r.id for r in batch.requests] == [fresh.id]
    with pytest.raises(m.DeadlineExceeded):
        stale.wait(0.0)
    assert b.stats()["expired_total"] == 1
    b.complete(batch, [[2]])


def test_torch_batcher_backpressure_and_drain(m):
    b, _ = _clocked(m, max_batch=4, queue_depth=2)
    b.submit([1])
    b.submit([2])
    with pytest.raises(m.QueueFull):
        b.submit([3])
    assert b.stats()["rejected_total"] == 1
    b.drain()
    with pytest.raises(m.Draining):
        b.submit([4])
    # The drain contract: queued work still dispatches and settles.
    batch = b.next_batch(timeout=0.0)
    assert batch.size == 2
    b.complete(batch, [[1], [2]])
    assert b.next_batch(timeout=0.0) is None        # drained + empty
    assert b.pending() == 0


def test_torch_batcher_fail_routes_error_to_callers(m):
    b, _ = _clocked(m, max_batch=2)
    r = b.submit([1])
    batch = b.next_batch(timeout=0.0)
    b.fail(batch, RuntimeError("forward blew up"))
    with pytest.raises(RuntimeError, match="forward blew up"):
        r.wait(0.0)
    # The window slot was returned: new work still dispatches.
    b.submit([2])
    assert b.next_batch(timeout=0.0) is not None


# -------------------------------------------------------------- front door
def _door(m):
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=2000.0, queue_depth=4)
    fd = m.FrontDoor(b).start()
    return b, fd


def _worker(b, stop, fn=lambda v: [x * 2 for x in v]):
    def loop():
        while not stop.is_set():
            batch = b.next_batch(timeout=0.02)
            if batch is not None:
                b.complete(batch, [fn(r.inputs) for r in batch.requests])
    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


def _post(port, body, path="/v1/infer"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=10).read())


def test_torch_frontdoor_http_roundtrip_and_stats(m):
    b, fd = _door(m)
    stop = threading.Event()
    t = _worker(b, stop)
    try:
        out = _post(fd.port, {"inputs": [1, 2, 3]})
        assert out["outputs"] == [2, 4, 6]
        assert out["latency_ms"] >= 0
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{fd.port}/v1/stats", timeout=10).read())
        assert stats["requests_total"] == 1
        assert stats["batches_total"] == 1
    finally:
        stop.set()
        t.join(2)
        fd.stop()


def test_torch_frontdoor_maps_overload_to_429_and_drain_to_503(m):
    b, fd = _door(m)
    try:
        for i in range(4):                          # fill, no worker
            b.submit([i])
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(fd.port, {"inputs": [9]})
        assert exc.value.code == 429
        body = json.loads(exc.value.read())
        assert body["queue_depth"] == 4             # the autoscale signal
        assert exc.value.headers["Retry-After"]
        fd.drain()
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(fd.port, {"inputs": [9]})
        assert exc.value.code == 503
    finally:
        fd.stop()


def test_torch_frontdoor_maps_deadline_to_504_and_bad_input_to_400(m):
    b, fd = _door(m)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(fd.port, {"inputs": [1], "deadline_ms": 30})  # no worker
        assert exc.value.code == 504
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(fd.port, {"nope": 1})
        assert exc.value.code == 400
    finally:
        fd.stop()


# ------------------------------------------------------ readiness vs health
def test_torch_ready_endpoint_splits_from_health(m):
    agent = m.MonitorAgent(rank=0, world=1)
    srv = m.MonitorHTTPServer(agent, port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        ready = json.loads(urllib.request.urlopen(
            base + "/ready", timeout=10).read())
        assert ready["ready"] is True
        agent.set_ready(False, "draining: driver cordon ping received")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/ready", timeout=10)
        assert exc.value.code == 503
        body = json.loads(exc.value.read())
        assert "draining" in body["reason"]
        # /health stays truthful liveness: a draining replica is healthy.
        health = json.loads(urllib.request.urlopen(
            base + "/health", timeout=10).read())
        assert health["status"] == "ok"
        assert health["ready"] is False
        agent.set_ready(True)
        ready = json.loads(urllib.request.urlopen(
            base + "/ready", timeout=10).read())
        assert ready["ready"] is True
    finally:
        srv.stop()
        agent.close()


def test_torch_peer_failure_forces_not_ready(m):
    agent = m.MonitorAgent(rank=0, world=2)
    agent._peer_failure = {"reason": "rank 1 died", "dead_ranks": [1]}
    r = agent.readiness()
    assert r["ready"] is False and "rank 1" in r["reason"]
    agent.close()


# ------------------------------------------------------------- percentiles
def test_torch_histogram_percentile_interpolates_and_clamps(m):
    h = m.Histogram("lat", buckets=(10.0, 100.0, 1000.0))
    assert h.percentile(0.5) is None                # empty: no estimate
    for v in (5.0,) * 50 + (50.0,) * 40 + (500.0,) * 10:
        h.observe(v)
    assert h.percentile(0.5) == 10.0                # crossing at bucket edge
    assert 10.0 < h.percentile(0.9) <= 100.0
    assert 100.0 < h.percentile(0.99) <= 1000.0
    h.observe(1e9)                                  # +Inf overflow
    assert h.percentile(1.0) == 1000.0              # clamped to last bound
    with pytest.raises(ValueError):
        h.percentile(1.5)


def test_torch_prometheus_export_includes_p50_p99(m):
    reg = m.MetricRegistry()
    h = reg.histogram("hvd_serve_latency_ms", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 5.0):
        h.observe(v)
    text = reg.to_prometheus(extra_label='rank="0"')
    assert 'hvd_serve_latency_ms_p50{rank="0"}' in text
    assert 'hvd_serve_latency_ms_p99{rank="0"}' in text
    empty = m.MetricRegistry()
    empty.histogram("h", buckets=(1.0,))
    assert "_p50" not in empty.to_prometheus()      # no data, no estimate


def test_torch_merged_percentile_across_rank_histograms(m):
    a = m.Histogram("h", buckets=(10.0, 100.0))
    b = m.Histogram("h", buckets=(10.0, 100.0))
    for _ in range(90):
        a.observe(5.0)
    for _ in range(10):
        b.observe(50.0)
    p99 = m.merged_percentile(
        [a.snapshot_value(), b.snapshot_value()], 0.99)
    assert 10.0 < p99 <= 100.0                      # tail lives in rank b
    assert m.merged_percentile([], 0.99) is None


# --------------------------------------------------- serving fleet summary
def _serve_snap(total, hist):
    return {"rank": 0, "cycle_us_avg": 100.0,
            "metrics": {"hvd_serve_requests_total": total,
                        "hvd_serve_latency_ms": hist}}


def test_torch_aggregator_fleet_request_rate_and_latency(m):
    agg = m.RankAggregator(world=1)
    h = m.Histogram("hvd_serve_latency_ms", buckets=(10.0, 100.0))
    for _ in range(100):
        h.observe(50.0)
    snap = h.snapshot_value()
    t0 = time.monotonic()
    # Rate needs a baseline first, then deltas; trends fill at 3 samples.
    for i, total in enumerate((0, 100, 200, 300, 400)):
        agg.update(0, _serve_snap(float(total), snap))
        if i < 4:
            time.sleep(0.02)
    s = agg.summary()
    assert s["request_rate"] is not None and s["request_rate"] > 0
    assert s["latency_p99_ms"] is not None
    assert 10.0 < s["latency_p99_ms"] <= 100.0
    agg.flush()                                     # world resize: reset
    assert agg.summary().get("request_rate") is None


def test_torch_aggregator_without_serving_metrics_stays_null(m):
    agg = m.RankAggregator(world=1)
    for _ in range(6):
        agg.update(0, {"rank": 0, "cycle_us_avg": 100.0, "metrics": {}})
    s = agg.summary()
    assert s.get("request_rate") is None
    assert s.get("latency_p99_ms") is None


def test_torch_ewma_level_null_until_filled(m):
    t = m.EwmaTrend(min_samples=3)
    t.update(10.0)
    t.update(20.0)
    assert t.level is None
    t.update(30.0)
    assert t.level is not None and t.level > 10.0


# ---------------------------------------------------- serving-mode policy
def _pol(m, **kw):
    kw.setdefault("min_np", 1)
    kw.setdefault("max_np", 8)
    kw.setdefault("persistence", 2)
    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("idle_s", 30.0)
    return m.ScalePolicy(**kw)


def test_torch_policy_request_rate_triggers_scale_out(m):
    pol = _pol(m, rate_high=100.0)
    mk = lambda r: {"request_rate": r, "queue_depth": 0}   # noqa: E731
    assert pol.observe(mk(150.0), size=2, now=0.0).action == m.HOLD  # 75/rep
    assert pol.observe(mk(300.0), size=2, now=1.0).action == m.HOLD  # hit 1
    d = pol.observe(mk(300.0), size=2, now=2.0)                    # hit 2
    assert d.action == m.SCALE_OUT and d.target_size == 3
    assert "request_rate" in d.reason


def test_torch_policy_latency_target_triggers_scale_out(m):
    pol = _pol(m, latency_target_ms=50.0)
    mk = lambda p: {"request_rate": 10.0, "latency_p99_ms": p,  # noqa: E731
                    "queue_depth": 0}
    assert pol.observe(mk(20.0), size=2, now=0.0).action == m.HOLD
    assert pol.observe(mk(80.0), size=2, now=1.0).action == m.HOLD
    d = pol.observe(mk(80.0), size=2, now=2.0)
    assert d.action == m.SCALE_OUT
    assert "p99" in d.reason


def test_torch_policy_nulls_never_scale_serving(m):
    pol = _pol(m, rate_high=100.0, latency_target_ms=50.0)
    for i in range(5):
        d = pol.observe({"request_rate": None, "latency_p99_ms": None,
                         "queue_depth": 0}, size=2, now=float(i))
        assert d.action == m.HOLD


def test_torch_policy_serving_idle_scales_in_on_low_qps(m):
    """With ``idle_qps`` set, idleness is rate-below-floor — training
    progress is irrelevant to a serving fleet."""
    pol = _pol(m, idle_qps=5.0, idle_s=10.0)
    mk = lambda r: {"request_rate": r, "queue_depth": 0,   # noqa: E731
                    "progress_total": 42.0}                # never moves
    assert pol.observe(mk(50.0), size=2, now=0.0).action == m.HOLD
    assert pol.observe(mk(1.0), size=2, now=5.0).action == m.HOLD
    d = pol.observe(mk(1.0), size=2, now=16.0)             # 11s below floor
    assert d.action == m.SCALE_IN and d.target_size == 1
    # Busy fleet: the timer must never accrue, even with zero progress.
    pol2 = _pol(m, idle_qps=5.0, idle_s=10.0)
    for i in range(5):
        assert pol2.observe(mk(50.0), size=2,
                            now=float(i * 10)).action == m.HOLD


def test_torch_policy_training_idle_unaffected_without_idle_qps(m):
    """Serving knobs off: the progress-based idle test is untouched —
    a summary with request_rate present but idle_qps unset behaves
    exactly as before ISSUE 19."""
    pol = _pol(m, idle_s=10.0)
    mk = {"request_rate": 0.0, "queue_depth": 0, "progress_total": 1.0}
    # First sight of progress_total counts as progress (None -> 1.0), so
    # the idle timer starts at the SECOND unchanged observation.
    assert pol.observe(dict(mk), size=2, now=0.0).action == m.HOLD
    assert pol.observe(dict(mk), size=2, now=5.0).action == m.HOLD
    assert pol.observe(dict(mk), size=2, now=20.0).action == m.SCALE_IN


class _Clock:
    """Scripted monotonic clock."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------- breaker


def test_torch_breaker_trips_after_threshold_and_fast_fails(m):
    clk = _Clock()
    br = m.CircuitBreaker(threshold=3, reset_s=5.0, probes=2, clock=clk)
    assert br.state == m.CLOSED and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == m.CLOSED and br.allow()     # below threshold
    br.record_failure()                          # 3rd consecutive: trips
    assert br.state == m.OPEN and br.trips == 1
    # Fast-fail within ONE request of tripping: the very next allow()
    # refuses, and Retry-After knows the remaining window.
    assert not br.allow()
    assert br.retry_after_s() == pytest.approx(5.0)
    clk.tick(2.0)
    assert br.retry_after_s() == pytest.approx(3.0)
    assert not br.allow()


def test_torch_breaker_success_resets_the_streak(m):
    br = m.CircuitBreaker(threshold=3, clock=_Clock())
    br.record_failure()
    br.record_failure()
    br.record_success()                          # streak broken
    br.record_failure()
    br.record_failure()
    assert br.state == m.CLOSED                    # never 3 CONSECUTIVE


def test_torch_breaker_half_opens_then_closes_on_probe_successes(m):
    clk = _Clock()
    br = m.CircuitBreaker(threshold=1, reset_s=2.0, probes=2, clock=clk)
    br.record_failure()
    assert br.state == m.OPEN
    clk.tick(2.0)                                # window over: half-open
    assert br.state == m.HALF_OPEN
    # At most `probes` unresolved probes at a time.
    assert br.allow() and br.allow()
    assert not br.allow()
    br.record_success()
    assert br.state == m.HALF_OPEN                 # one good probe: not yet
    assert br.allow()                            # slot freed
    br.record_success()
    assert br.state == m.CLOSED and br.retry_after_s() == 0.0


def test_torch_breaker_half_open_failure_reopens_fresh_window(m):
    clk = _Clock()
    br = m.CircuitBreaker(threshold=1, reset_s=2.0, probes=1, clock=clk)
    br.record_failure()
    clk.tick(2.0)
    assert br.allow()                            # the probe
    br.record_failure()                          # probe failed: re-trip
    assert br.state == m.OPEN and br.trips == 2
    assert br.retry_after_s() == pytest.approx(2.0)


def test_torch_breaker_release_probe_frees_the_slot(m):
    """A probe that ends with NEITHER verdict (deadline, queue full,
    drain, quarantine) must give its slot back — otherwise `probes` such
    outcomes wedge the breaker half-open with allow() refusing forever."""
    clk = _Clock()
    br = m.CircuitBreaker(threshold=1, reset_s=2.0, probes=2, clock=clk)
    br.record_failure()
    clk.tick(2.0)
    assert br.allow() and br.allow()             # both probe slots out
    assert not br.allow()
    br.release_probe()                           # e.g. probe hit its 504
    assert br.state == m.HALF_OPEN
    assert br.allow()                            # slot usable again
    br.release_probe()
    br.release_probe()                           # extra releases: clamped
    assert br.allow() and br.allow()
    assert not br.allow()
    # While closed, release_probe is a no-op.
    br2 = m.CircuitBreaker(threshold=3, clock=_Clock())
    br2.release_probe()
    assert br2.state == m.CLOSED and br2.allow()


def test_torch_breaker_abandoned_probes_reclaimed_by_clock(m):
    """Backstop: even if a probe holder dies without releasing, slots
    idle past reset_s are reclaimed — there is a time-based escape from
    half-open, never a permanent wedge."""
    clk = _Clock()
    br = m.CircuitBreaker(threshold=1, reset_s=2.0, probes=1, clock=clk)
    br.record_failure()
    clk.tick(2.0)
    assert br.allow()                            # probe out, never resolved
    assert not br.allow()
    clk.tick(2.0)                                # slot idle for reset_s
    assert br.state == m.HALF_OPEN
    assert br.allow()                            # reclaimed, not wedged


# ------------------------------------------------------- batcher fault API


def test_torch_idempotent_resubmission_joins_resident_request(m):
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=60000.0)
    r1 = b.submit(1.0, request_id="req-a")
    r2 = b.submit(1.0, request_id="req-a")       # joins, never forks
    assert r1 is r2
    assert b.stats()["resubmitted_total"] == 1
    assert b.stats()["requests_total"] == 1      # admitted ONCE
    # Still idempotent while dispatched-but-unsettled.
    batch = b.next_batch(timeout=0.1)
    assert b.submit(1.0, request_id="req-a") is r1
    b.complete(batch, [2.0])
    # Settled: the id is free again — a NEW request under the old id.
    r3 = b.submit(1.0, request_id="req-a")
    assert r3 is not r1


def test_torch_quarantine_nth_consecutive_failure_is_terminal(m):
    b = m.ContinuousBatcher(max_batch=1, deadline_ms=60000.0,
                          quarantine_after=3)
    boom = RuntimeError("forward blew up")
    for expect in (m.ForwardFailed, m.ForwardFailed, m.RequestQuarantined):
        r = b.submit(1.0, request_id="poison")
        batch = b.next_batch(timeout=0.1)
        b.fail(batch, boom)
        assert isinstance(r.error, expect), r.error
        assert r.error.__cause__ is boom
        with pytest.raises(RuntimeError, match="forward blew up"):
            r.wait(0)
    assert b.stats()["quarantined_total"] == 1
    # Retryable wrappers read as Retryable; quarantine does NOT.
    assert not isinstance(m.RequestQuarantined("x"), m.ForwardFailed)


def test_torch_quarantine_success_resets_the_count(m):
    b = m.ContinuousBatcher(max_batch=1, deadline_ms=60000.0,
                          quarantine_after=2)
    for _ in range(2):
        b.submit(1.0, request_id="flaky")
        b.fail(b.next_batch(timeout=0.1), RuntimeError("transient"))
        b.submit(1.0, request_id="flaky")
        b.complete(b.next_batch(timeout=0.1), [2.0])   # success: reset
    assert b.stats()["quarantined_total"] == 0


def test_torch_quarantine_count_survives_unrelated_traffic_under_bound(m):
    """The _fail_counts size bound evicts least-recently-UPDATED entries:
    a poisoned request actively being retried keeps its streak even when
    unrelated failing traffic churns the table past the bound."""
    b = m.ContinuousBatcher(max_batch=1, deadline_ms=60000.0,
                          quarantine_after=3, queue_depth=1)  # bound = 4

    def _fail_once(rid):
        r = b.submit(1.0, request_id=rid)
        b.fail(b.next_batch(timeout=0.1), RuntimeError("boom"))
        return r

    _fail_once("poison")                         # count 1, oldest inserted
    _fail_once("u1")
    _fail_once("poison")                         # count 2, moved to end
    for rid in ("u2", "u3", "u4"):               # churn past the bound
        _fail_once(rid)
    r = _fail_once("poison")                     # 3rd consecutive: terminal
    assert isinstance(r.error, m.RequestQuarantined), r.error
    assert b.stats()["quarantined_total"] == 1


def test_torch_fail_retryable_preserves_queue_with_original_deadlines(m):
    clk = _Clock()
    b = m.ContinuousBatcher(max_batch=2, deadline_ms=1000.0, clock=clk)
    dispatched = [b.submit(1.0), b.submit(2.0)]
    queued = b.submit(3.0)
    original_deadline = queued.deadline
    batch = b.next_batch(timeout=0.0)
    assert [r.id for r in batch.requests] == [r.id for r in dispatched]
    b.fail_retryable(batch, RuntimeError("peer 1 died"))
    for r in dispatched:
        assert isinstance(r.error, m.ReplicaFaulted)
        with pytest.raises(m.ReplicaFaulted, match="peer 1 died"):
            r.wait(0)
    # The untouched queued request rides on, deadline UNCHANGED.
    assert not queued.done()
    assert queued.deadline == original_deadline
    s = b.stats()
    assert s["replica_faults_total"] == 1
    assert s["requeued_total"] == 1
    assert s["quarantined_total"] == 0           # world's fault, not theirs
    assert s["inflight"] == 0                    # window slot released


def test_torch_cancel_only_while_queued(m):
    b = m.ContinuousBatcher(max_batch=1, deadline_ms=60000.0, max_inflight=1)
    r1 = b.submit(1.0)
    r2 = b.submit(2.0)
    batch = b.next_batch(timeout=0.1)            # r1 in flight
    assert not b.cancel(r1)                      # dispatched: too late
    assert b.cancel(r2)                          # queued: cancelled
    assert isinstance(r2.error, m.Cancelled)
    assert b.stats()["cancelled_total"] == 1
    b.complete(batch, [2.0])
    assert not b.cancel(r1)                      # settled: no-op


def test_torch_drain_promptly_fails_dead_on_arrival_requests(m):
    clk = _Clock()
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=100.0, clock=clk)
    dead = b.submit(1.0)
    clk.tick(0.2)                                # 200ms: past its deadline
    live = b.submit(2.0)
    b.drain()
    # The expired request was failed AT drain time, not left to ride to
    # dispatch-time rejection; the live one still completes.
    assert dead.done() and isinstance(dead.error, m.DeadlineExceeded)
    assert not live.done()
    assert b.stats()["expired_total"] == 1
    b.complete(b.next_batch(timeout=0.0), [4.0])
    assert live.wait(0) == 4.0


# -------------------------------------------------- front door: retries


def _fault_door(m, batcher, **kw):
    kw.setdefault("retries", 2)
    kw.setdefault("hedge_ms", 0.0)
    kw.setdefault("breaker", m.CircuitBreaker(threshold=100))
    door = m.FrontDoor(batcher, port=0, **kw)
    return door


def _consume(batcher, script):
    """Background consumer: ``script(batch, n)`` decides each batch's
    fate (n is the 1-based dispatch count)."""
    stop = threading.Event()

    def run():
        n = 0
        while not stop.is_set():
            batch = batcher.next_batch(timeout=0.02)
            if batch is None:
                continue
            n += 1
            script(batch, n)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return stop


def test_torch_front_door_retries_replica_fault_to_success(m):
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=5000.0)
    door = _fault_door(m, b, retries=3)

    def script(batch, n):
        if n == 1:
            b.fail_retryable(batch, RuntimeError("peer died mid-batch"))
        else:
            b.complete(batch, [r.inputs * 2 for r in batch.requests])

    stop = _consume(b, script)
    try:
        out = door.infer_detailed(21.0)
        assert out["_code"] == 200, out
        assert out["outputs"] == 42.0
        assert out["attempts"] == 2
        s = door.stats()
        assert s["retries_total"] == 1
        assert s["replica_faults_total"] == 1
        assert s["availability"] == 1.0          # terminal outcome was OK
    finally:
        stop.set()
        door.stop()


def test_torch_front_door_retry_backoff_never_outlives_deadline(m):
    """The acceptance bound: with every attempt failing retryably, the
    terminal response lands within the request's own deadline plus one
    dispatch interval — backoff that would overshoot is abandoned."""
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=5000.0)
    door = _fault_door(m, b, retries=50)        # deadline binds, not count

    stop = _consume(b, lambda batch, n: b.fail_retryable(
        batch, RuntimeError("world is down")))
    try:
        deadline_s = 0.25
        t0 = time.monotonic()
        out = door.infer_detailed(1.0, deadline_ms=deadline_s * 1000)
        elapsed = time.monotonic() - t0
        assert out["_code"] in (503, 504), out
        assert out.get("retryable") or "deadline" in out["error"], out
        # One dispatch interval of slack (the consumer polls at 20ms) +
        # scheduling noise; far below what even one extra backoff at the
        # cap (1s) would add.
        assert elapsed < deadline_s + 0.5, elapsed
    finally:
        stop.set()
        door.stop()


def test_torch_front_door_quarantine_is_terminal_not_retried_forever(m):
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=5000.0,
                          quarantine_after=2)
    door = _fault_door(m, b, retries=10)
    stop = _consume(b, lambda batch, n: b.fail(
        batch, RuntimeError("poisoned input")))
    try:
        out = door.infer_detailed(1.0)
        assert out["_code"] == 500 and out.get("quarantined"), out
        assert out["request_id"]
        assert b.stats()["quarantined_total"] == 1
        # Exactly quarantine_after attempts were executed — the terminal
        # verdict stopped the retry budget (10) from being burned.
        assert b.stats()["requests_total"] == 2
    finally:
        stop.set()
        door.stop()


def test_torch_front_door_breaker_trips_and_fast_fails_then_heals(m):
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=2000.0)
    breaker = m.CircuitBreaker(threshold=2, reset_s=0.05, probes=1)
    door = _fault_door(m, b, retries=0, breaker=breaker)
    healed = threading.Event()

    def script(batch, n):
        if healed.is_set():
            b.complete(batch, [r.inputs for r in batch.requests])
        else:
            b.fail_retryable(batch, RuntimeError("replica faulted"))

    stop = _consume(b, script)
    try:
        for _ in range(2):                       # trip the breaker
            assert door.infer_detailed(1.0)["_code"] == 503
        # Fast-fail within one request of tripping: no admission, just a
        # 503 with Retry-After and the breaker named.
        before = b.stats()["requests_total"]
        out = door.infer_detailed(1.0)
        assert out["_code"] == 503 and out["breaker"] == "open", out
        assert out["_retry_after"] >= 1
        assert b.stats()["requests_total"] == before   # never admitted
        assert door.stats()["breaker_state"] == "open"
        assert door.stats()["breaker_trips"] == 1
        # Heal: the reset window elapses, the probe succeeds, it closes.
        healed.set()
        time.sleep(0.06)
        assert door.infer_detailed(5.0)["_code"] == 200
        assert door.stats()["breaker_state"] == "closed"
        assert door.stats()["availability"] < 1.0      # errors were counted
    finally:
        stop.set()
        door.stop()


def test_torch_front_door_probe_504_releases_slot_and_breaker_still_heals(m):
    """The common heal race: half-open probes time out to 504 while the
    replica is still re-rendezvousing.  Those probes carry no breaker
    verdict — their slots must be RELEASED, so once the replica is back
    the next requests are admitted as probes and close the breaker,
    instead of allow() refusing forever."""
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=2000.0)
    breaker = m.CircuitBreaker(threshold=1, reset_s=0.05, probes=2)
    door = _fault_door(m, b, retries=0, breaker=breaker)
    stop = _consume(b, lambda batch, n: b.fail_retryable(
        batch, RuntimeError("replica faulted")))
    try:
        assert door.infer_detailed(1.0)["_code"] == 503   # trips (thr=1)
        stop.set()                               # replica gone: no consumer
        time.sleep(0.06)                         # window over: half-open
        # Both probe slots burn out as 504s (nobody serves the queue).
        for _ in range(2):
            out = door.infer_detailed(1.0, deadline_ms=30.0)
            assert out["_code"] == 504, out
        assert door.stats()["breaker_state"] == "half_open"
        # Healed: probes must be admitted (slots were released) and
        # close the breaker — the wedge would 503 here forever.
        stop = _consume(b, lambda batch, n: b.complete(
            batch, [r.inputs for r in batch.requests]))
        for _ in range(2):
            assert door.infer_detailed(7.0)["_code"] == 200
        assert door.stats()["breaker_state"] == "closed"
    finally:
        stop.set()
        door.stop()


def test_torch_timed_out_request_is_cancelled_not_left_resident(m):
    """A 504'd request must not stay resident: a client retry under the
    same id with fresh deadline budget gets a FRESH request, not a join
    onto the doomed expired one."""
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=2000.0)
    door = _fault_door(m, b, retries=0)
    # Phase 1: nobody consumes — the request times out to 504 and is
    # cancelled out of the queue (not left resident).
    out = door.infer_detailed(1.0, deadline_ms=40.0, request_id="rid-x")
    assert out["_code"] == 504, out
    assert b.stats()["queue_depth"] == 0         # cancelled, not resident
    # Phase 2: replica serves again — the SAME id with fresh deadline
    # budget succeeds instead of joining the expired resident entry.
    stop = _consume(b, lambda batch, n: b.complete(
        batch, [r.inputs * 2 for r in batch.requests]))
    try:
        out = door.infer_detailed(4.0, deadline_ms=2000.0,
                                  request_id="rid-x")
        assert out["_code"] == 200 and out["outputs"] == 8.0, out
    finally:
        stop.set()
        door.stop()


def test_torch_hedge_timeout_cancels_both_twins(m):
    """On overall hedge timeout the PRIMARY is cancelled along with the
    hedge twin, releasing the resident entry for re-submission."""
    b = m.ContinuousBatcher(max_batch=1, deadline_ms=2000.0, max_inflight=4)
    door = _fault_door(m, b, retries=0, hedge_ms=15.0)
    out = door.infer_detailed(3.0, deadline_ms=80.0, request_id="rid-h")
    assert out["_code"] == 504, out
    s = b.stats()
    assert s["queue_depth"] == 0, s              # neither twin left queued
    assert s["cancelled_total"] == 2, s          # primary AND hedge
    door.stop()


def test_torch_front_door_drain_503_carries_retry_after_and_stats_flag(m):
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=1000.0)
    door = _fault_door(m, b)
    door.drain()
    out = door.infer_detailed(1.0)
    assert out["_code"] == 503 and out.get("draining"), out
    assert out["_retry_after"] >= 1              # drain is transient
    assert door.stats()["draining"] is True
    # Drain is NOT a service error: availability untouched.
    assert door.stats()["availability"] == 1.0
    door.stop()


# ---------------------------------------------------- front door: hedging


def test_torch_hedging_duplicates_slow_primary_and_first_response_wins(m):
    b = m.ContinuousBatcher(max_batch=1, deadline_ms=5000.0, max_inflight=4)
    door = _fault_door(m, b, hedge_ms=40.0)

    def script(batch, n):
        def work():
            if n == 1:
                time.sleep(0.3)                  # the straggler primary
            b.complete(batch, [r.inputs * 2 for r in batch.requests])

        threading.Thread(target=work, daemon=True).start()

    stop = _consume(b, script)
    try:
        out = door.infer_detailed(10.0)
        assert out["_code"] == 200 and out["outputs"] == 20.0
        s = door.stats()
        assert s["hedges_total"] == 1
        assert s["hedge_wins_total"] == 1        # the twin finished first
    finally:
        stop.set()
        door.stop()


def test_torch_hedge_delay_falls_back_to_knob_before_any_traffic(m):
    """Satellite: the p99 read is None on an empty histogram, so the
    delay must come from HOROVOD_SERVE_HEDGE_MS — not crash, not 0."""
    b = m.ContinuousBatcher(max_batch=4, deadline_ms=1000.0)
    door = _fault_door(m, b, hedge_ms=50.0)
    assert b.latency_percentile(0.99) is None
    assert door._hedge_delay_s(1.0) == pytest.approx(0.05)
    # Once traffic exists, the OBSERVED p99 drives the delay.
    for _ in range(20):
        b._m_latency.observe(8.0)
    p99 = b.latency_percentile(0.99)
    assert p99 is not None
    assert door._hedge_delay_s(1.0) == pytest.approx(p99 / 1000.0)
    # And no deadline room left means no hedge at all.
    assert door._hedge_delay_s(0.001) is None
    door.stop()


# ------------------------------------------- empty-percentile consistency


def test_torch_percentile_empty_is_none_in_local_and_merged_paths(m):
    """Satellite audit: every empty shape returns None through BOTH the
    local registry path and the cross-rank merged path."""
    h = m.Histogram("lat", buckets=m.LATENCY_MS_BUCKETS)
    assert h.percentile(0.5) is None
    assert h.percentile(0.99) is None
    snap = h.snapshot_value()
    assert m.merged_percentile([], 0.99) is None
    assert m.merged_percentile([None, {}], 0.99) is None
    assert m.merged_percentile([snap], 0.99) is None
    assert m.merged_percentile([snap, snap], 0.5) is None
    # Degenerate: observations but NO finite buckets — both paths still
    # agree on None (nothing to interpolate inside).
    h0 = m.Histogram("nobuckets", buckets=())
    h0.observe(5.0)
    assert h0.percentile(0.99) is None
    assert m.merged_percentile([h0.snapshot_value()], 0.99) is None
    # Non-empty stays non-None through both.
    h.observe(3.0)
    assert h.percentile(0.5) is not None
    assert m.merged_percentile([h.snapshot_value()], 0.5) is not None


# ------------------------------------------------------- the serving knobs
_KNOBS = {  # Config field: (variable, a value, the front door's or
            # batcher's attribute that reads it)
    "serve_retries": ("SERVE_RETRIES", "5", "retries"),
    "serve_hedge_ms": ("SERVE_HEDGE_MS", "12.5", "hedge_ms"),
    "serve_breaker_threshold": ("SERVE_BREAKER_THRESHOLD", "7",
                                "breaker.threshold"),
    "serve_breaker_reset_s": ("SERVE_BREAKER_RESET_S", "2.5",
                              "breaker.reset_s"),
    "serve_breaker_probes": ("SERVE_BREAKER_PROBES", "3", "breaker.probes"),
    "serve_quarantine_after": ("SERVE_QUARANTINE_AFTER", "4",
                               "quarantine_after"),
}


def test_torch_serve_config_defaults_match_jax():
    """Every serving field of the JAX ``Config`` is in the port's, with
    the same default, and both parse the same environment alike."""
    import dataclasses
    from horovod_tpu.common.config import Config as JConfig
    from horovod_tpu_torch.common.config import Config
    fields = [f.name for f in dataclasses.fields(JConfig)
              if f.name.startswith("serve")]
    assert len(fields) == 13
    for f in fields:
        assert getattr(Config(), f) == getattr(JConfig(), f), f
        assert getattr(Config.from_env(), f) == getattr(JConfig(), f), f


@pytest.mark.parametrize("prefix", ["HOROVOD_", "HVD_TPU_"])
@pytest.mark.parametrize("field", sorted(_KNOBS))
def test_torch_serve_knobs_read_alike(field, prefix, monkeypatch):
    """``Config.from_env`` and the front door or batcher that uses a knob
    read the same value from the same variable, under either prefix."""
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.serve import ContinuousBatcher, FrontDoor
    var, value, attr = _KNOBS[field]
    monkeypatch.setenv(prefix + var, value)
    want = type(getattr(Config(), field))(value)
    assert getattr(Config.from_env(), field) == want
    b = ContinuousBatcher(max_batch=2)
    obj = b if attr == "quarantine_after" else FrontDoor(b)
    for part in attr.split("."):
        obj = getattr(obj, part)
    assert obj == want
