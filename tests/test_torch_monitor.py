"""The port's monitor: the copied agent, aggregator, HTTP exporter and CLI,
wired to the port's controller and engine.

- Two port ``TCPController``s in threads, each with a ``MonitorAgent``,
  ship snapshots through the copied coordinator's monitor side-channel
  (protocol v3): both tables hold both ranks and the skew names the slower
  one, as ``tests/test_monitor.py`` holds the JAX controllers to; the
  frame guard holds (no per-tensor metadata once warm, the negotiation
  bytes a round unchanged by the frames).
- The HTTP exporter answers ``/metrics``, ``/health`` and ``/snapshot`` on
  a free port.
- The CLI renders a dump as the JAX CLI does.
- The port's engine at world 1 publishes the JAX agent's metric names with
  the same values (the JAX package's agent, run over the port's engine,
  reads the same attributes), ``hvd_cycles_total`` and
  ``hvd_pipeline_dispatches_total`` counting; and a port the exporter
  cannot bind only warns.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.monitor import MonitorAgent as JaxAgent
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.controller import TCPController
from horovod_tpu_torch.common.net import free_ports
from horovod_tpu_torch.monitor import MonitorAgent


@pytest.fixture(autouse=True)
def _fresh_runtime():
    """Each test starts and ends with the port's runtime shut down (an
    earlier test file in the same process may have left it up)."""
    hvd.shutdown()
    yield
    hvd.shutdown()


class E:
    """Minimal negotiable port entry: this rank's own tensor."""

    def __init__(self, name, shape=(4,)):
        self.name = name
        self.tensor = torch.zeros(shape)
        self.group_id = -1


class FakeEngine:
    """The engine attributes the agent's collectors read."""

    def __init__(self, cycle_us_avg=100.0):
        self.cycle_count = 10
        self.cycle_us_total = cycle_us_avg * 10
        self.last_cycle_ts = time.time()
        self._cycle_index = 10
        self.negotiation_us_total = 0.0
        self.negotiation_cycles = 0
        self.pipeline_dispatches = 0
        self.monitor = None


def _pair(fn):
    port, = free_ports(1)
    results, errors = {}, {}
    peer_done = threading.Event()

    def worker(rank):
        ctl = TCPController("127.0.0.1", port, rank=rank, world=2,
                            stall_warn_s=60.0, cache_capacity=2048)
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
        assert not entries, f"never ready: {[e.name for e in entries]}"
        orders.append(tuple(got))
    return orders


def test_torch_monitor_frames_aggregate_across_ranks():
    names = [f"grad.{i}" for i in range(6)]

    def fn(ctl, rank):
        eng = FakeEngine(cycle_us_avg=100.0 if rank == 0 else 900.0)
        agent = MonitorAgent(engine=eng, controller=ctl, rank=rank,
                             world=2, interval_s=0.05)
        mk = lambda: [E(n) for n in names]           # noqa: E731
        _steps(ctl, mk, 2)
        deadline = time.monotonic() + 10
        while (len(agent.aggregator.ranks()) < 2
               and time.monotonic() < deadline):
            time.sleep(0.06)
            _steps(ctl, mk, 1)
        assert agent.aggregator.ranks() == [0, 1], agent.aggregator.table()
        skew = agent.aggregator.skew()
        assert skew["slowest_rank"] == 1, skew
        assert skew["cycle_us_spread"] == 800.0, skew
        assert ctl.peer_monitor_proto
        assert ctl.monitor_bytes_sent > 0
        assert agent.frames_received >= 2
        return True

    _pair(fn)


def test_torch_frame_guard_holds_with_monitoring_enabled():
    names = [f"grad.{i}.with.a.long.parameter.path" for i in range(12)]

    def fn(ctl, rank):
        MonitorAgent(engine=FakeEngine(), controller=ctl, rank=rank,
                     world=2, interval_s=0.05)
        mk = lambda: [E(n) for n in names]           # noqa: E731
        _steps(ctl, mk, 2)                           # warm-up: learn slots
        time.sleep(0.06)                             # arm the frame interval
        st = ctl.cache_stats
        full_before = st.full_announces
        bytes_before = ctl.bytes_sent
        mon_before = ctl.monitor_bytes_sent
        orders = _steps(ctl, mk, 5)
        assert st.full_announces == full_before
        assert st.bit_announces >= 5 * len(names)
        mon_bytes = ctl.monitor_bytes_sent - mon_before
        assert mon_bytes > 0, "no monitor frame rode the measured window"
        per_cycle = (ctl.bytes_sent - bytes_before - mon_bytes) / 5
        assert per_cycle <= 16, per_cycle
        return orders

    res = _pair(fn)
    assert res[0] == res[1]


def test_torch_http_exporter_metrics_health_snapshot():
    agent = MonitorAgent(engine=FakeEngine(), rank=0, world=1,
                         interval_s=0.1)
    port, = free_ports(1)
    srv = agent.serve_http(port)
    try:
        assert srv.port == port
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        assert 'hvd_cycles_total{rank="0"} 10' in text
        assert "hvd_rank_alive" in text
        health = json.loads(urllib.request.urlopen(base + "/health").read())
        assert health["status"] == "ok" and health["world"] == 1
        assert health["ranks"]["0"]["alive"] is True
        snap = json.loads(urllib.request.urlopen(base + "/snapshot").read())
        assert "0" in snap["table"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope")
        assert ei.value.code == 404
    finally:
        agent.close()


DUMP = {
    "rank": 0, "world": 2,
    "health": {"status": "stalled", "world": 2, "monitor_interval_s": 5.0,
               "slowest_rank": 1, "cycle_us_spread": 800.0,
               "ranks": {"0": {"alive": True, "last_seen_s": 0.2,
                               "cycle": 12, "last_cycle_age_s": 0.1,
                               "stalled": ["grad.0"]},
                         "1": {"alive": False, "last_seen_s": None,
                               "cycle": None, "last_cycle_age_s": None,
                               "stalled": []}}},
    "table": {"1": {"ledger": ["#7 grad.0 [...] at train.py:12"],
                    "metrics": {"hvd_stalled_collectives": 0},
                    "trace": {"spans": 4, "cycle_us": 50.0,
                              "phases": {"queue": [40, 4],
                                         "reduce": [120, 4]}}}},
}


def test_torch_monitor_cli_renders_a_dump(tmp_path, capsys):
    from horovod_tpu.monitor.__main__ import main as jmain
    from horovod_tpu_torch.monitor.__main__ import main
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(DUMP))
    assert jmain([str(path)]) == 0
    want = capsys.readouterr().out
    assert main([str(path)]) == 0
    out = capsys.readouterr().out
    assert out == want
    assert "fleet status: STALLED" in out and "train.py:12" in out
    assert main([str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == DUMP
    with pytest.raises(SystemExit):
        main([])
    assert main([str(tmp_path / "missing.json")]) == 1


def test_torch_engine_publishes_the_jax_agent_names(monkeypatch):
    """World 1 on the CPU with ``HOROVOD_MONITOR=1``: ``init()`` installs
    the agent on the engine before its first cycle; the cycle and
    dispatch counters count, and the JAX package's agent over the same
    engine publishes the same names and values."""
    monkeypatch.setenv("HOROVOD_MONITOR", "1")
    monkeypatch.setenv("HOROVOD_MONITOR_INTERVAL", "0.05")
    hvd.init(device="cpu")
    try:
        st = basics._get_state()
        eng, agent = st.engine, st.monitor
        assert isinstance(agent, MonitorAgent) and eng.monitor is agent
        for i in range(5):
            hvd.grouped_allreduce([torch.ones(8), torch.ones(3)],
                                  name=f"m{i}")
        snap = agent.registry.snapshot()
        assert snap["hvd_cycles_total"] >= 5
        assert snap["hvd_pipeline_dispatches_total"] == 5
        assert snap["hvd_cycle_time_us"]["count"] >= 5
        jagent = JaxAgent(engine=eng, rank=0, world=1)
        try:
            jsnap = jagent.registry.snapshot()
            ours = {k: v for k, v in snap.items()
                    if k != "hvd_cycle_time_us"
                    and not k.startswith("hvd_last_cycle_age")}
            assert ours == {k: jsnap[k] for k in ours}
            assert set(jsnap) - set(snap) <= {"hvd_cycle_time_us"}
        finally:
            jagent.close()
        health = agent.health()
        assert health["status"] == "ok", health
    finally:
        hvd.shutdown()
    assert basics._get_state().monitor is None


def test_torch_monitor_port_taken_only_warns(monkeypatch, caplog):
    """A port rank 0 cannot bind disables the exporter with a warning; the
    run goes on."""
    sock = socket.socket()
    sock.bind(("", 0))
    sock.listen(1)
    taken = sock.getsockname()[1]
    monkeypatch.setenv("HOROVOD_MONITOR", "1")
    monkeypatch.setenv("HOROVOD_MONITOR_PORT", str(taken))
    records = []
    from horovod_tpu_torch.utils.logging import get_logger
    import logging
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    get_logger().addHandler(handler)
    try:
        hvd.init(device="cpu")
        try:
            assert basics._get_state().monitor.http_port is None
            out = hvd.allreduce(torch.ones(2), name="after")
            assert torch.equal(out, torch.ones(2))
        finally:
            hvd.shutdown()
    finally:
        get_logger().removeHandler(handler)
        sock.close()
    assert any("could not bind HTTP port" in m for m in records), records
