"""A port drawn for a world stays held until its listener binds it
(``common/net.py`` ``reserve_ports``), so launches side by side cannot
take each other's port.

(a) While a reservation holds p, a draw forced to p, by ``free_ports`` or
by another reservation, moves to another port (also where only its lock
is held), and each listener the
port's worlds bind on a drawn port binds p beside the hold: the world's
TCPStore, the coordinator's server and the monitor's HTTP server.
(b) Two launches of ``python -m horovod_tpu_torch.runner -np 2`` started
together, each launcher's first draw forced to one port by a wrapper
that patches ``random.SystemRandom.randrange`` in that process only:
both worlds form, run one allreduce and exit 0.
(c) An elastic driver's generation holds its controller and new agent
ports until the next generation replaces it, and the driver's end
releases them.
"""

import ctypes
import datetime
import os
import random
import signal
import socket
import subprocess
import sys
import textwrap
import time

import pytest

from horovod_tpu_torch.common import net
from horovod_tpu_torch.elastic import discovery as pdisc
from horovod_tpu_torch.elastic import driver as pdriver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 150


def _taken(port):
    """True where a bind without ``SO_REUSEADDR`` (a probe's) fails."""
    s = socket.socket()
    try:
        s.bind(("", port))
        return False
    except OSError:
        return True
    finally:
        s.close()


def _force_first_draw(monkeypatch, port):
    real = random.SystemRandom

    class Draw:
        forced = [port]

        def randrange(self, lo, hi):
            return self.forced.pop() if self.forced else \
                real().randrange(lo, hi)

    monkeypatch.setattr(net.random, "SystemRandom", Draw)


# ------------------------------------------------------------------- (a)
@pytest.mark.parametrize("draw", ["free_ports", "reserve_ports"])
def test_torch_a_held_port_is_never_drawn_again(monkeypatch, draw):
    with net.reserve_ports(1) as held:
        (p,) = held.ports
        assert _taken(p)
        _force_first_draw(monkeypatch, p)
        if draw == "free_ports":
            (got,) = net.free_ports(1)
        else:
            with net.reserve_ports(1) as other:
                (got,) = other.ports
        assert got != p
    assert not _taken(p)


def test_torch_a_draw_skips_a_port_locked_by_another_reservation(
        monkeypatch):
    """The lock alone (another reservation between its probe and its
    holder's bind) turns a draw away."""
    with net.reserve_ports(1) as held:
        (p,) = held.ports
    lock = socket.socket(socket.AF_UNIX)
    lock.bind(net._LOCK.format(p))
    try:
        assert not _taken(p)
        _force_first_draw(monkeypatch, p)
        (got,) = net.free_ports(1)
        assert got != p
    finally:
        lock.close()


def _tcpstore(port):
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", port, 1, True,
                          timeout=datetime.timedelta(seconds=10))
    client = dist.TCPStore("127.0.0.1", port, 1, False,
                           timeout=datetime.timedelta(seconds=10))
    client.set("k", "v")
    assert store.get("k") == b"v"

    def stop():
        nonlocal store, client
        store = client = None
    return stop


def _coordinator(port):
    from horovod_tpu_torch.common import native
    lib = native.load()
    srv = lib.hvdtpu_server_start(port, 1, ctypes.c_double(60.0), 0, 5000,
                                  0, 0)
    assert srv, f"the coordinator's server did not bind {port}"
    with socket.create_connection(("127.0.0.1", port), timeout=5):
        pass
    return lambda: lib.hvdtpu_server_stop(srv)


def _monitor(port):
    import urllib.request

    from horovod_tpu_torch.monitor.http import MonitorHTTPServer

    class Agent:
        def render_prometheus(self):
            return "hvd_held 1\n"

    srv = MonitorHTTPServer(Agent(), port=port, addr="127.0.0.1").start()
    assert srv.port == port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=5) as r:
        assert b"hvd_held 1" in r.read()
    return srv.stop


@pytest.mark.parametrize("listen", [_tcpstore, _coordinator, _monitor],
                         ids=["tcpstore", "coordinator", "monitor"])
def test_torch_a_listener_binds_its_held_port(monkeypatch, listen):
    with net.reserve_ports(1) as held:
        (p,) = held.ports
        stop = listen(p)
        try:
            # Listening beside the hold: still no draw takes p.
            _force_first_draw(monkeypatch, p)
            (got,) = net.free_ports(1)
            assert got != p and _taken(p)
        finally:
            stop()


def test_torch_a_consecutive_reservation_skips_a_held_run(monkeypatch):
    with net.reserve_ports(1) as first:
        (p,) = first.ports
        # A run forced to start one below p cannot hold p.
        _force_first_draw(monkeypatch, p - 1)
        with net.reserve_ports(3, consecutive=True) as run:
            q = run.ports[0]
            assert run.ports == [q, q + 1, q + 2]
            assert p not in run.ports
            assert all(_taken(x) for x in run.ports)
    assert not any(_taken(x) for x in run.ports + [p])


# ------------------------------------------------------------------- (b)
_WRAPPER = textwrap.dedent("""
    import random, runpy, sys
    forced = [int(sys.argv[1])]
    real = random.SystemRandom.randrange

    def randrange(self, *a, **kw):
        return forced.pop() if forced else real(self, *a, **kw)

    random.SystemRandom.randrange = randrange
    sys.argv = ["horovod_tpu_torch.runner"] + sys.argv[2:]
    runpy.run_module("horovod_tpu_torch.runner", run_name="__main__")
""")

_WORKER = textwrap.dedent("""
    import os, sys, torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    out = hvd.allreduce(torch.full((4,), float(hvd.rank() + 1)), op=hvd.Sum)
    assert out.tolist() == [3.0] * 4, out
    with open(os.path.join(sys.argv[1], f"rank{hvd.rank()}"), "w") as fh:
        fh.write(os.environ["HOROVOD_CONTROLLER_PORT"])
    hvd.shutdown()
""")


def test_torch_b_two_launches_on_one_drawn_port(tmp_path):
    (tmp_path / "wrap.py").write_text(_WRAPPER)
    (tmp_path / "worker.py").write_text(_WORKER)
    (p,) = net.free_ports(1)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO] + [x for x in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if x]))
    outs = [tmp_path / f"launch{i}" for i in range(2)]
    procs = []
    for out in outs:
        out.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp_path / "wrap.py"), str(p), "-np", "2",
             sys.executable, str(tmp_path / "worker.py"), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True))
    logs, deadline = [], time.time() + LAUNCH_TIMEOUT_S
    for proc in procs:
        try:
            logs.append(proc.communicate(
                timeout=max(1.0, deadline - time.time()))[0])
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            logs.append(proc.communicate()[0] + "\n[killed at the timeout]")
    ports = set()
    for proc, log, out in zip(procs, logs, outs):
        assert proc.returncode == 0, log[-4000:]
        seen = {(out / f"rank{r}").read_text() for r in range(2)}
        assert len(seen) == 1, seen
        ports |= seen
    # One launch drew p; the other's forced draw moved on.
    assert len(ports) == 2 and str(p) in ports, ports


# ------------------------------------------------------------------- (c)
class _Quiet(pdriver.ElasticDriver):
    """The driver's generations without workers."""

    def _spawn(self, identity, assignment):
        pass


def _ports(d):
    a = d._assigned
    ctl = {v[k] for v in a.values()
           for k in ("controller_port", "controller_port2")}
    return sorted(ctl | {v["agent_port"] for v in a.values()
                         if "agent_port" in v})


def test_torch_c_elastic_generation_holds_its_ports_until_replaced():
    d = _Quiet(pdisc.FixedHostDiscovery([]), ["true"], min_np=1,
               env={"HOROVOD_HIERARCHICAL_CONTROLLER": "1"})
    try:
        assert d._new_generation([pdisc.DiscoveredHost("127.0.0.1", 1)])
        first = _ports(d)
        assert len(first) == 3 and all(_taken(x) for x in first), first
        # The same layout again keeps the live generation and its hold.
        assert d._new_generation([pdisc.DiscoveredHost("127.0.0.1", 1)])
        assert _ports(d) == first and all(_taken(x) for x in first)
        assert d._new_generation([pdisc.DiscoveredHost("127.0.0.1", 1),
                                  pdisc.DiscoveredHost("127.0.0.2", 1)])
        second = _ports(d)
        # The controller ports move, the first host's agent port stays;
        # the old controller ports are released, the new ones held.
        agent0 = d._agent_ports["127.0.0.1"]
        gone = sorted(set(first) - {agent0})
        assert len(second) == 4 and not set(gone) & set(second)
        assert all(_taken(x) for x in set(second) - {agent0}), second
        assert not any(_taken(x) for x in gone), gone
    finally:
        d._shutdown_workers()
    assert not any(_taken(x) for x in second), second
