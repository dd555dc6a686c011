"""The port's ``common/net.free_ports``: distinct, bindable ports drawn
from below the ephemeral range, where no outgoing connection or bind to
port 0 can take one between the probe and the service's bind."""
import random
import socket

import pytest

from horovod_tpu_torch.common import net


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_torch_free_ports_distinct_bindable_below_ephemeral(n):
    top = net._ephemeral_start()
    ports = net.free_ports(n)
    assert len(ports) == len(set(ports)) == n
    socks = []
    try:
        for p in ports:
            if top - net._PROBE_FLOOR >= 1024:
                assert net._PROBE_FLOOR <= p < top, (p, top)
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("", p))
            socks.append(s)
    finally:
        for s in socks:
            s.close()


def test_torch_free_ports_do_not_follow_the_random_seed():
    """Two processes that seed ``random`` alike (tests often do) must not
    draw the same ports."""
    random.seed(0)
    a = net.free_ports(4)
    random.seed(0)
    b = net.free_ports(4)
    assert a != b


def test_torch_free_ports_skip_a_held_port(monkeypatch):
    """A port some socket holds is never returned; with no room below the
    ephemeral range the kernel picks."""
    held = socket.socket()
    held.bind(("", 0))
    port = held.getsockname()[1]
    try:
        draws = iter([port, port])

        class Draw:
            def randrange(self, lo, hi):
                return next(draws, 0) or random.randrange(lo, hi)

        monkeypatch.setattr(net.random, "SystemRandom", Draw)
        monkeypatch.setattr(net, "_PROBE_FLOOR", 1024)
        monkeypatch.setattr(net, "_ephemeral_start", lambda: 65536)
        (got,) = net.free_ports(1)
        assert got != port
        monkeypatch.setattr(net, "_ephemeral_start", lambda: 1500)
        (got,) = net.free_ports(1)
        assert got != port and got > 0
    finally:
        held.close()
