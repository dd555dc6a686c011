# Copied from horovod_tpu/common/net.py:1-140 (jax-free; the port keeps its own copy;
# free_ports probes below the ephemeral port range; reserve_ports holds the ports it draws
# until their listeners have bound them, so launches side by side cannot draw one port).
"""Shared port-selection helpers for launchers/executors.

Two distinct problems, two helpers:

- ``reserve_ports(n)``: ports free on THIS machine (bind-probed below the
  ephemeral range), HELD until the caller releases them: a launcher
  holds its world's ports until the workers exit, so no other launch can
  draw them before the world's listeners bind them.  ``free_ports(n)``
  is a reservation released at once.  Only valid when the service will
  bind on this same machine.
- ``remote_ports(n, seed)``: ports for a service that binds on a DIFFERENT
  host, where bind-probing here proves nothing.  Picks from a high range,
  deterministically from ``seed`` so (a) every participant that knows the
  seed computes the same ports with no extra messages and (b) a retry with
  a new seed moves to fresh ports after a collision.
"""

from __future__ import annotations

import functools
import random
import socket
import time
from typing import Callable, List, Optional, Tuple, Type


def retry_with_backoff(fn: Callable, retries: int = 3,
                       base_ms: float = 200.0, max_ms: float = 5000.0,
                       jitter: float = 0.25,
                       exceptions: Tuple[Type[BaseException], ...] = (OSError,),
                       on_retry: Optional[Callable] = None):
    """Call ``fn()``; on a listed exception sleep ``base_ms * 2**attempt``
    (capped at ``max_ms``, ± ``jitter`` fraction of randomization so a
    fleet of workers retrying the same dead endpoint doesn't stampede in
    lock-step) and try again, up to ``retries`` retries.  The final
    failure re-raises the last exception.

    ``on_retry(attempt, exc, delay_s)`` — optional observer, called before
    each sleep (loggers; tests assert schedules through it).

    Shared by the controller's connect path (workers may start before the
    coordinator) and the elastic driver's worker-notification path (a
    transiently unreachable worker must still learn about host changes).
    """
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions as exc:
            if attempt >= max(0, int(retries)):
                raise
            delay_s = min(max_ms, base_ms * (2 ** attempt)) / 1000.0
            delay_s *= 1.0 + random.uniform(-jitter, jitter)
            delay_s = max(0.0, delay_s)
            if on_retry is not None:
                on_retry(attempt, exc, delay_s)
            time.sleep(delay_s)
            attempt += 1


# Where free_ports draws from: up to the start of the ephemeral range.
_PROBE_FLOOR = 10000
_EPHEMERAL_RANGE = "/proc/sys/net/ipv4/ip_local_port_range"


def _ephemeral_start() -> int:
    try:
        with open(_EPHEMERAL_RANGE) as fh:
            return int(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


class Reservation:
    """Ports held on this machine, each by two sockets that never listen
    (``_hold``): a TCP socket bound with ``SO_REUSEADDR``, beside which a
    listener that sets it too (the coordinator, the world's store, the
    HTTP servers, the host agent) binds the port, while a probe, which
    binds without it, cannot; and a lock, an abstract Unix socket named
    for the port, which another reservation cannot take.  So no draw on
    this machine takes a held port until ``release()``.  A context
    manager: the ``with`` block holds the ports."""

    def __init__(self, ports: List[int], socks: List[socket.socket]):
        self.ports = ports
        self._socks = socks

    def release(self) -> None:
        socks, self._socks = self._socks, []
        for s in socks:
            s.close()

    def __enter__(self) -> "Reservation":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# One reservation a port on this machine: the abstract Unix name a hold binds.
_LOCK = "\0horovod_tpu_torch.port.{}"


def _hold(port: int) -> Optional[Tuple[int, List[socket.socket]]]:
    """``(port, [lock, holder])`` for ``port`` (0: the kernel picks), or
    None where it is taken.  The probe binds without ``SO_REUSEADDR`` and
    so fails wherever any socket holds the port; the lock is taken while
    the probe still holds it, and the holder binds after the probe closes.
    The holder sets ``SO_REUSEADDR`` before its bind: some stacks (gVisor)
    ignore the option set on a socket already bound."""
    probe = socket.socket()
    try:
        probe.bind(("", port))
    except (OSError, OverflowError):
        probe.close()
        return None
    port = probe.getsockname()[1]
    lock = socket.socket(socket.AF_UNIX)
    try:
        lock.bind(_LOCK.format(port))
    except OSError:
        lock.close()
        probe.close()
        return None
    probe.close()
    holder = socket.socket()
    holder.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        holder.bind(("", port))
    except OSError:
        holder.close()
        lock.close()
        return None
    return port, [lock, holder]


def reserve_ports(n: int, consecutive: bool = False) -> Reservation:
    """``n`` distinct ports free on this machine, held until released
    (``consecutive``: one run ``p .. p + n - 1``).  They are drawn at
    random from below the ephemeral range: the kernel gives no port there
    to an outgoing connection or to a bind to port 0, so only another
    explicit bind could take one, and the hold refuses every bind but a
    listener's.  Where the range leaves no room, or the draws keep
    failing, the kernel picks (a bind to port 0)."""
    top = _ephemeral_start()
    draw = random.SystemRandom()
    step = n if consecutive else 1
    ports: List[int] = []
    socks: List[socket.socket] = []
    misses = 0
    try:
        while len(ports) < n:
            room = top - _PROBE_FLOOR >= 1024 and misses < 64 * n
            if not room and misses >= 128 * n:
                raise OSError(f"no run of {step} free ports on this machine")
            port = draw.randrange(_PROBE_FLOOR, top - step + 1) if room else 0
            run: List[int] = []
            held: List[socket.socket] = []
            while len(run) < step:
                got = _hold(port)
                if got is None:
                    break
                run.append(got[0])
                held += got[1]
                port = got[0] + 1
            if len(run) < step:
                for s in held:
                    s.close()
                misses += 1
                continue
            ports += run
            socks += held
    except BaseException:
        for s in socks:
            s.close()
        raise
    return Reservation(ports, socks)


def free_ports(n: int) -> List[int]:
    """``n`` distinct ports free on this machine, drawn as
    ``reserve_ports`` draws them and released on return: a service that
    binds one later has no hold to protect it, so a launch that starts
    other processes before their listeners bind takes a reservation
    instead.  Two probes at once never both take one port, and a port a
    reservation holds is never returned."""
    with reserve_ports(n) as held:
        return held.ports


def remote_ports(n: int, seed: int) -> List[int]:
    rng = random.Random(seed)
    base = rng.randrange(20000, 60000 - n)
    return [base + i for i in range(n)]


def routable_addr() -> str:
    """An address REMOTE hosts can reach this machine at (for rendezvous /
    controller endpoints): the primary outbound interface's address, or the
    FQDN when that cannot be determined.  The UDP connect sends no packets —
    it only makes the kernel pick a source address."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return socket.getfqdn()
    finally:
        s.close()


@functools.lru_cache(maxsize=1)
def _local_identity():
    """This machine's names + resolved addresses, computed once (DNS can
    block seconds per lookup; callers sit in polling loops)."""
    local_names = {socket.gethostname(), socket.getfqdn()}
    local_addrs = set()
    for n in local_names:
        try:
            local_addrs.update(socket.gethostbyname_ex(n)[2])
        except OSError:
            pass
    try:
        local_addrs.add(routable_addr())
    except OSError:
        pass
    return local_names, local_addrs


# Only SUCCESSFUL resolutions are cached: a transient DNS failure must be
# retried on the next call, not frozen as "remote" for the process lifetime
# (which would send the bootstrap ssh-ing to itself / picking blind remote
# ports for a local coordinator).
_is_local_cache: dict = {}


def is_local_host(hostname: str) -> bool:
    """True when ``hostname`` refers to this machine — by name, FQDN,
    alias, or any resolved address of either — so local coordinators named
    by FQDN/IP still get bind-probed ports instead of blind remote ones.
    Cached on success only: resolution can block on slow DNS and callers
    poll, but a failed lookup is transient and must not stick."""
    if hostname in ("localhost", "127.0.0.1", "::1"):
        return True
    cached = _is_local_cache.get(hostname)
    if cached is not None:
        return cached
    local_names, local_addrs = _local_identity()
    if hostname in local_names:
        _is_local_cache[hostname] = True
        return True
    try:
        target_addrs = set(socket.gethostbyname_ex(hostname)[2])
    except OSError:
        return False
    result = (any(a.startswith("127.") for a in target_addrs)
              or bool(target_addrs & local_addrs))
    _is_local_cache[hostname] = result
    return result
