# Copied from horovod_tpu/common/net.py:1-140 (jax-free; the port keeps its own copy).
"""Shared port-selection helpers for launchers/executors.

Two distinct problems, two helpers:

- ``free_ports(n)``: ports free on THIS machine (bind-probed, SO_REUSEADDR,
  all probes held open so one call can't return duplicates).  Only valid
  when the service will bind on this same machine.
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


def free_ports(n: int) -> List[int]:
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


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
