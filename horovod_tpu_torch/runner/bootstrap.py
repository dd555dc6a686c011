# Copied from horovod_tpu/runner/bootstrap.py:1-325, with the probe's module
# path on the port's launcher.
"""Pre-launch host bootstrap: NIC discovery + mutual connectivity matrix.

Parity with the reference's driver/task bootstrap services
(``horovod/runner/driver/driver_service.py``,
``horovod/runner/common/service/task_service.py``, ``horovod/runner/task/``
— SURVEY.md §2b P8, §3.3): before spawning workers, the launcher starts a
TCP **driver service**, launches a small **probe task** on every host, and

1. each probe enumerates its NICs/addresses and registers back;
2. the driver picks each host's control-plane address — the
   ``--network-interface`` NIC's address when given (refusing fast if a
   host lacks it), else the address the probe's registration arrived from
   (the interface that actually routes to the launcher);
3. every probe is told every other probe's (address, port) and must
   TCP-connect to each; the driver assembles the mutual connectivity
   matrix and refuses the launch naming the exact broken host pair.

The probes themselves use only the standard library; their start-up is
the package's import.  Wire protocol: one JSON object per line.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.logging import get_logger

log = get_logger()

_CONNECT_TIMEOUT_S = 5.0


def list_nics() -> Dict[str, str]:
    """interface name → IPv4 address for every configured interface.

    Uses SIOCGIFADDR ioctls (pure stdlib — the reference shells out to
    psutil; this image has no psutil).  Interfaces without an IPv4 address
    are skipped.
    """
    import fcntl

    nics: Dict[str, str] = {}
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for _idx, name in socket.if_nameindex():
            try:
                packed = fcntl.ioctl(
                    s.fileno(), 0x8915,  # SIOCGIFADDR
                    struct.pack("256s", name[:15].encode()))
                nics[name] = socket.inet_ntoa(packed[20:24])
            except OSError:
                continue
    finally:
        s.close()
    return nics


def _read_json_line(fh) -> Optional[dict]:
    line = fh.readline()
    if not line:
        return None
    return json.loads(line)


def _send_json(sock: socket.socket, obj: dict):
    sock.sendall((json.dumps(obj) + "\n").encode())


# --------------------------------------------------------------- probe task
def probe_main(driver_addr: str, driver_port: int, label: str,
               nic: Optional[str] = None) -> int:
    """Runs on each host (``python -m horovod_tpu_torch.runner.task_probe``)."""
    nics = list_nics()
    chosen = None
    if nic:
        for want in nic.split(","):
            if want in nics:
                chosen = nics[want]
                break

    # Reachability listener: peers prove connectivity by connecting here.
    lsock = socket.socket()
    lsock.bind(("", 0))
    lsock.listen(16)
    lport = lsock.getsockname()[1]
    stop = threading.Event()

    def acceptor():
        lsock.settimeout(0.5)
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
                conn.close()
            except socket.timeout:
                continue
            except OSError:
                return

    t = threading.Thread(target=acceptor, daemon=True)
    t.start()

    try:
        s = socket.create_connection((driver_addr, driver_port),
                                     timeout=_CONNECT_TIMEOUT_S)
    except OSError as exc:
        print(f"probe {label}: cannot reach driver at "
              f"{driver_addr}:{driver_port}: {exc}", file=sys.stderr)
        return 1
    try:
        s.settimeout(60.0)
        _send_json(s, {"type": "register", "host": label, "nics": nics,
                       "addr": chosen, "listen_port": lport,
                       "slots": os.cpu_count() or 1,
                       "nic_requested": nic or "",
                       "nic_found": chosen is not None or not nic})
        fh = s.makefile()
        msg = _read_json_line(fh)
        if msg is None or msg.get("type") != "check":
            return 0 if msg is None else 1   # driver aborted early
        reachable = {}
        for peer in msg["peers"]:
            if peer["host"] == label:
                continue
            try:
                c = socket.create_connection(
                    (peer["addr"], peer["port"]), timeout=_CONNECT_TIMEOUT_S)
                c.close()
                reachable[peer["host"]] = True
            except OSError:
                reachable[peer["host"]] = False
        _send_json(s, {"type": "result", "host": label,
                       "reachable": reachable})
        _read_json_line(fh)   # wait for the driver's close/ack
        return 0
    finally:
        stop.set()
        lsock.close()
        s.close()


# ------------------------------------------------------------ driver service
class DriverService:
    """Launcher-side bootstrap service: collects probe registrations,
    assigns control-plane addresses, and validates the connectivity
    matrix."""

    def __init__(self, expected_hosts: List[str], nic: Optional[str] = None,
                 timeout_s: float = 60.0):
        self.expected = list(expected_hosts)
        self.nic = nic
        self.timeout_s = timeout_s
        self._sock = socket.socket()
        self._sock.bind(("", 0))
        self._sock.listen(len(self.expected) + 4)

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def close(self):
        self._sock.close()

    def run(self) -> Dict[str, str]:
        """Returns host → control-plane address; raises RuntimeError with
        the exact missing host / missing NIC / broken pair otherwise."""
        deadline = time.monotonic() + self.timeout_s
        # host -> (socket, file-reader, register msg, observed peer addr).
        # ONE makefile() per connection: a second reader would miss bytes
        # the first one buffered past the register line.
        registered: Dict[str, tuple] = {}
        try:
            while len(registered) < len(self.expected):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted(set(self.expected) - set(registered))
                    raise RuntimeError(
                        f"host bootstrap timed out: no probe registration "
                        f"from host(s) {missing} within {self.timeout_s}s — "
                        f"check ssh access and that the hosts can reach the "
                        f"launcher")
                self._sock.settimeout(remaining)
                try:
                    conn, peer = self._sock.accept()
                except socket.timeout:
                    continue
                # The probe's connectivity phase legitimately takes up to
                # one connect timeout per unreachable peer before it can
                # answer — scale the read timeout accordingly so a cluster
                # with many broken pairs still gets the exact broken-pair
                # diagnostic instead of a spurious "probe wedged".
                conn.settimeout(
                    30.0 + len(self.expected) * _CONNECT_TIMEOUT_S)
                fh = conn.makefile()
                try:
                    msg = _read_json_line(fh)
                except (OSError, ValueError):
                    conn.close()
                    continue          # garbled/stalled registration attempt
                if not msg or msg.get("type") != "register":
                    conn.close()
                    continue
                host = msg["host"]
                if host not in self.expected or host in registered:
                    conn.close()
                    continue
                registered[host] = (conn, fh, msg, peer[0])

            # Control-plane address per host.
            addrs: Dict[str, str] = {}
            for host, (conn, fh, msg, peer_addr) in registered.items():
                if self.nic:
                    if not msg.get("nic_found"):
                        raise RuntimeError(
                            f"host {host!r} has no interface named "
                            f"{self.nic!r} (available: "
                            f"{sorted(msg.get('nics', {}))}); fix "
                            f"--network-interface")
                    addrs[host] = msg["addr"]
                else:
                    # The address the registration actually arrived from:
                    # the interface that routes host → launcher.  Loopback
                    # means a local probe — keep it local.
                    addrs[host] = peer_addr

            # Mutual connectivity matrix.
            peers = [{"host": h, "addr": addrs[h],
                      "port": registered[h][2]["listen_port"]}
                     for h in self.expected]
            for host, (conn, _fh, _msg, _p) in registered.items():
                _send_json(conn, {"type": "check", "peers": peers})
            results: Dict[str, dict] = {}
            for host, (conn, fh, _msg, _p) in registered.items():
                try:
                    res = _read_json_line(fh)
                except (OSError, ValueError) as exc:
                    # Wedged probe / garbled line: keep the promised clean
                    # diagnostic naming the host (not a raw traceback).
                    raise RuntimeError(
                        f"host bootstrap: probe on {host!r} wedged or sent "
                        f"garbage during the connectivity check "
                        f"({exc})") from exc
                if not res or res.get("type") != "result":
                    raise RuntimeError(
                        f"host bootstrap: probe on {host!r} died during the "
                        f"connectivity check")
                results[host] = res["reachable"]
            for a in self.expected:
                for b in self.expected:
                    if a == b:
                        continue
                    if not results[a].get(b, False):
                        raise RuntimeError(
                            f"connectivity check failed: host {a!r} cannot "
                            f"reach host {b!r} at {addrs[b]}:"
                            f"{registered[b][2]['listen_port']} — fix the "
                            f"network (or --network-interface) before "
                            f"launching")
            for host, (conn, _fh, _msg, _p) in registered.items():
                try:
                    _send_json(conn, {"type": "done"})
                except OSError:
                    pass
            return addrs
        finally:
            for conn, _fh, _msg, _p in registered.values():
                conn.close()


def bootstrap_hosts(hosts, nic: Optional[str] = None,
                    ssh_port: Optional[int] = None,
                    identity_file: Optional[str] = None,
                    timeout_s: float = 60.0,
                    verbose: int = 0) -> Dict[str, str]:
    """Probe every host and return host → control-plane address.

    Raises RuntimeError naming the exact failure (unreachable host, missing
    NIC, or broken host pair).
    """
    from ..common.net import is_local_host, routable_addr
    from .run import ssh_command

    labels = [h.hostname for h in hosts]
    svc = DriverService(labels, nic=nic, timeout_s=timeout_s)
    procs: List[subprocess.Popen] = []
    try:
        any_remote = any(not is_local_host(h) for h in labels)
        driver_addr = routable_addr() if any_remote else "127.0.0.1"
        for label in labels:
            cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.task_probe",
                   "--driver-addr", driver_addr,
                   "--driver-port", str(svc.port),
                   "--label", label]
            if nic:
                cmd += ["--nic", nic]
            if is_local_host(label):
                procs.append(subprocess.Popen(cmd))
            else:
                remote_cmd = ["python3", "-m",
                              "horovod_tpu_torch.runner.task_probe",
                              "--driver-addr", driver_addr,
                              "--driver-port", str(svc.port),
                              "--label", label] + (
                                  ["--nic", nic] if nic else [])
                procs.append(subprocess.Popen(
                    ssh_command(label, {}, remote_cmd, ssh_port,
                                identity_file)))
        addrs = svc.run()
        if verbose:
            log.warning("bootstrap: control-plane addresses %s", addrs)
        return addrs
    finally:
        svc.close()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.terminate()
