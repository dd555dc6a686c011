# Copied from horovod_tpu/elastic/rendezvous.py:1-191 (jax-free; the port keeps its own copy).
"""Versioned rendezvous KV service for elastic training.

Parity: the reference's launcher-hosted HTTP KV store
(``horovod/runner/http/http_server.py``) + the elastic rendezvous layer
(``horovod/runner/elastic/rendezvous.py``) — SURVEY.md §2b P9/P10, §3.4.
The driver publishes a monotonically-versioned assignment table
(identity ``host:local_rank`` → rank/size/controller address); workers
long-poll for the first version ≥ their requested minimum, which is how a
worker re-entering after a reset is guaranteed to land in the NEW
generation rather than re-joining the stale one.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse


class RendezvousServer:
    """Driver-side server: assignment table + worker notification registry."""

    def __init__(self, addr: str = "0.0.0.0"):
        self._lock = threading.Lock()
        self._version = 0
        self._assignments: Dict[str, dict] = {}
        self._notify_ports: Dict[str, int] = {}
        # State-plane metadata (ISSUE 14): identity -> declared state
        # record ({"epoch", "port", "digest", ...}) — how a re-joining
        # rank discovers which survivors hold a newer committed epoch and
        # where their shard servers listen, BEFORE deciding peer-vs-disk
        # restore.  Plain last-writer-wins KV; records survive generations
        # (a survivor's epoch is exactly what outlives the world change).
        self._state_records: Dict[str, dict] = {}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                url = urlparse(self.path)
                parts = [p for p in url.path.split("/") if p]
                with outer._lock:
                    if parts[:1] == ["version"]:
                        return self._json({"version": outer._version})
                    if parts[:1] == ["state"]:
                        return self._json(
                            {"state": dict(outer._state_records)})
                    if len(parts) == 2 and parts[0] == "assign":
                        identity = parts[1]
                        q = parse_qs(url.query)
                        min_v = int(q.get("min_version", ["0"])[0])
                        if (outer._version >= min_v
                                and identity in outer._assignments):
                            a = dict(outer._assignments[identity])
                            a["version"] = outer._version
                            return self._json(a)
                        return self._json({"pending": True}, code=404)
                return self._json({"error": "not found"}, code=404)

            def do_PUT(self):
                parts = [p for p in self.path.split("/") if p]
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode() if n else ""
                if len(parts) == 2 and parts[0] == "notify":
                    with outer._lock:
                        outer._notify_ports[parts[1]] = int(body)
                    return self._json({"ok": True})
                if len(parts) == 2 and parts[0] == "state":
                    try:
                        rec = json.loads(body)
                    except ValueError:
                        return self._json({"error": "bad json"}, code=400)
                    with outer._lock:
                        outer._state_records[parts[1]] = rec
                    return self._json({"ok": True})
                return self._json({"error": "not found"}, code=404)

            def _json(self, obj, code=200):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((addr, 0), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def publish(self, assignments: Dict[str, dict]) -> int:
        """Atomically install a new generation; returns its version."""
        with self._lock:
            self._version += 1
            self._assignments = dict(assignments)
            return self._version

    def notification_ports(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._notify_ports)

    def state_records(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._state_records)

    def drop_state(self, identity: str) -> None:
        """Prune a departed rank's state record (the driver calls this
        when it classifies an exit): a joiner must not waste a connect
        timeout probing a corpse's shard server."""
        with self._lock:
            self._state_records.pop(identity, None)

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


# ------------------------------------------------------------- worker client
def fetch_assignment(addr: str, port: int, identity: str,
                     min_version: int = 0,
                     timeout_s: float = 600.0) -> dict:
    """Long-poll the driver for this identity's assignment at version
    ≥ ``min_version`` (blocks while the driver re-forms the world)."""
    import http.client
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            conn = http.client.HTTPConnection(addr, port, timeout=10)
            conn.request("GET", f"/assign/{identity}?min_version={min_version}")
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            if resp.status == 200:
                return json.loads(data)
        except OSError:
            pass
        time.sleep(0.2)
    raise TimeoutError(
        f"rendezvous: no assignment for {identity} (min_version="
        f"{min_version}) within {timeout_s}s")


def register_notification_port(addr: str, port: int, identity: str,
                               notify_port: int):
    import http.client
    conn = http.client.HTTPConnection(addr, port, timeout=10)
    conn.request("PUT", f"/notify/{identity}", body=str(notify_port))
    conn.getresponse().read()
    conn.close()


def declare_state(addr: str, port: int, identity: str, record: dict,
                  timeout: float = 3.0):
    """Publish this rank's state-plane record (epoch + shard-server port
    + blob identity) to the driver's rendezvous KV — called after every
    commit (off the training thread; short timeout: advisory metadata),
    so survivors' declared epochs are current when a re-joining rank
    reads the directory."""
    import http.client
    conn = http.client.HTTPConnection(addr, port, timeout=timeout)
    conn.request("PUT", f"/state/{identity}", body=json.dumps(record))
    conn.getresponse().read()
    conn.close()


def state_directory(addr: str, port: int) -> Dict[str, dict]:
    """All declared state records (identity -> record)."""
    import http.client
    conn = http.client.HTTPConnection(addr, port, timeout=10)
    conn.request("GET", "/state")
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    if resp.status != 200:
        raise OSError(f"rendezvous /state returned {resp.status}")
    return json.loads(data).get("state", {})
