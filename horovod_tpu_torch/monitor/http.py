# Copied from horovod_tpu/monitor/http.py:1-115 (MonitorHTTPServer); jax-free,
# the port keeps its own copy; the CLI's name is the port's; issue-number tags
# are dropped from the comments.
"""Opt-in HTTP export surface for the telemetry subsystem (no jax imports).

Runs on rank 0 when ``HOROVOD_MONITOR_PORT`` is set (``docs/monitoring.md``):

- ``GET /metrics`` — Prometheus text format: this rank's registry plus
  per-rank aggregated series (``hvd_rank_*{rank="r"}``) derived from the
  controller side-channel's aggregation table.
- ``GET /health``  — JSON: fleet status (``ok``/``stalled``/``degraded``),
  per-rank liveness, last-cycle age and stall state, slowest-rank /
  cycle-time-spread attribution.
- ``GET /ready``   — readiness split from liveness: 200 while
  this replica accepts new work, 503 (with a JSON reason) during
  cordon/drain — the load balancer's routing signal, distinct from
  ``/health``'s stall-driven 503.
- ``GET /snapshot`` — raw JSON dump of the aggregation table (the format
  ``python -m horovod_tpu_torch.monitor <file>`` pretty-prints).

Stdlib ``ThreadingHTTPServer`` on a daemon thread: scrapes never touch the
coordinator cycle thread — they read lock-guarded tables only.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils.logging import get_logger

log = get_logger()


class MonitorHTTPServer:
    """Serve ``/metrics`` + ``/health`` + ``/ready`` + ``/snapshot`` for a
    MonitorAgent."""

    def __init__(self, agent, port: int = 0, addr: str = ""):
        self._agent = agent
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence stdlib request logging
                pass

            def _send(self, code: int, ctype: str, body: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 - stdlib API
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        self._send(200, "text/plain; version=0.0.4",
                                   outer._agent.render_prometheus())
                    elif path == "/health":
                        health = outer._agent.health()
                        code = 200 if health.get("status") == "ok" else 503
                        self._send(code, "application/json",
                                   json.dumps(health, indent=2))
                    elif path == "/ready":
                        # Readiness vs liveness: the LB's
                        # routing signal.  NotReady during cordon/drain
                        # while /health keeps reporting the truthful
                        # liveness picture — a draining replica is
                        # healthy, just not accepting new work.
                        ready = outer._agent.readiness()
                        code = 200 if ready.get("ready") else 503
                        self._send(code, "application/json",
                                   json.dumps(ready, indent=2))
                    elif path == "/snapshot":
                        self._send(200, "application/json",
                                   json.dumps(outer._agent.dump(), indent=2))
                    else:
                        self._send(404, "text/plain",
                                   "try /metrics, /health, /ready or "
                                   "/snapshot\n")
                except BrokenPipeError:  # pragma: no cover - client gone
                    pass
                except Exception as exc:  # noqa: BLE001 - keep serving
                    try:
                        self._send(500, "text/plain", f"{exc}\n")
                    except Exception:  # pragma: no cover
                        pass

        self._httpd = ThreadingHTTPServer((addr, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MonitorHTTPServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-tpu-monitor-http",
            daemon=True)
        self._thread.start()
        log.info("monitor: HTTP exporter listening on :%d "
                 "(/metrics, /health, /snapshot)", self.port)
        return self

    def stop(self) -> None:
        try:
            # shutdown() BLOCKS until serve_forever exits — only safe when
            # start() actually ran; a never-started server just closes.
            if self._thread is not None:
                self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 - already down
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
