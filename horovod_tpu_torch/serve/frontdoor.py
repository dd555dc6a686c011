# Copied from horovod_tpu/serve/frontdoor.py:1-485 (jax-free; the port keeps its own copy).
"""HTTP/in-process ingest for the serving plane (no jax imports).

The front half of the serving plane (``docs/serving.md``): a stdlib
``ThreadingHTTPServer`` that feeds the
:class:`~.batcher.ContinuousBatcher` and maps its refusals onto the HTTP
status codes load balancers already understand:

- ``POST /v1/infer``  — ``{"inputs": [...], "deadline_ms": 250}`` →
  ``200 {"outputs": ..., "latency_ms": ...}``.  Overload → **429** with
  ``Retry-After`` and the live queue depth (the backpressure signal);
  draining → **503** + ``Retry-After`` (drain is transient); deadline
  blown → **504**.
- ``GET /v1/stats``   — batcher counters/percentiles plus the fault-
  tolerance surface (breaker state, retry/hedge/quarantine counters,
  availability) as JSON.

Fault tolerance — the hard invariant is that every ACCEPTED
request gets exactly one terminal response, no matter what dies:

- **Retries** — retryable failures (:class:`~.batcher.Retryable`: a
  replica peer fault mid-batch, a transient forward fault) are retried
  through :func:`~..common.net.retry_with_backoff` with capped
  exponential backoff + jitter.  Backoff is charged against the
  request's ORIGINAL deadline: an attempt whose backoff would outlive
  the deadline is abandoned immediately (504), never extended.
- **Idempotent re-submission** — every request carries an id; the
  batcher's resident-request map joins a retry to its own still-live
  earlier attempt instead of double-executing it.
- **Hedging** (``HOROVOD_SERVE_HEDGE_MS`` > 0) — when the primary
  attempt is slower than the observed p99 (the knob is the cold-start
  fallback while the latency histogram is empty and ``percentile``
  returns ``None``), a duplicate is dispatched under a twin id; the
  first terminal response wins and the loser is cancelled.
- **Circuit breaker** — consecutive retryable failures trip a
  :class:`~.resilience.CircuitBreaker`; while open, requests fast-fail
  **503** + ``Retry-After`` (the remaining open window) instead of
  burning their deadlines against a replica that is mid-heal; probes
  half-open it and successes close it.

Readiness integration: :meth:`drain` stops admission AND flips the rank's
:class:`~..monitor.agent.MonitorAgent` readiness latch, so the LB's
``/ready`` probe (monitor HTTP server) goes 503 the moment the elastic
driver cordons this replica — in-flight requests still complete.

Deliberately per-replica: each replica runs its own front door and an
external load balancer spreads requests across replicas using ``/ready``.
The collective plane (weight fan-out, telemetry aggregation) is the only
cross-replica traffic — every knob here is serve-local and adds zero
bytes to the warm control-plane frame.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .batcher import (
    ContinuousBatcher, DeadlineExceeded, Draining, QueueFull,
    ReplicaFaulted, RequestQuarantined, Retryable,
)
from .resilience import CircuitBreaker
from ..common.net import retry_with_backoff
from ..utils.logging import get_logger

log = get_logger()

# Drain is transient (rolling update / scale-in): tell the LB when to
# probe again instead of leaving 503 ambiguous with overload.
DRAIN_RETRY_AFTER_S = 5

# Retry backoff envelope (milliseconds).  Small on purpose: serving
# deadlines are sub-second to seconds, and backoff is charged against
# the request's own deadline.
RETRY_BASE_MS = 25.0
RETRY_MAX_MS = 1000.0


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class FrontDoor:
    """One replica's ingest surface: HTTP + in-process ``infer()``."""

    _rids = itertools.count()

    def __init__(self, batcher: ContinuousBatcher, port: int = 0,
                 addr: str = "", agent=None, retries: Optional[int] = None,
                 hedge_ms: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 slo: Optional[float] = None,
                 clock=time.monotonic):
        self.batcher = batcher
        self._agent = agent
        self._clock = clock
        self.retries = (_env_int("HOROVOD_SERVE_RETRIES", 2)
                        if retries is None else max(0, int(retries)))
        self.hedge_ms = (_env_float("HOROVOD_SERVE_HEDGE_MS", 0.0)
                         if hedge_ms is None else float(hedge_ms))
        self.slo = (_env_float("HOROVOD_SERVE_SLO", 0.999)
                    if slo is None else float(slo))
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            threshold=_env_int("HOROVOD_SERVE_BREAKER_THRESHOLD", 5),
            reset_s=_env_float("HOROVOD_SERVE_BREAKER_RESET_S", 5.0),
            probes=_env_int("HOROVOD_SERVE_BREAKER_PROBES", 2),
            clock=clock)
        reg = batcher.registry
        self._m_retries = reg.counter(
            "hvd_serve_retries_total", "front-door retry attempts")
        self._m_hedges = reg.counter(
            "hvd_serve_hedges_total", "hedged (duplicate) dispatches")
        self._m_hedge_wins = reg.counter(
            "hvd_serve_hedge_wins_total",
            "requests whose hedge twin finished first")
        self._m_breaker_open = reg.counter(
            "hvd_serve_breaker_open_total", "circuit-breaker trips")
        self._m_fastfail = reg.counter(
            "hvd_serve_breaker_fastfail_total",
            "requests fast-failed 503 while the breaker was open")
        self._m_ok = reg.counter(
            "hvd_serve_responses_ok_total", "terminal 200 responses")
        self._m_err = reg.counter(
            "hvd_serve_responses_error_total",
            "terminal error responses counted against the error budget "
            "(500/504 and non-drain 503)")
        self._g_breaker = reg.gauge(
            "hvd_serve_breaker_state",
            "circuit breaker: 0=closed 1=open 2=half-open")
        self._g_avail = reg.gauge(
            "hvd_serve_availability",
            "terminal-response availability (ok / (ok + error))")
        self._g_budget = reg.gauge(
            "hvd_serve_error_budget_remaining",
            "fraction of the SLO error budget left (negative = blown)")
        self._g_avail.set(1.0)
        self._g_budget.set(1.0)
        self._breaker_sync_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence stdlib request logging
                pass

            def _send(self, code: int, obj: dict, retry_after=None):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 - stdlib API
                try:
                    if self.path.split("?", 1)[0] == "/v1/stats":
                        self._send(200, outer.stats())
                    else:
                        self._send(404, {"error": "try /v1/stats or "
                                                  "POST /v1/infer"})
                except BrokenPipeError:  # pragma: no cover - client gone
                    pass

            def do_POST(self):  # noqa: N802 - stdlib API
                try:
                    if self.path.split("?", 1)[0] != "/v1/infer":
                        self._send(404, {"error": "POST /v1/infer"})
                        return
                    n = int(self.headers.get("Content-Length") or 0)
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError:
                        self._send(400, {"error": "invalid JSON"})
                        return
                    if "inputs" not in body:
                        self._send(400, {"error": "missing 'inputs'"})
                        return
                    out = outer.infer_detailed(
                        body["inputs"], body.get("deadline_ms"),
                        request_id=body.get("request_id"))
                    self._send(out.pop("_code"), out,
                               retry_after=out.pop("_retry_after", None))
                except BrokenPipeError:  # pragma: no cover - client gone
                    pass
                except Exception as exc:  # noqa: BLE001 - keep serving
                    try:
                        self._send(500, {"error": str(exc)})
                    except Exception:  # pragma: no cover
                        pass

        self._httpd = ThreadingHTTPServer((addr, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- ingest
    def infer_detailed(self, inputs, deadline_ms=None,
                       request_id=None) -> dict:
        """One request end-to-end — admission, retries, hedging, breaker —
        returning a JSON-able dict carrying the HTTP status in ``_code``
        (shared by the HTTP handler and tests).  Exactly one terminal
        outcome per call, bounded by the request's original deadline."""
        b = self.batcher
        ttl_s = (b.deadline_ms if deadline_ms is None
                 else float(deadline_ms)) / 1000.0
        deadline = self._clock() + ttl_s
        rid = (str(request_id) if request_id
               else f"fd-{next(FrontDoor._rids)}-{uuid.uuid4().hex[:8]}")

        if not self.breaker.allow():
            self._m_fastfail.inc()
            self._sync_breaker_gauge()
            ra = max(1, math.ceil(self.breaker.retry_after_s() or 1.0))
            return self._finish({
                "_code": 503, "_retry_after": ra, "request_id": rid,
                "error": "circuit open: replica faulted, healing",
                "breaker": self.breaker.state, "retryable": True})

        attempts = {"n": 0}
        # Did any attempt deliver a breaker verdict?  Terminal outcomes
        # that say nothing about replica health (deadline, queue full,
        # drain, quarantine) must RELEASE an admitted half-open probe
        # slot instead of leaking it — see the finally below.
        verdict = {"recorded": False}

        def attempt():
            attempts["n"] += 1
            remaining = deadline - self._clock()
            if remaining <= 0:
                raise DeadlineExceeded(
                    f"request {rid}: deadline exhausted before attempt "
                    f"{attempts['n']}")
            # Re-submission under the SAME id: the batcher's resident map
            # joins a still-live earlier attempt instead of forking it,
            # and the shrunken remaining ttl keeps the absolute deadline
            # fixed across attempts.
            req = b.submit(inputs, deadline_ms=remaining * 1000.0,
                           request_id=rid)
            try:
                winner, result = self._await(req, rid)
            except Retryable:
                verdict["recorded"] = True
                self.breaker.record_failure()
                self._sync_breaker_gauge()
                raise
            verdict["recorded"] = True
            self.breaker.record_success()
            self._sync_breaker_gauge()
            return winner, result

        def on_retry(n, exc, delay_s):
            # Deadline accounting: backoff that would outlive the
            # request's deadline is not taken — the pending retryable
            # error becomes the terminal response instead.
            if self._clock() + delay_s >= deadline:
                raise exc
            self._m_retries.inc()

        try:
            req, result = retry_with_backoff(
                attempt, retries=self.retries, base_ms=RETRY_BASE_MS,
                max_ms=RETRY_MAX_MS, exceptions=(Retryable,),
                on_retry=on_retry)
        except QueueFull:
            return self._finish({
                "_code": 429, "_retry_after": 1, "request_id": rid,
                "error": "queue full",
                "queue_depth": b.stats()["queue_depth"]})
        except Draining:
            return self._finish({
                "_code": 503, "_retry_after": DRAIN_RETRY_AFTER_S,
                "request_id": rid, "error": "draining", "draining": True})
        except RequestQuarantined as exc:
            return self._finish({
                "_code": 500, "request_id": rid, "error": str(exc),
                "quarantined": True})
        except ReplicaFaulted as exc:
            return self._finish({
                "_code": 503, "_retry_after": 1, "request_id": rid,
                "error": str(exc), "retryable": True,
                "attempts": attempts["n"]})
        except Retryable as exc:
            return self._finish({
                "_code": 500, "request_id": rid, "error": str(exc),
                "retryable": True, "attempts": attempts["n"]})
        except DeadlineExceeded as exc:
            return self._finish({
                "_code": 504, "request_id": rid, "error": str(exc)})
        except Exception as exc:  # noqa: BLE001 - routed per-request error
            code = 504 if "expired" in str(exc) or "within" in str(exc) \
                else 500
            return self._finish({
                "_code": code, "request_id": rid, "error": str(exc)})
        finally:
            if not verdict["recorded"]:
                self.breaker.release_probe()
                self._sync_breaker_gauge()
        outputs = result.tolist() if hasattr(result, "tolist") else result
        return self._finish({
            "_code": 200, "outputs": outputs, "request_id": rid,
            "attempts": attempts["n"],
            "latency_ms": round(
                (req.completed_at - req.enqueued_at) * 1e3, 3)})

    def _await(self, req, rid: str):
        """Wait one attempt out, hedging the tail when enabled: if the
        primary is slower than the observed p99 (``hedge_ms`` is the
        cold-start fallback while the histogram is empty), dispatch a
        duplicate under a twin id; first terminal response wins, the
        loser is cancelled (queued) or discarded (in flight).  Returns
        ``(winning_request, result)`` so the caller reports the winner's
        latency."""
        b = self.batcher
        remaining = max(0.0, req.deadline - self._clock())
        delay_s = self._hedge_delay_s(remaining)
        if delay_s is None:
            return req, self._wait_or_cancel(req, remaining + 0.25)
        try:
            return req, req.wait(timeout=delay_s)
        except DeadlineExceeded:
            if req.done():          # settled at the boundary: routed error
                return req, req.wait(0)
        remaining = max(0.0, req.deadline - self._clock())
        try:
            hedge = b.submit(req.inputs, deadline_ms=remaining * 1000.0,
                             request_id=rid + ".hedge")
        except (QueueFull, Draining):
            # No room to hedge — keep waiting on the primary.
            return req, self._wait_or_cancel(req, remaining + 0.25)
        self._m_hedges.inc()
        settled = threading.Event()
        req.on_done(lambda _r: settled.set())
        hedge.on_done(lambda _r: settled.set())
        end = self._clock() + remaining + 0.25
        while not (req.done() or hedge.done()):
            left = end - self._clock()
            if left <= 0:
                break
            settled.wait(min(left, 0.05))
        if req.done() and (not hedge.done() or req.error is None
                           or hedge.error is not None):
            winner, loser = req, hedge
        elif hedge.done():
            winner, loser = hedge, req
        else:
            # Terminal timeout: cancel BOTH twins, not just the hedge —
            # a primary left resident would absorb a client re-submission
            # under the same id (submit joins resident entries, ignoring
            # the fresh deadline) and doom it to another 504.
            b.cancel(hedge)
            b.cancel(req)
            raise DeadlineExceeded(
                f"request {rid}: no result within {remaining:.3f}s")
        if winner is hedge:
            self._m_hedge_wins.inc()
        b.cancel(loser)
        return winner, winner.wait(0)

    def _wait_or_cancel(self, req, timeout_s: float):
        """``req.wait`` that cancels the request on ITS OWN timeout, so a
        timed-out-but-still-queued request does not stay resident to
        swallow a client re-submission under the same id."""
        try:
            return req.wait(timeout=timeout_s)
        except DeadlineExceeded:
            self.batcher.cancel(req)
            raise

    def _hedge_delay_s(self, remaining_s: float) -> Optional[float]:
        if self.hedge_ms <= 0:
            return None
        p99 = self.batcher.latency_percentile(0.99)
        delay_ms = self.hedge_ms if p99 is None else max(float(p99), 1.0)
        delay_s = delay_ms / 1000.0
        if delay_s >= remaining_s:
            return None             # no deadline room left to hedge in
        return delay_s

    def infer(self, inputs, deadline_ms=None, request_id=None):
        """In-process convenience: result or raised error."""
        out = self.infer_detailed(inputs, deadline_ms=deadline_ms,
                                  request_id=request_id)
        if out["_code"] != 200:
            raise RuntimeError(f"infer failed ({out['_code']}): "
                               f"{out.get('error')}")
        return out["outputs"]

    # ---------------------------------------------------------- telemetry
    def _sync_breaker_gauge(self) -> None:
        # One lock around the read-then-inc: two handler threads racing
        # the naive `while value < trips: inc()` loop would both observe
        # the gap and over-count a Counter that can never be corrected.
        with self._breaker_sync_lock:
            self._g_breaker.set(self.breaker.state_code())
            delta = self.breaker.trips - self._m_breaker_open.value
            if delta > 0:
                self._m_breaker_open.inc(delta)

    def _finish(self, out: dict) -> dict:
        """Classify the terminal response into the availability gauges.
        429 (backpressure), 400 (caller bug) and drain 503 are not
        service errors; breaker/fault 503, 500 and 504 are."""
        code = out["_code"]
        if code == 200:
            self._m_ok.inc()
        elif code in (500, 504) or (code == 503 and not out.get("draining")):
            self._m_err.inc()
        ok, err = self._m_ok.value, self._m_err.value
        total = ok + err
        if total:
            avail = ok / total
            self._g_avail.set(round(avail, 6))
            budget = 1.0 - self.slo
            if budget > 0:
                self._g_budget.set(
                    round(1.0 - (1.0 - avail) / budget, 6))
        return out

    def stats(self) -> dict:
        """Batcher counters plus the fault-tolerance surface (what
        ``GET /v1/stats`` serves)."""
        out = self.batcher.stats()
        out.update({
            "breaker_state": self.breaker.state,
            "breaker_trips": self.breaker.trips,
            "retries_total": self._m_retries.value,
            "hedges_total": self._m_hedges.value,
            "hedge_wins_total": self._m_hedge_wins.value,
            "responses_ok_total": self._m_ok.value,
            "responses_error_total": self._m_err.value,
            "availability": self._g_avail.value,
            "error_budget_remaining": self._g_budget.value,
        })
        return out

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "FrontDoor":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-tpu-serve-http",
            daemon=True)
        self._thread.start()
        log.info("serve: front door listening on :%d "
                 "(POST /v1/infer, GET /v1/stats)", self.port)
        return self

    def drain(self) -> None:
        """Cordon this replica: refuse new work, flip ``/ready`` to 503,
        let queued/in-flight requests complete."""
        self.batcher.drain()
        if self._agent is not None:
            try:
                self._agent.set_ready(
                    False, "draining: serve front door cordoned")
            except Exception:  # noqa: BLE001 - telemetry never blocks
                pass

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
