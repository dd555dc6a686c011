# Copied from horovod_tpu/serve/batcher.py:1-504 (jax-free; the port keeps its
# own copy), its knob read through the port's Config lookup.
"""Continuous-batching admission queue for the serving plane (no jax).

The front half of the data-parallel serving plane (``docs/serving.md``):
requests arrive one at a time (HTTP or in-process), the replica's
forward loop consumes them in *padded-bucket* batches, and the two sides
meet here.  Three ideas carried over from the training
engine rather than invented fresh:

- **Bounded in-flight window** — ``max_inflight`` is the serving twin of
  ``HOROVOD_MAX_INFLIGHT``'s :class:`~..ops.scheduler.InflightRing`
  semantics: at most N batches may be dispatched-but-unsettled at once,
  and :meth:`next_batch` blocks while the window is full.  Same reason as
  training: unbounded dispatch converts a slow device into unbounded
  host-memory growth and tail-latency collapse.
- **Padded buckets** — batches are padded up to a fixed menu of sizes
  (default: powers of two up to ``max_batch``) so the replica sees a
  handful of distinct batch shapes, each compiled once and keyed into the
  :class:`~..ops.scheduler.FusedProgramCache`.  Batch-size churn between
  requests never recompiles.
- **Backpressure, not buffering** — :meth:`submit` raises
  :class:`QueueFull` the moment the ingest queue hits ``queue_depth``;
  the front door turns that into HTTP 429 plus a queue-depth signal the
  autoscaler reads.  An admission queue that silently grows just moves
  the overload from the caller's timeout to the tail of the queue.

Everything here is stdlib-only and clock-injected (``clock=`` in the
constructor) so the jax-free test tier drives admission, deadlines,
bucketing and backpressure deterministically.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

from ..common.config import _env
from ..utils.logging import get_logger

log = get_logger()

# Latency histogram buckets in MILLISECONDS (request-scale, not the
# registry's coordinator-cycle-microsecond defaults).
LATENCY_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 10000.0)


class QueueFull(RuntimeError):
    """Admission refused: the ingest queue is at ``queue_depth``.  The
    front door maps this to HTTP 429."""


class Draining(RuntimeError):
    """Admission refused: the replica is draining (cordoned by the
    elastic driver).  The front door maps this to HTTP 503."""


class DeadlineExceeded(RuntimeError):
    """The request expired before a replica picked it up (or the caller
    stopped waiting).  The front door maps this to HTTP 504."""


class Retryable(RuntimeError):
    """Base for failures the front door may transparently retry: the
    request itself is fine, the attempt died underneath it.  Retries are
    deadline-bounded — backoff is charged against the request's original
    deadline, never extended past it."""


class ReplicaFaulted(Retryable):
    """The replica lost a peer mid-batch (HVD303 / clean LEAVE race).
    The batch's requests are failed with this so the front door can
    re-submit them once the surviving world re-rendezvouses.  Maps to
    HTTP 503 + ``Retry-After`` when retries are exhausted."""


class ForwardFailed(Retryable):
    """One forward execution failed (injected I/O fault, transient device
    error).  Retryable until quarantine decides the request itself is the
    problem.  Maps to HTTP 500 when retries are exhausted."""


class RequestQuarantined(RuntimeError):
    """Terminal: this request failed ``quarantine_after`` consecutive
    forwards — the input is treated as poisoned and is never re-batched
    (one bad request must not wedge the replica).  Maps to HTTP 500."""


class Cancelled(RuntimeError):
    """The request was cancelled before dispatch (a hedge whose twin
    finished first).  Never surfaces to HTTP: the winner's response is
    the terminal one."""


def parse_buckets(spec: str, max_batch: int) -> Tuple[int, ...]:
    """Bucket menu from ``HOROVOD_SERVE_BUCKETS`` (comma-separated sizes);
    empty spec → powers of two up to ``max_batch``.  Always sorted, always
    capped by ``max_batch``, always non-empty."""
    max_batch = max(1, int(max_batch))
    sizes: List[int] = []
    if spec:
        for tok in spec.split(","):
            tok = tok.strip()
            if tok:
                sizes.append(int(tok))
        sizes = [s for s in sizes if 1 <= s <= max_batch]
    if not sizes:
        sizes = list(itertools.takewhile(lambda s: s <= max_batch,
                                         (1 << i for i in range(31))))
    if max_batch not in sizes:
        sizes.append(max_batch)
    return tuple(sorted(set(sizes)))


class Request:
    """One in-flight inference request; ``wait()`` is the caller's side."""

    __slots__ = ("id", "key", "inputs", "deadline", "enqueued_at", "_event",
                 "result", "error", "completed_at", "_callbacks", "_cb_lock")
    _ids = itertools.count()

    def __init__(self, inputs, deadline: float, enqueued_at: float,
                 key: Optional[str] = None):
        self.id = next(Request._ids)
        self.key = key if key is not None else f"req-{self.id}"
        self.inputs = inputs
        self.deadline = deadline
        self.enqueued_at = enqueued_at
        self._event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.completed_at: Optional[float] = None
        self._callbacks: List[Callable[["Request"], None]] = []
        self._cb_lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def on_done(self, cb: Callable[["Request"], None]) -> None:
        """Register ``cb(request)`` to run when this request settles;
        fires immediately if it already has (the hedging race is between
        registration and settlement)."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def _fire_settled(self) -> List[Callable[["Request"], None]]:
        """Flip the settled event and drain the callback list atomically;
        the batcher invokes the returned callbacks outside its own lock."""
        with self._cb_lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        return cbs

    def wait(self, timeout: Optional[float] = None):
        """Block until the replica settles this request; returns the
        result or raises the routed error (DeadlineExceeded on its own
        timeout)."""
        if not self._event.wait(timeout):
            raise DeadlineExceeded(
                f"request {self.id}: no result within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class Batch:
    """One dispatched unit: up to ``bucket`` requests padded to a fixed
    bucket size.  Results route back by POSITION — ``complete(results)``
    aligns ``results[i]`` with ``requests[i]``; the padding rows past
    ``size`` are the replica's to discard."""

    __slots__ = ("requests", "bucket")

    def __init__(self, requests: List[Request], bucket: int):
        self.requests = requests
        self.bucket = bucket

    @property
    def size(self) -> int:
        return len(self.requests)


class ContinuousBatcher:
    """Admission queue + padded-bucket batch former (thread-safe)."""

    def __init__(self, max_batch: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 deadline_ms: float = 1000.0, max_inflight: int = 2,
                 queue_depth: int = 128, registry=None,
                 quarantine_after: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_batch = max(1, int(max_batch))
        if buckets:
            self.buckets = tuple(sorted({int(b) for b in buckets
                                         if 1 <= int(b) <= self.max_batch}
                                        | {self.max_batch}))
        else:
            self.buckets = parse_buckets("", self.max_batch)
        self.deadline_ms = float(deadline_ms)
        self.max_inflight = max(1, int(max_inflight))
        self.queue_depth = max(1, int(queue_depth))
        self._clock = clock
        if quarantine_after is None:
            try:
                quarantine_after = int(_env("SERVE_QUARANTINE_AFTER") or 3)
            except ValueError:
                quarantine_after = 3
        self.quarantine_after = max(1, int(quarantine_after))
        self._cv = threading.Condition()
        self._queue: List[Request] = []
        self._inflight = 0
        self._draining = False
        # Idempotent re-submission: request-id -> live (unsettled) Request.
        # A front-door retry that races its own earlier attempt gets the
        # resident request back instead of double-executing it.
        self._resident: dict = {}
        # Poisoned-request quarantine: request-id -> consecutive forward
        # failures.  Reset on success, terminal at quarantine_after.
        # Ordered by last UPDATE so the size bound evicts stale entries,
        # never the count of a request actively being retried.
        self._fail_counts: OrderedDict = OrderedDict()
        # Telemetry: real registry metrics when the monitor is up, cheap
        # stand-ins otherwise — the batcher never imports jax either way.
        if registry is None:
            from ..monitor.registry import MetricRegistry
            registry = MetricRegistry()
        self.registry = registry
        self._m_requests = registry.counter(
            "hvd_serve_requests_total", "requests admitted")
        self._m_rejected = registry.counter(
            "hvd_serve_rejected_total", "requests refused: queue full")
        self._m_expired = registry.counter(
            "hvd_serve_expired_total", "requests expired before dispatch")
        self._m_batches = registry.counter(
            "hvd_serve_batches_total", "batches dispatched")
        self._m_padding = registry.counter(
            "hvd_serve_padding_rows_total",
            "bucket padding rows dispatched")
        self._m_latency = registry.histogram(
            "hvd_serve_latency_ms", "request latency, admission to result",
            buckets=LATENCY_MS_BUCKETS)
        self._g_queue = registry.gauge(
            "hvd_serve_queue_depth", "requests awaiting dispatch")
        self._g_inflight = registry.gauge(
            "hvd_serve_inflight", "dispatched, unsettled batches")
        self._m_resubmitted = registry.counter(
            "hvd_serve_resubmitted_total",
            "idempotent re-submissions joined to a resident request")
        self._m_quarantined = registry.counter(
            "hvd_serve_quarantined_total",
            "requests failed terminally by the poisoned-request quarantine")
        self._m_replica_faults = registry.counter(
            "hvd_serve_replica_faults_total",
            "batches failed retryably by a replica peer fault")
        self._m_requeued = registry.counter(
            "hvd_serve_requeued_total",
            "queued requests preserved (original deadlines) across a "
            "replica fault")
        self._m_cancelled = registry.counter(
            "hvd_serve_cancelled_total",
            "queued requests cancelled before dispatch (hedge losers)")

    # ----------------------------------------------------------- admission
    def submit(self, inputs, deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None) -> Request:
        """Admit one request or refuse loudly (QueueFull / Draining).

        ``request_id`` makes admission idempotent: a re-submission under
        an id that is still resident (queued or in a dispatched batch)
        returns the EXISTING request instead of double-executing it — the
        front door's retry path leans on this so a retry that races its
        own not-yet-settled attempt joins it rather than forking it."""
        now = self._clock()
        ttl = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        with self._cv:
            if request_id is not None:
                live = self._resident.get(request_id)
                if live is not None and not live.done():
                    self._m_resubmitted.inc()
                    return live
            if self._draining:
                raise Draining("replica is draining; not accepting work")
            if len(self._queue) >= self.queue_depth:
                self._m_rejected.inc()
                raise QueueFull(
                    f"ingest queue at depth {self.queue_depth}")
            req = Request(inputs, deadline=now + ttl / 1000.0,
                          enqueued_at=now, key=request_id)
            self._resident[req.key] = req
            self._queue.append(req)
            self._m_requests.inc()
            self._g_queue.set(len(self._queue))
            self._cv.notify_all()
        return req

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` requests (clamped to the
        largest — callers never form batches past ``max_batch``)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    # ------------------------------------------------------------ dispatch
    def next_batch(self, timeout: Optional[float] = None) -> Optional[Batch]:
        """Block until (a) work is queued AND (b) the in-flight window has
        room, then pop up to ``max_batch`` requests as one padded-bucket
        batch.  Expired requests are failed in place (never dispatched).
        None on timeout or when draining with an empty queue."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cv:
            while True:
                self._expire_locked()
                if self._queue and self._inflight < self.max_inflight:
                    take = min(len(self._queue), self.max_batch)
                    reqs = self._queue[:take]
                    del self._queue[:take]
                    bucket = self.bucket_for(take)
                    self._inflight += 1
                    self._m_batches.inc()
                    self._m_padding.inc(bucket - take)
                    self._g_queue.set(len(self._queue))
                    self._g_inflight.set(self._inflight)
                    return Batch(reqs, bucket)
                if self._draining and not self._queue:
                    return None
                wait = None
                if deadline is not None:
                    wait = deadline - self._clock()
                    if wait <= 0:
                        return None
                self._cv.wait(wait if wait is not None else 0.1)

    def _expire_locked(self) -> None:
        now = self._clock()
        keep: List[Request] = []
        for r in self._queue:
            if r.deadline <= now:
                self._m_expired.inc()
                self._settle(r, error=DeadlineExceeded(
                    f"request {r.id}: expired after "
                    f"{(now - r.enqueued_at) * 1e3:.0f}ms in queue"))
            else:
                keep.append(r)
        if len(keep) != len(self._queue):
            self._queue[:] = keep
            self._g_queue.set(len(keep))

    # ------------------------------------------------------------ settling
    def _settle(self, req: Request, result=None,
                error: Optional[BaseException] = None) -> None:
        req.result = result
        req.error = error
        req.completed_at = self._clock()
        with self._cv:   # RLock: safe under _expire_locked's held _cv
            self._resident.pop(req.key, None)
            if error is None:
                self._fail_counts.pop(req.key, None)
                self._m_latency.observe(
                    (req.completed_at - req.enqueued_at) * 1e3)
        for cb in req._fire_settled():
            cb(req)

    def complete(self, batch: Batch, results: Sequence) -> None:
        """Route ``results`` back by position; frees one window slot."""
        if len(results) < batch.size:
            raise ValueError(
                f"batch of {batch.size} got {len(results)} results")
        for req, res in zip(batch.requests, results):
            self._settle(req, result=res)
        with self._cv:
            self._inflight -= 1
            self._g_inflight.set(self._inflight)
            self._cv.notify_all()

    def fail(self, batch: Batch, error: BaseException) -> None:
        """Fail every request in ``batch`` with a typed error, charging
        the poisoned-request quarantine: each consecutive forward failure
        under the same request id counts toward ``quarantine_after``, at
        which point the request is failed TERMINALLY
        (:class:`RequestQuarantined`) instead of retryably — a re-submitted
        poisoned input cannot wedge the replica into failing every batch
        it rides in."""
        for req in batch.requests:
            with self._cv:
                n = self._fail_counts.get(req.key, 0) + 1
                if n >= self.quarantine_after:
                    self._fail_counts.pop(req.key, None)
                    self._m_quarantined.inc()
                    routed: BaseException = RequestQuarantined(
                        f"request {req.key}: {n} consecutive forward "
                        f"failures (last: {error}); quarantined")
                else:
                    self._fail_counts[req.key] = n
                    self._fail_counts.move_to_end(req.key)
                    # Bound the book-keeping: a failed request that is
                    # never re-submitted must not leak its count forever.
                    # Least-recently-UPDATED goes first, so a request
                    # mid-retry never loses its streak to the bound.
                    while len(self._fail_counts) > 4 * self.queue_depth:
                        self._fail_counts.popitem(last=False)
                    routed = ForwardFailed(
                        f"request {req.key}: forward failed "
                        f"(consecutive failure {n}): {error}")
                routed.__cause__ = error
            self._settle(req, error=routed)
        with self._cv:
            self._inflight -= 1
            self._g_inflight.set(self._inflight)
            self._cv.notify_all()

    def fail_retryable(self, batch: Batch,
                       cause: Optional[BaseException] = None) -> None:
        """Replica-fault path: a peer died mid-batch.  The dispatched
        batch's requests are failed with :class:`ReplicaFaulted` — a
        RETRYABLE verdict that does NOT charge the quarantine (the fault
        is the world's, not the request's) — while everything still
        queued is left untouched with its ORIGINAL deadline for the
        re-armed serve loop to dispatch after re-rendezvous."""
        for req in batch.requests:
            routed = ReplicaFaulted(
                f"request {req.key}: replica fault mid-batch "
                f"({cause if cause is not None else 'peer lost'}); "
                f"retryable")
            if cause is not None:
                routed.__cause__ = cause
            self._settle(req, error=routed)
        with self._cv:
            self._m_replica_faults.inc()
            self._m_requeued.inc(len(self._queue))
            self._inflight -= 1
            self._g_inflight.set(self._inflight)
            self._cv.notify_all()

    def cancel(self, req: Request) -> bool:
        """Cancel a request that is still QUEUED (a hedge whose twin won):
        removed from the queue and settled with :class:`Cancelled`.
        Returns False — and does nothing — once the request was dispatched
        or settled; an in-flight hedge loser just finishes and its result
        is discarded by the caller."""
        with self._cv:
            if req.done() or req not in self._queue:
                return False
            self._queue.remove(req)
            self._m_cancelled.inc()
            self._g_queue.set(len(self._queue))
            self._settle(req, error=Cancelled(
                f"request {req.key}: cancelled before dispatch"))
            self._cv.notify_all()
        return True

    # -------------------------------------------------------------- drain
    def drain(self) -> None:
        """Stop admitting; queued work still dispatches and settles (the
        elastic drain contract: in-flight requests COMPLETE, new ones are
        refused).  Queued requests whose deadlines have ALREADY expired
        are failed promptly here — dead-on-arrival work completing as a
        late 504 at dispatch time would waste the drain window."""
        with self._cv:
            self._draining = True
            self._expire_locked()
            self._cv.notify_all()

    @property
    def draining(self) -> bool:
        with self._cv:
            return self._draining

    def pending(self) -> int:
        with self._cv:
            return len(self._queue) + self._inflight

    def latency_percentile(self, q: float):
        """Observed request-latency percentile in ms — ``None`` until the
        first success lands (the hedging delay reads this at startup and
        must fall back to its knob, not crash)."""
        return self._m_latency.percentile(q)

    def stats(self) -> dict:
        with self._cv:
            return {
                "queue_depth": len(self._queue),
                "inflight": self._inflight,
                "draining": self._draining,
                "buckets": list(self.buckets),
                "requests_total": self._m_requests.value,
                "rejected_total": self._m_rejected.value,
                "expired_total": self._m_expired.value,
                "batches_total": self._m_batches.value,
                "padding_rows_total": self._m_padding.value,
                "resubmitted_total": self._m_resubmitted.value,
                "quarantined_total": self._m_quarantined.value,
                "replica_faults_total": self._m_replica_faults.value,
                "requeued_total": self._m_requeued.value,
                "cancelled_total": self._m_cancelled.value,
                "latency_p50_ms": self._m_latency.percentile(0.5),
                "latency_p99_ms": self._m_latency.percentile(0.99),
            }
