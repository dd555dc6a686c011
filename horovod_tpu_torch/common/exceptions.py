# Copied from horovod_tpu/common/exceptions.py:1-160 (jax-free; the port keeps its own copy).
"""Typed control-plane error taxonomy (no jax imports).

The reference signals world-level failures through ``HorovodInternalError``
(``horovod/common/exceptions.py``): the elastic ``run`` wrapper catches it,
restores the last committed state, and re-rendezvouses (SURVEY.md §3.4).
This module is the jax-free home of that hierarchy so the TCP controller,
the fault-injection harness (``horovod_tpu/testing``) and the monitor
subsystem can all raise/inspect typed failures without dragging jax into
the fast test tier.  ``elastic/state.py`` re-exports
``HorovodInternalError`` for backwards compatibility.

Taxonomy::

    RuntimeError
     └─ HorovodInternalError          world-level failure; elastic resets
         └─ ControlPlaneError         coordinator control plane failed
             ├─ PeerFailureError      HVD303: a peer died / was declared
             │                        dead (carries the dead-rank list)
             └─ RoundTimeoutError     HVD303: this rank's negotiation
                                      round exceeded its wall-clock
                                      deadline (peers unattributable)
    TimeoutError
     └─ JoinTimeoutError              hvd.join() did not complete in time
    Exception
     ├─ HostsUpdatedInterrupt        host set changed; re-rendezvous
     │   └─ PeerLeftInterrupt        a peer sent a clean LEAVE (v6) —
     │                               world shrank, NOT a fault
     └─ DrainRequested               the driver asked this worker to
                                     drain: finish batch, LEAVE, exit 0

``NegotiationError`` (an application-level per-tensor failure, deliberately
NOT a HorovodInternalError) stays in ``common/controller.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence


class HorovodInternalError(RuntimeError):
    """A peer died mid-collective; training must roll back to last commit.

    The elastic ``@hvd.elastic.run`` wrapper catches this, restores the
    last committed state, re-initializes the runtime and re-rendezvouses
    with the surviving host set; without the wrapper it propagates as a
    plain RuntimeError (static jobs fail fast instead of hanging).
    """


class ControlPlaneError(HorovodInternalError):
    """The coordinator control plane failed (dead peer, abort broadcast,
    or a missed deadline).  Base class for the HVD303 family — catch this
    to handle any control-plane fault uniformly."""


class PeerFailureError(ControlPlaneError):
    """HVD303: the coordinator declared one or more peer ranks dead.

    Raised on surviving ranks when the server broadcasts a typed ABORT
    (a peer's socket died or it missed the per-round deadline), or when
    this rank's own connection to the coordinator was severed.  Carries
    the dead-rank attribution when known.

    Attributes:
        dead_ranks: sorted list of ranks the server declared dead
            (empty when the failure could not be attributed — e.g. the
            coordinator itself vanished before naming anyone).
        reason: the server's verdict string (connection loss vs missed
            deadline, and in which round).
    """

    def __init__(self, message: str,
                 dead_ranks: Optional[Sequence[int]] = None,
                 reason: str = ""):
        super().__init__(message)
        self.dead_ranks = sorted(dead_ranks or [])
        self.reason = reason


class RoundTimeoutError(ControlPlaneError):
    """HVD303: a negotiation round exceeded ``HOROVOD_ROUND_TIMEOUT_S``.

    Raised by the client when the coordinator's response did not arrive
    inside the wall-clock deadline — the coordinator (or the laggard rank
    gating the lock-step round) is wedged but its socket is still open, so
    no dead-rank attribution is available from the wire; the monitor
    aggregator may still enrich the message with per-rank snapshot ages.

    Attributes:
        timeout_s: the deadline that expired.
    """

    def __init__(self, message: str, timeout_s: float = 0.0):
        super().__init__(message)
        self.timeout_s = timeout_s


class JoinTimeoutError(TimeoutError):
    """``hvd.join()`` did not complete within the caller's timeout.

    Contract: ``join_wait(timeout=)`` either returns the last rank to
    join (an ``int >= 0``) or raises this — it never returns a sentinel.
    Subclasses ``TimeoutError`` so pre-existing ``except TimeoutError``
    call sites keep working."""


class HostsUpdatedInterrupt(Exception):
    """The elastic driver notified a host-set change; re-rendezvous keeping
    current (committed-or-not) parameters.

    Historically defined in ``elastic/state.py``; moved here (jax-free) so
    the controller, the engine and the autoscaling stack can raise it
    without dragging jax into the fast test tier.  ``elastic/state.py``
    re-exports it, so ``isinstance`` checks against either import path see
    ONE class.  Deliberately NOT a :class:`HorovodInternalError`: the
    elastic run wrapper keeps current parameters (no restore) on this
    path."""

    def __init__(self, skip_sync: bool = False):
        self.skip_sync = skip_sync


class PeerLeftInterrupt(HostsUpdatedInterrupt):
    """A peer rank departed with a clean LEAVE (protocol v6) — the world
    must re-form before any more default-process-set collectives run.

    Raised on survivors when the coordinator's leave notice arrives: new
    world-level submissions fail with it immediately, and world-level
    verdicts computed over the shrunk control-plane world are failed with
    it instead of executed (the data-plane world is still the old, fixed
    size — executing would wedge the transport).  A
    :class:`HostsUpdatedInterrupt` subclass: the elastic run wrapper
    re-rendezvouses keeping current parameters, exactly like a
    driver-pinged host change — NOT an HVD303 fault, the departure was
    orderly.

    Attributes:
        left_ranks: sorted ranks that announced a clean LEAVE.
    """

    def __init__(self, left_ranks: Optional[Sequence[int]] = None):
        super().__init__(skip_sync=False)
        self.left_ranks = sorted(left_ranks or [])

    def __str__(self):
        return (f"peer rank(s) {self.left_ranks} left the world cleanly "
                f"(protocol v6 LEAVE); re-rendezvous before submitting "
                f"more world-level collectives")


class DrainRequested(Exception):
    """The elastic driver asked this worker to drain: finish the current
    batch, send a clean LEAVE, and exit 0.

    Delivered through the worker notification channel (the autoscaler's
    scale-in / straggler-evict path) and raised from ``state.commit()`` —
    the same check point as :class:`HostsUpdatedInterrupt`, so the worker
    always drains at a batch boundary with its state committed.  The
    ``@hvd.elastic.run`` wrapper catches it, shuts the runtime down (which
    sends the LEAVE) and returns; the host is NOT blacklisted."""
