# Copied from horovod_tpu/testing/faults.py:1-403 (jax-free; the port keeps its own copy).
"""Deterministic fault-injection harness for the coordinator control plane.

The reference proves its failure paths with integration tests that really
kill workers (``test/integration/test_elastic_torch.py`` SIGKILLs a rank
mid-epoch); reproducing that deterministically needs the kill to land at a
*named protocol point*, not "roughly when the signal arrives".  This
module provides those points: the controller (and anything else on the
control plane) calls :func:`fire` at well-known places, and a single
environment variable arms exactly one of them::

    HVD_TPU_FAULT=<point>:<rank>:<action>[:<nth>]

    point   connect        before the TCP connect to the coordinator
            pre_announce   entering negotiate(), before building announces
            round_send     before the request frame is written
            mid_round_exit after the request is sent, before the response
                           is read (a crash here is the classic
                           "died mid-negotiation" shape: the server has
                           this rank's frame, the rank is gone)
            round_recv     before blocking for the response frame
    rank    the rank the fault targets (other ranks never fire)
    action  crash          os._exit(13) — an unclean process death
            hang           sleep forever (bounded by _HANG_S; trips round
                           deadlines / stall machinery)
            delay_ms=N     sleep N milliseconds, then continue
            econnreset     abruptly sever the controller connection (the
                           caller passes the sever callback), then
                           continue — the peer observes a dead socket
    nth     fire on the nth arrival at that point (default 1); earlier
            arrivals pass through untouched, later ones too (one-shot)

Zero-cost when unarmed: :func:`armed` is a module-flag check, and the
controller caches ``fire`` only when it returns True — an unarmed run
never executes a single instruction of this module on the hot path (the
steady-state frame guard in ``tests/test_response_cache.py`` additionally
proves the wire carries zero extra bytes either way).

No jax imports (tier-1 purity guard).  Thread-safe: the nth-counters are
lock-guarded because fault points fire from the engine cycle thread while
tests may arm/disarm from the main thread.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, Optional

from ..utils.logging import get_logger

log = get_logger()

ENV_VAR = "HVD_TPU_FAULT"

POINTS = ("connect", "pre_announce", "round_send", "mid_round_exit",
          "round_recv",
          # Resilient state plane (elastic/stateplane.py):
          #   ckpt_write_fail    each shard-chunk write attempt (io_error
          #                      with nth=1 proves retry_with_backoff
          #                      recovers; nth=0 — persistent — proves a
          #                      failed epoch degrades to the previous
          #                      durable one)
          #   ckpt_torn          between the shard rename and the
          #                      manifest rename — a crash/io_error here
          #                      leaves a torn epoch restore must skip
          #   restore_peer_exit  a survivor about to serve a shard —
          #                      econnreset/crash model peer death
          #                      mid-restore (the joiner re-fetches from
          #                      another survivor or falls back to disk)
          "ckpt_write_fail", "ckpt_torn", "restore_peer_exit",
          # Serving plane (serve/replica.py): fired once per
          # dispatched BATCH, mid-batch — after the batcher handed the
          # requests over, before results route back.  Usually armed
          # through the serving sugar verbs below rather than spelled
          # out.
          "serve_forward")
ACTIONS = ("crash", "hang", "delay_ms", "econnreset", "io_error")

# Serving chaos sugar: operator-facing spellings that expand
# to serve_forward faults.
#
#     replica_crash:<rank>@<nth>     unclean death mid-batch on the nth
#                                    dispatched batch (also accepts ':'
#                                    as the separator)
#     forward_fault:<rank>:<nth>     the nth forward raises an injected
#                                    I/O error (retryable at the front
#                                    door; consecutive repeats feed the
#                                    quarantine)
#     slow_replica:<rank>:<delay_ms> EVERY forward stalls delay_ms
#                                    (persistent; the hedging target)
SERVE_VERBS = ("replica_crash", "forward_fault", "slow_replica")

# Bounded "forever": long enough to trip any reasonable deadline, short
# enough that a leaked daemon thread cannot outlive a CI job by much.
_HANG_S = 3600.0

_EXIT_CODE = 13  # distinct from rc=1 so tests can tell crash from bug


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed ``HVD_TPU_FAULT`` directive."""
    point: str
    rank: int
    action: str
    arg: float = 0.0     # delay_ms payload
    nth: int = 1

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        text = text.strip()
        head = text.split(":", 1)[0].split("@", 1)[0]
        if head in SERVE_VERBS:
            return cls._parse_serving(text)
        parts = text.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"{ENV_VAR} must be <point>:<rank>:<action>[:<nth>], "
                f"got {text!r}")
        point, rank_s, action_s = parts[0], parts[1], parts[2]
        nth = int(parts[3]) if len(parts) == 4 else 1
        if point not in POINTS:
            raise ValueError(
                f"{ENV_VAR}: unknown fault point {point!r} "
                f"(valid: {', '.join(POINTS)})")
        arg = 0.0
        if action_s.startswith("delay_ms="):
            action = "delay_ms"
            arg = float(action_s.split("=", 1)[1])
        else:
            action = action_s
        if action not in ACTIONS:
            raise ValueError(
                f"{ENV_VAR}: unknown action {action_s!r} "
                f"(valid: crash, hang, delay_ms=N, econnreset, io_error)")
        # nth=0 = PERSISTENT: fire on EVERY arrival (no one-shot latch) —
        # how a persistently failing disk is modeled (the state plane's
        # bounded retries must exhaust, not be saved by the next attempt).
        if nth < 0:
            raise ValueError(f"{ENV_VAR}: nth must be >= 0, got {nth}")
        return cls(point=point, rank=int(rank_s), action=action, arg=arg,
                   nth=nth)

    @classmethod
    def _parse_serving(cls, text: str) -> "FaultSpec":
        """Expand a serving sugar verb into its serve_forward spec."""
        parts = text.replace("@", ":").split(":")
        verb = parts[0]
        try:
            rank = int(parts[1])
            if rank < 0:
                raise ValueError
        except (IndexError, ValueError):
            raise ValueError(
                f"{ENV_VAR}: {verb} needs a non-negative rank, "
                f"got {text!r}") from None
        if verb == "slow_replica":
            # slow_replica:<rank>:<delay_ms> — persistent (every batch).
            if len(parts) != 3:
                raise ValueError(
                    f"{ENV_VAR}: slow_replica must be "
                    f"slow_replica:<rank>:<delay_ms>, got {text!r}")
            try:
                delay = float(parts[2])
                if delay < 0:
                    raise ValueError
            except ValueError:
                raise ValueError(
                    f"{ENV_VAR}: slow_replica delay_ms must be a "
                    f"non-negative number, got {text!r}") from None
            return cls(point="serve_forward", rank=rank, action="delay_ms",
                       arg=delay, nth=0)
        # replica_crash:<rank>@<nth> / forward_fault:<rank>:<nth>
        # (nth optional, default 1; nth=0 = persistent like the base
        # grammar).
        if len(parts) not in (2, 3):
            raise ValueError(
                f"{ENV_VAR}: {verb} must be {verb}:<rank>[@<nth>], "
                f"got {text!r}")
        try:
            nth = int(parts[2]) if len(parts) == 3 else 1
            if nth < 0:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"{ENV_VAR}: {verb} nth must be >= 0, got {text!r}") \
                from None
        action = "crash" if verb == "replica_crash" else "io_error"
        return cls(point="serve_forward", rank=rank, action=action, nth=nth)


_lock = threading.Lock()
_spec: Optional[FaultSpec] = None
_counts: Dict[str, int] = {}
_fired = False


def _load_env() -> None:
    global _spec
    text = os.environ.get(ENV_VAR)
    if text:
        _spec = FaultSpec.parse(text)


_load_env()


def armed() -> bool:
    """True when a fault directive is armed (env at import, or :func:`arm`).

    Callers on hot paths should cache ``fire`` only when this is True —
    the unarmed fast path then never enters this module at all."""
    return _spec is not None


def spec() -> Optional[FaultSpec]:
    return _spec


def arm(text_or_spec) -> FaultSpec:
    """Arm a fault programmatically (tests); resets the nth-counters."""
    global _spec, _fired
    s = (text_or_spec if isinstance(text_or_spec, FaultSpec)
         else FaultSpec.parse(text_or_spec))
    with _lock:
        _spec = s
        _counts.clear()
        _fired = False
    return s


def disarm() -> None:
    global _spec, _fired
    with _lock:
        _spec = None
        _counts.clear()
        _fired = False


def fired() -> bool:
    """True once the armed fault has executed (tests assert determinism)."""
    return _fired


def fire(point: str, rank: int,
         sever: Optional[Callable[[], None]] = None) -> None:
    """Arrive at a named fault point; executes the armed action when this
    is the spec'd (point, rank) and the spec'd nth arrival.

    ``sever`` is the caller-supplied connection killer for ``econnreset``
    (the socket lives behind the native library, so only the caller can
    reach it); a point with no sever degrades to a logged no-op rather
    than a surprise crash."""
    global _fired
    s = _spec
    if s is None or s.point != point or s.rank != rank:
        return
    with _lock:
        n = _counts.get(point, 0) + 1
        _counts[point] = n
        if s.nth == 0:
            _fired = True           # persistent: every arrival executes
        else:
            if n != s.nth or _fired:
                return
            _fired = True
    log.warning("fault injection: %s at %s (rank %d, arrival %d)",
                s.action, point, rank, n)
    if s.action == "crash":
        # Unclean death, bypassing atexit/finally — the honest simulation
        # of a SIGKILL'd / OOM'd worker.  Flush what the test harness may
        # be tailing first.
        import sys
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:  # noqa: BLE001 - exiting anyway
            pass
        os._exit(_EXIT_CODE)
    elif s.action == "hang":
        time.sleep(_HANG_S)
    elif s.action == "delay_ms":
        time.sleep(s.arg / 1000.0)
    elif s.action == "econnreset":
        if sever is None:
            log.warning("fault injection: econnreset at %s has no sever "
                        "callback; ignoring", point)
        else:
            sever()
    elif s.action == "io_error":
        # Raised INTO the caller: the state plane's chunk writer (and any
        # future I/O fault point) sees exactly what a failing filesystem
        # would hand it — an OSError from the write path.
        raise OSError(f"injected I/O fault at {point} (HVD_TPU_FAULT)")


# --------------------------------------------------------------- churn verbs
# Scheduled CHURN events: where the fault points above inject a
# single failure at a protocol point, a churn SCRIPT replays membership
# change — clean LEAVEs, join epochs, agent death, preemption notices —
# against a running control plane.  The script grammar is round-gated like
# the fault points' nth gate::
#
#     HVD_TPU_CHURN=<verb>:<target>@<round>[,<verb>:<target>@<round>...]
#
#     verb    leave           the target RANK sends a protocol-v6 clean
#                             LEAVE in place of its round frame and departs
#             join            the target RANK (or ``*`` = every live rank)
#                             announces the join protocol ("\x1f__join__"),
#                             flushing the response-cache slot table — the
#                             heavyweight control-plane churn event
#             agent_crash     the target HOST's per-host agent is killed
#                             abruptly (survivable only once its ranks have
#                             left; otherwise a host-granular typed abort)
#             preempt_notice  the target HOST receives a preemption notice:
#                             the runner drains it — every live rank of the
#                             host leaves cleanly (the driver's DRAIN →
#                             clean LEAVE path, compressed to the wire)
#     target  a rank id (leave/join), ``*`` (join: all live ranks), or a
#             host index (agent_crash/preempt_notice)
#     round   the 1-based negotiation round the event fires BEFORE —
#             events at round N are applied once the fleet has completed
#             N-1 measured rounds, so a ``leave`` is the target's round-N
#             frame (deterministic, like the fault points' nth gate)
#
# The scripts are replayed by :class:`horovod_tpu.testing.churn.ChurnRunner`
# against the REAL native server, flat or hierarchical.

#     verb    rejoin_restore  the target RANK — which must
#                             have departed in an earlier event — rejoins
#                             the STATE plane as a fresh replacement: its
#                             state plane is reset and restored from the
#                             survivors' shard servers (peer path) or the
#                             shared manifest directory (disk fallback);
#                             the runner records the restore source
#                             ("peer"/"disk"), epoch and disk-read count
#                             in the phase/event output so scenarios can
#                             assert WHICH path recovery took
CHURN_ENV_VAR = "HVD_TPU_CHURN"
CHURN_VERBS = ("leave", "join", "agent_crash", "preempt_notice",
               "rejoin_restore")
_HOST_VERBS = ("agent_crash", "preempt_notice")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One parsed churn-script event."""
    verb: str
    target: str     # rank id, "*" (join only), or host index
    at_round: int   # fires before this 1-based measured round

    @classmethod
    def parse(cls, text: str) -> "ChurnEvent":
        head, sep, round_s = text.strip().partition("@")
        if not sep:
            raise ValueError(
                f"{CHURN_ENV_VAR}: event must be <verb>:<target>@<round>, "
                f"got {text!r}")
        parts = head.split(":")
        if len(parts) != 2:
            raise ValueError(
                f"{CHURN_ENV_VAR}: event must be <verb>:<target>@<round>, "
                f"got {text!r}")
        verb, target = parts[0].strip(), parts[1].strip()
        if verb not in CHURN_VERBS:
            raise ValueError(
                f"{CHURN_ENV_VAR}: unknown churn verb {verb!r} "
                f"(valid: {', '.join(CHURN_VERBS)})")
        if target == "*":
            if verb != "join":
                raise ValueError(
                    f"{CHURN_ENV_VAR}: target '*' is only valid for join, "
                    f"got {text!r}")
        else:
            try:
                if int(target) < 0:
                    raise ValueError
            except ValueError:
                raise ValueError(
                    f"{CHURN_ENV_VAR}: target must be a non-negative "
                    f"{'host index' if verb in _HOST_VERBS else 'rank'} "
                    f"or '*', got {text!r}") from None
        try:
            at_round = int(round_s)
        except ValueError:
            raise ValueError(
                f"{CHURN_ENV_VAR}: round must be an integer, got "
                f"{text!r}") from None
        if at_round < 1:
            raise ValueError(
                f"{CHURN_ENV_VAR}: round must be >= 1, got {text!r}")
        return cls(verb=verb, target=target, at_round=at_round)


def parse_churn(text: str):
    """Parse a full churn script (comma-separated events) into a list of
    :class:`ChurnEvent`, ordered by firing round (stable for ties — the
    written order breaks them, so ``leave:1@5,join:*@5`` leaves first)."""
    events = [ChurnEvent.parse(p) for p in (text or "").split(",")
              if p.strip()]
    return sorted(events, key=lambda e: e.at_round)
