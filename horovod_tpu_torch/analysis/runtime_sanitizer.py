# Copied from horovod_tpu/analysis/runtime_sanitizer.py:1-432 (jax-free; the port keeps its own copy).
"""Opt-in runtime collective sanitizer (``HVD_TPU_SANITIZER=1``).

The dynamic third layer of the analyzer: what the linter and trace checker
cannot see (data-dependent branches, order decided at run time) is caught
here, the way the reference's message-table negotiation catches it — but
with *call-site attribution*.

Mechanism:

- Every entry submitted through the engine (``ops/eager.py`` →
  ``ops/engine.py`` ``enqueue_group``) is recorded in a bounded per-rank
  **ledger**: sequence number, wire name, signature digest, and the user
  call site that issued it (first stack frame outside horovod_tpu_torch).
  The ledger is **namespaced per process set**: sequence numbers count
  within each set, and every entry lands both in the combined stream and
  in a per-set view (``ledgers[ps]``) — so one tenant's divergence is
  reported against ITS submissions (``render_tail(process_set=...)``)
  without another set's interleaved traffic muddying the tail.
- Each entry is stamped with a ``sanitizer_tag``
  (``seq=<process_set>:<i>;site=<f:l>``)
  which the controller sends BESIDE its step-invariant negotiation digest
  (the announce's separate tag field on the full path; the sparse
  slot/tag side-channel next to the bitvector on the response-cache fast
  path — ``common/controller.py _round``).  The rank-0 server folds the
  tag back into its effective-digest comparison, so two ranks submitting
  different collectives — or the same ones in a different order, or from
  different call sites — under one negotiated name produce a mismatch,
  and the existing per-tensor NegotiationError names the divergent ranks
  AND both call sites.  Keeping the tag out of the digest itself means
  the response-cache slot key stays valid across steps: sanitizer runs
  keep the steady-state fast path (docs/performance.md).
- The engine's stall inspector is tightened to
  ``HVD_TPU_SANITIZER_TIMEOUT`` seconds (default 30) and, when a stall
  fires, the report carries the ledger tail so the laggard ranks' last
  submissions (with call sites) are visible next to the stuck tensor.

- **Content-hash mode** (``HVD_TPU_SANITIZER=hash``): additionally folds a
  device→host content digest of each entry's local contribution into the
  tag (``;h=<16hex>``), closing the same-site blind spot — two ranks
  submitting divergent *data* through one call site and sequence (e.g. a
  loop over differently-ordered lists of same-shaped tensors under
  auto-names) match on every structural field, and only the content can
  tell them apart.  The check compares LOCAL contributions across ranks,
  so it is sound exactly where contributions are expected replicated
  (hyperparameters, schedules, reproduction runs with mirrored data);
  ordinary data-parallel gradients legitimately differ per rank and will
  flag — hash mode is a targeted debugging tool, not a production mode
  (docs/analysis.md "content-hash mode").
- With the monitor subsystem on (``HOROVOD_MONITOR=1``), HVD302 stall
  reports also quote the *laggard ranks'* ledger tails, pulled from the
  cross-rank aggregation table (``horovod_tpu_torch.monitor``,
  docs/monitoring.md) — the stalling rank no longer has to ssh into the
  peer's logs to see what it last submitted.

- **Static linkage** (``HVD_TPU_SANITIZER_STATIC_INDEX=file``): the
  whole-package analyzer exports a call-site → call-graph-node map
  (``python -m horovod_tpu_torch.analysis --whole-package --emit-static-index``).
  When set, every ledger line and HVD301/HVD302 report annotates the
  divergent call site with its static node (``mod:fn``, schedule index)
  and, when the static analysis flagged that site, the rule that would
  have caught the divergence before launch — closing the loop between the
  runtime ledger and the static collective schedule.

In the port the entries hold this rank's tensor, where the JAX engine's
hold the rank-stacked array: the digest describes the same per-rank shape
and spells the dtype the JAX way (``float32``, not ``torch.float32``), and
the content hash reads the tensor's bytes (on a CUDA tensor, after a copy
to the host), so a bfloat16 contribution hashes as the JAX one of the
same bits.  Gradient hooks that autograd runs on its own threads have no
user frame on the stack: their site is ``<internal>`` on every rank.

Env vars:
  HVD_TPU_SANITIZER=1          enable (tag mode)
  HVD_TPU_SANITIZER=hash       enable + content-hash the local contribution
  HVD_TPU_SANITIZER_TIMEOUT=s  stall warn threshold (default 30)
  HVD_TPU_SANITIZER_LEDGER=n   ledger capacity (default 512)
  HVD_TPU_SANITIZER_STATIC_INDEX=f  static call-graph index (JSON) to
                               annotate ledger reports with
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import traceback
from typing import Deque, Dict, List, Optional, Sequence

from .findings import is_package_frame
from ..utils.logging import get_logger

log = get_logger()


def mode() -> Optional[str]:
    """``"tag"`` (HVD_TPU_SANITIZER=1), ``"hash"`` (=hash — tag plus a
    device→host content digest of the local contribution), or None."""
    v = os.environ.get("HVD_TPU_SANITIZER", "").strip().lower()
    if v in ("1", "true", "on", "yes"):
        return "tag"
    if v == "hash":
        return "hash"
    return None


def enabled() -> bool:
    return mode() is not None


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    seq: int
    name: str
    digest: str
    site: str
    # Which process set the entry was submitted under (0 = world).  The
    # seq above counts WITHIN this set — the namespace that keeps one
    # tenant's divergence report from perturbing another's stream.
    process_set: int = 0

    def render(self) -> str:
        head = f"#{self.seq}" if self.process_set == 0 \
            else f"#{self.process_set}:{self.seq}"
        return f"{head} {self.name} [{self.digest}] at {self.site}"


def _caller_site() -> str:
    """First stack frame outside the horovod_tpu_torch package — the user call
    that issued the collective (``findings.is_package_frame`` decides what
    counts as package code).  Basename only, so the tag (which rides the
    negotiation digest) matches across ranks with different install
    paths."""
    for frame in reversed(traceback.extract_stack()):
        if not is_package_frame(frame.filename):
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return "<internal>"


class StaticIndex:
    """Call-site → static call-graph node map, produced by
    ``python -m horovod_tpu_torch.analysis --whole-package --emit-static-index``.
    Sites are keyed ``basename:line`` — the same spelling
    :func:`_caller_site` stamps into ledger entries, so lookup is a dict
    hit on the hot path's *reporting* side only (never on submission)."""

    def __init__(self, sites: Dict[str, Dict]):
        self._sites = sites

    @classmethod
    def load(cls, path: str) -> Optional["StaticIndex"]:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                data = json.load(fh)
            return cls(data.get("sites", {}))
        except (OSError, ValueError) as e:
            log.warning("sanitizer: cannot load static index %s: %s",
                        path, e)
            return None

    def annotate(self, site: str) -> str:
        rec = self._sites.get(site)
        if rec is None:
            return ""
        s = f" [static: {rec.get('node', '?')} #{rec.get('index', '?')}"
        ps = rec.get("process_set")
        if ps and ps != "world":
            s += f" over {ps}"
        rules = rec.get("rules")
        if rules:
            s += f"; {'/'.join(rules)} flagged this site statically"
        return s + "]"


def _env_static_index() -> Optional[StaticIndex]:
    path = os.environ.get("HVD_TPU_SANITIZER_STATIC_INDEX", "").strip()
    return StaticIndex.load(path) if path else None


class CollectiveSanitizer:
    """Per-engine ledger recorder + digest tagger."""

    def __init__(self, capacity: int = 512, content_hash: bool = False,
                 static_index: Optional[StaticIndex] = None):
        self.capacity = capacity
        # Static call-graph linkage for reports (StaticIndex docstring).
        self.static_index = static_index if static_index is not None \
            else _env_static_index()
        # HVD_TPU_SANITIZER=hash: fold a content digest of each entry's
        # LOCAL contribution into the tag.  Costs one device→host copy per
        # submission — the documented price of closing the same-site
        # blind spot.
        self.content_hash = content_hash
        self._lock = threading.Lock()
        # Sequence counters are PER PROCESS SET: subgroup collectives are
        # legitimately submitted only by member ranks, so a single global
        # counter would drift on non-members and every later world
        # collective would false-positive.  Within one set, every member
        # submits the same sequence — which is exactly what the tag checks.
        self._seq: dict = collections.defaultdict(int)
        self.ledger: Deque[LedgerEntry] = collections.deque(maxlen=capacity)
        # Per-process-set views of the same stream: a tenant's divergence
        # report can quote ITS submissions only, without another set's
        # interleaved traffic pushing the relevant entries out of the
        # tail.  Each view is bounded like the combined ledger.
        self.ledgers: Dict[int, Deque[LedgerEntry]] = \
            collections.defaultdict(
                lambda: collections.deque(maxlen=capacity))

    # ------------------------------------------------------------- recording
    def observe(self, entries: Sequence, site: Optional[str] = None,
                hash_content: bool = True) -> None:
        """Record and tag freshly built engine entries (pre-negotiation).

        ``hash_content=False`` skips the content digest even in hash mode
        (synthesized join entries: never announced, and their identity
        fill would pointlessly pay the host copy)."""
        site = site or _caller_site()
        hashes = {}
        if self.content_hash and hash_content:
            # Outside the lock: device→host copies can be slow and must
            # not serialize concurrent submitters more than they already
            # do.  Entries are not yet shared with the engine queue here.
            for e in entries:
                hashes[id(e)] = self._content_hash(e)
        with self._lock:
            for e in entries:
                ps = getattr(e, "process_set_id", 0)
                seq = self._seq[ps]
                self._seq[ps] = seq + 1
                digest = self._entry_digest(e)
                tag = f"seq={ps}:{seq};site={site}"
                h = hashes.get(id(e))
                if h is not None:
                    tag += f";h={h}"
                # Stamped onto the entry: the controller ships it beside
                # the digest (full announce tag field / bitvector side-
                # channel) and the server folds it into its mismatch
                # comparison — order/call-site divergence becomes an
                # attributable per-tensor error on either wire path.
                e.sanitizer_tag = tag
                rec = LedgerEntry(seq=seq, name=e.name, digest=digest,
                                  site=site, process_set=ps)
                self.ledger.append(rec)
                self.ledgers[ps].append(rec)

    def rollback(self, entries: Sequence) -> None:
        """Undo :meth:`observe` for entries whose queue push was rejected
        (rank-local duplicate-name error): peers never see them, so their
        seq advances must not stand.  Entries are unwound newest-first;
        if another thread observed in between (non-contiguous counter),
        the unwind stops and a warning notes the possible skew."""
        with self._lock:
            for e in reversed(list(entries)):
                tag = getattr(e, "sanitizer_tag", "")
                try:
                    ps_s, seq_s = tag.split(";", 1)[0][len("seq="):].split(":")
                    ps, seq = int(ps_s), int(seq_s)
                except (ValueError, IndexError):  # pragma: no cover
                    continue
                if self._seq[ps] == seq + 1:
                    self._seq[ps] = seq
                    if self.ledger and self.ledger[-1].seq == seq \
                            and self.ledger[-1].name == e.name:
                        self.ledger.pop()
                    view = self.ledgers.get(ps)
                    if view and view[-1].seq == seq \
                            and view[-1].name == e.name:
                        view.pop()
                else:
                    log.warning(
                        "sanitizer: cannot roll back seq %d:%d for %r "
                        "(concurrent submissions interleaved); cross-rank "
                        "seq tags may skew from here", ps, seq, e.name)
                    break

    def observe_synthesized(self, entry) -> None:
        """Account for an entry synthesized while this rank is JOINED
        (engine._synthesize_join_entry): the peer advanced its counter by
        submitting, so this rank must too, or every post-join collective
        would mismatch on seq.  Synthesized entries are never announced, so
        the tag itself doesn't hit the wire — only the counter matters."""
        self.observe([entry], site="<joined:synthesized>", hash_content=False)

    @staticmethod
    def _content_hash(e) -> Optional[str]:
        """Digest of this rank's LOCAL contribution (the addressable
        shards of a multi-process global array; the whole array in
        single-controller mode).  Returns None when the entry carries no
        tensor (barrier) or the copy fails — the tag then simply omits
        the hash field, and the server compares what both sides sent."""
        t = getattr(e, "tensor", None)
        if t is None:
            return None
        import hashlib
        import torch
        h = hashlib.blake2b(digest_size=8)
        try:
            # The bytes as they lie, row-major: numpy has no bfloat16, and
            # a CUDA tensor has no host view.
            raw = t.detach().reshape(-1).contiguous().view(torch.uint8)
            h.update(raw.cpu().numpy().tobytes())
        except Exception:  # noqa: BLE001 - diagnostics must not kill submit
            return None
        return h.hexdigest()

    @staticmethod
    def _entry_digest(e) -> str:
        t = getattr(e, "tensor", None)
        ct = getattr(e, "ctype", None)
        parts = [getattr(ct, "value", "op")]
        if t is not None:
            # This rank's tensor: its shape is the JAX entry's shape[1:].
            parts += [str(t.dtype).replace("torch.", ""),
                      str(tuple(t.shape))]
        op = getattr(e, "reduce_op", None)
        if op is not None:
            parts.append(op.name)
        return "|".join(parts)

    # ------------------------------------------------------------- reporting
    def tail(self, n: int = 8,
             process_set: Optional[int] = None) -> List[LedgerEntry]:
        """Last ``n`` ledger entries — combined stream by default, one
        process set's view when ``process_set`` is given."""
        with self._lock:
            src = self.ledger if process_set is None \
                else self.ledgers.get(process_set, ())
            return list(src)[-n:]

    def render_tail(self, n: int = 8,
                    process_set: Optional[int] = None) -> str:
        entries = self.tail(n, process_set=process_set)
        scope = "" if process_set is None \
            else f" (process set {process_set})"
        if not entries:
            return f"(collective ledger{scope} empty)"
        idx = self.static_index

        def line(e: LedgerEntry) -> str:
            return e.render() + (idx.annotate(e.site) if idx else "")

        return f"last submissions on this rank{scope}:\n  " + \
            "\n  ".join(line(e) for e in entries)


class SanitizerStallInspector:
    """Drop-in wrapper for the engine's StallInspector: tightened timeout,
    ledger-tail attribution on every stall report (HVD302), laggard rank
    names passed through from negotiation."""

    def __init__(self, inner, sanitizer: CollectiveSanitizer,
                 warn_after_s: float):
        self._inner = inner
        self._sanitizer = sanitizer
        # Installed by the monitor subsystem (horovod_tpu_torch.monitor
        # MonitorAgent): a zero-arg callable returning the PEER ranks'
        # ledger tails from the cross-rank aggregation table, so a stall
        # report shows what the laggard last submitted — not only this
        # rank's own tail (the ROADMAP ledger-exchange item).
        self.peer_ledger_source = None
        # The sanitizer timeout is authoritative in BOTH directions: the
        # README documents HVD_TPU_SANITIZER_TIMEOUT as the stall-report
        # threshold, so raising it past HOROVOD_STALL_CHECK_TIME must work
        # (slow first steps), not silently clamp to the smaller value.
        self._inner.warn_after_s = warn_after_s
        # An explicit HOROVOD_STALL_CHECK_DISABLE wins: the sanitizer then
        # provides ledger/digest checks only, no stall policing.
        if inner.disabled:
            log.info("sanitizer: stall reporting stays OFF "
                     "(HOROVOD_STALL_CHECK_DISABLE is set)")
        # Mirrored so the engine's config reads keep working.
        self.warn_after_s = self._inner.warn_after_s
        self.shutdown_after_s = inner.shutdown_after_s
        self.disabled = inner.disabled

    def progressed(self, name: str):
        """Completion epilogue passthrough (the engine calls this on every
        settle): clears the inner inspector's warned latch so a later
        collective reusing the name warns afresh."""
        self._inner.progressed(name)

    @property
    def stalled(self):
        """Live stall state passthrough (monitor /health export)."""
        return self._inner.stalled

    def _peer_report(self) -> str:
        if self.peer_ledger_source is None:
            return ""
        try:
            report = self.peer_ledger_source()
        except Exception:  # noqa: BLE001 - diagnostics only
            return ""
        return f"\n{report}" if report else ""

    def check(self, waiting, missing_ranks=None):
        before = set(self._inner._warned)
        try:
            self._inner.check(waiting, missing_ranks)
        except RuntimeError as exc:
            raise RuntimeError(
                f"{exc}\nHVD302 sanitizer: {self._sanitizer.render_tail()}"
                f"{self._peer_report()}"
            ) from None
        newly = set(self._inner._warned) - before
        if newly:
            tags = {e.name: getattr(e, "sanitizer_tag", "") for e in waiting}
            for name in sorted(newly):
                site = tags.get(name, "")
                site = site.split("site=", 1)[1] if "site=" in site else "?"
                site = site.split(";", 1)[0]
                if self._sanitizer.static_index is not None:
                    site += self._sanitizer.static_index.annotate(site)
                log.warning(
                    "HVD302 sanitizer: collective %r (submitted at %s) is "
                    "stalled%s; %s%s", name, site,
                    (f" waiting on ranks {missing_ranks[name]}"
                     if missing_ranks and name in missing_ranks else ""),
                    self._sanitizer.render_tail(), self._peer_report())


def maybe_install(engine) -> Optional[CollectiveSanitizer]:
    """Attach a sanitizer to a freshly built CollectiveEngine when the env
    opts in; returns it (or None).  Called from the engine constructor so
    every init()'d runtime — JAX, torch or TF binding — is covered."""
    m = mode()
    if m is None:
        return None
    capacity = int(os.environ.get("HVD_TPU_SANITIZER_LEDGER", "512") or 512)
    timeout = float(os.environ.get("HVD_TPU_SANITIZER_TIMEOUT", "30") or 30)
    sanitizer = CollectiveSanitizer(capacity=capacity,
                                    content_hash=(m == "hash"))
    engine.stall = SanitizerStallInspector(engine.stall, sanitizer, timeout)
    log.info("collective sanitizer enabled (mode=%s, timeout=%.1fs, "
             "ledger=%d)", m, timeout, capacity)
    return sanitizer
