"""Replica: the model-running half of the serving plane.

Port of ``horovod_tpu/serve/replica.py``.  One :class:`Replica` per
process-set member, with the same three responsibilities:

- **Weight fan-out** — :meth:`load` broadcasts a parameter tree from the
  root rank (:func:`~..functions.broadcast_parameters`) and stamps a
  version; re-delivering the version already serving (``version <=
  self.version``) is a no-op, which makes "push weights, retry on any
  failure" safe.
- **Bucketed forward** — :meth:`forward` and :meth:`forward_batch` pad a
  ragged batch up to its bucket, run the bucket's forward and slice the
  real rows back.  The forward per bucket is cached in a
  :class:`~..ops.scheduler.FusedProgramCache` under the JAX package's key
  ``("serve_forward", bucket, sample_shape, dtype)``.  PyTorch runs
  eagerly, so the cached forward is a plain callable and not a compiled
  program; the cache's counters still show one build per bucket.
- **Serve loop** — :meth:`serve_loop` consumes the batcher, routes each
  batch's results (or its failure) back to its callers, and resolves a
  failure against the peer-fault verdict as the JAX replica does.

``apply_fn(params, inputs)`` takes a tensor batch on the replica's device
and returns a tensor (or array) whose first dim is the batch.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..common import basics
from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..common.process_sets import ProcessSet
from ..functions import broadcast_parameters
from ..ops.scheduler import FusedProgramCache
from ..testing import faults as _faults
from ..utils.logging import get_logger

log = get_logger()


class Replica:
    """One serving replica: versioned weights + per-bucket forward."""

    def __init__(self, apply_fn: Callable, process_set:
                 Optional[ProcessSet] = None, cache_capacity: int = 64,
                 device=None):
        self._apply = apply_fn            # (params, inputs[b, ...]) -> out
        self.process_set = process_set
        self.device = torch.device(device) if device is not None else None
        self.params = None
        self.version = -1                 # nothing loaded yet
        self.loads = 0                    # broadcasts actually executed
        self.cache = FusedProgramCache(capacity=cache_capacity)

    def _device(self) -> torch.device:
        if self.device is not None:
            return self.device
        return basics.device()

    # ------------------------------------------------------------- weights
    def load(self, params, version: int = 0, root_rank: int = 0):
        """Fan ``params`` from ``root_rank`` onto every replica and stamp
        ``version``.  No-op (returns False) when ``version`` does not
        advance."""
        version = int(version)
        if version <= self.version:
            log.debug("serve: load(version=%d) <= serving version %d — "
                      "no-op", version, self.version)
            return False
        self.params = broadcast_parameters(
            params, root_rank=root_rank, process_set=self.process_set)
        self.version = version
        self.loads += 1
        log.info("serve: weights version %d broadcast from rank %d "
                 "(load #%d)", version, root_rank, self.loads)
        return True

    # ------------------------------------------------------------- forward
    def _program(self, bucket: int, sample_shape: tuple, dtype):
        """The per-bucket forward, cached under the JAX replica's key."""
        key = ("serve_forward", int(bucket), tuple(sample_shape),
               str(dtype))
        fn, _hit = self.cache.get_or_build2(key, lambda: self._apply)
        return fn

    def _run(self, x: np.ndarray, bucket: int, n: int) -> np.ndarray:
        if bucket > n:
            pad = np.zeros((bucket - n,) + x.shape[1:], dtype=x.dtype)
            x = np.concatenate([x, pad], axis=0)
        fn = self._program(bucket, x.shape[1:], x.dtype)
        with torch.no_grad():
            out = fn(self.params, torch.from_numpy(x).to(self._device()))
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        return np.asarray(out)[:n]

    def forward(self, inputs) -> np.ndarray:
        """Run one padded-bucket batch; returns the REAL rows only.

        ``inputs``: array of shape ``[n, *sample]`` — rows are padded with
        zeros up to the next power of two."""
        if self.version < 0:
            raise RuntimeError("serve: forward before load() — no weights")
        x = np.asarray(inputs)
        n = x.shape[0]
        return self._run(x, self._bucket_for(n), n)

    def _bucket_for(self, n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return b

    def _rank(self) -> int:
        return basics.rank() if basics.is_initialized() else 0

    def forward_batch(self, batch) -> np.ndarray:
        """Batcher-aware forward: pad to the BATCHER's bucket (its menu,
        not the local power-of-two fallback) and slice to real rows."""
        if _faults.armed():
            # Serving chaos verbs fire here, once per batch, mid-batch.
            _faults.fire("serve_forward", self._rank())
        x = np.stack([np.asarray(r.inputs) for r in batch.requests])
        return self._run(x, batch.bucket, x.shape[0])

    # ---------------------------------------------------------- serve loop
    def _peer_fault_verdict(self, exc):
        """Resolve one forward failure: a typed control-plane error IS the
        verdict.  The port has no collective engine yet, so there is no
        fault latch to poll (the JAX replica's ``fault_grace_s`` wait) and
        any other failure is an application error in one forward."""
        if isinstance(exc, (HorovodInternalError, HostsUpdatedInterrupt)):
            return exc
        return None

    def serve_loop(self, batcher, stop: Optional[threading.Event] = None,
                   poll_s: float = 0.05) -> int:
        """Consume ``batcher`` until ``stop`` is set AND the queue drained
        (or the batcher is draining and empty).  Returns batches served.

        Per-batch APPLICATION errors are routed to the waiting callers
        (``batcher.fail`` — retryable until quarantined), not raised.  A
        PEER FAULT mid-batch fails the interrupted batch retryably, leaves
        queued requests untouched with their original deadlines, and
        re-raises the typed error for the caller to re-rendezvous."""
        served = 0
        while True:
            if stop is not None and stop.is_set() and batcher.pending() == 0:
                return served
            batch = batcher.next_batch(timeout=poll_s)
            if batch is None:
                if batcher.draining and batcher.pending() == 0:
                    return served
                continue
            try:
                results = self.forward_batch(batch)
            except Exception as exc:  # noqa: BLE001 - resolved below
                verdict = self._peer_fault_verdict(exc)
                if verdict is not None:
                    log.warning(
                        "serve: peer fault mid-batch (%s) — %d request(s) "
                        "failed retryably, %d queued preserved; "
                        "re-rendezvous required",
                        type(verdict).__name__, batch.size,
                        batcher.pending() - 1)
                    batcher.fail_retryable(batch, verdict)
                    raise verdict from exc
                batcher.fail(batch, exc)
                continue
            batcher.complete(batch, list(results))
            served += 1
