# Copied from horovod_tpu/ops/scheduler.py:221-270 (FusedProgramCache only;
# the rest of that module arrives with the engine).
"""Data-plane scheduling primitives (no jax imports).

Only the program cache is here so far.  The serving replica keys its
per-bucket forward into it, and its hit/miss counters show that batch-size
churn builds one forward per bucket and no more.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple


class FusedProgramCache:
    """Compiled fused-collective cache (the data-plane half of the steady-
    state fast path; the control-plane half is the controller's response
    cache).  Keyed on the *shape signature* of the batch (fusion key +
    shapes + dtypes + donation + wire compression + chunk counts — counts,
    never raw chunk byte values, so retuning ``HOROVOD_PIPELINE_CHUNK``
    only recompiles when the resulting chunk plan actually changes).  Hit
    == zero Python planning + zero XLA recompile: dispatch cost is one
    cached-executable launch.
    """

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._cache: Dict[Tuple, Callable] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._cache)

    def get_or_build(self, key: Tuple, builder: Callable[[], Callable]) -> Callable:
        fn, _ = self.get_or_build2(key, builder)
        return fn

    def get_or_build2(self, key: Tuple, builder: Callable[[], Callable]):
        """Returns ``(fn, hit)`` — hit=False means fn will compile on its
        first invocation (callers may scope compile-time-only handling)."""
        if self.capacity <= 0:
            # Caching disabled (HOROVOD_CACHE_CAPACITY=0): build every time.
            self.misses += 1
            return builder(), False
        fn = self._cache.get(key)
        if fn is None:
            self.misses += 1
            fn = builder()
            while len(self._cache) >= self.capacity:
                # LRU eviction (hits reinsert at the end of the dict order):
                # an A/B-alternating working set one entry over capacity
                # must not thrash the way FIFO would.
                self._cache.pop(next(iter(self._cache)))
                self.evictions += 1
            self._cache[key] = fn
            return fn, False
        # LRU touch: move to the end of the insertion order.
        self._cache.pop(key)
        self._cache[key] = fn
        self.hits += 1
        return fn, True

