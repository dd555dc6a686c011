# Copied from horovod_tpu/elastic/__init__.py:1-42, with TorchState and
# ElasticSampler (horovod_tpu/torch/elastic/__init__.py) among the lazy names.
"""Elastic training: state commit/restore/sync and the run wrapper.

Parity with the reference's framework-agnostic elastic layer
(``horovod/common/elastic.py`` — SURVEY.md §2b P1, §3.4): a ``State`` object
with ``commit`` (in-memory backup), ``restore`` (rollback after a peer
failure) and ``sync`` (rank-0 broadcast so joiners catch up), plus the
``@hvd.elastic.run`` decorator that catches ``HorovodInternalError`` /
``HostsUpdatedInterrupt``, re-initializes the runtime, and retries.

GPU mapping: a lost host invalidates the NCCL world, so recovery aborts
the generation's communicators and re-runs ``init()`` (a new world, a new
engine) before ``state.sync()``.

Import shape: the driver side (driver, discovery, registration,
rendezvous, the control-flow exceptions) imports without torch's device
runtime; the state objects (``State``/``ObjectState``/``TorchState``/
``run``) and ``ElasticSampler`` load lazily on first attribute access
(PEP 562).
"""

from ..common.exceptions import (  # noqa: F401
    DrainRequested, HorovodInternalError, HostsUpdatedInterrupt,
    PeerLeftInterrupt,
)
from .discovery import (  # noqa: F401
    DiscoveredHost, FixedHostDiscovery, HostDiscovery, HostDiscoveryScript,
)
from .registration import WorkerStateRegistry  # noqa: F401

# Lazily-loaded state layer.
_STATE_ATTRS = ("State", "ObjectState", "TorchState", "run")


def __getattr__(name):
    if name in _STATE_ATTRS:
        from . import state as _state
        return getattr(_state, name)
    if name == "ElasticSampler":
        from .sampler import ElasticSampler
        return ElasticSampler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_STATE_ATTRS) | {"ElasticSampler"})
