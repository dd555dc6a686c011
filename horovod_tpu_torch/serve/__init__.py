"""Data-parallel serving plane of the port (``docs/serving.md``).

Port of ``horovod_tpu/serve/__init__.py``: the batcher, front door and
circuit breaker are copies of the JAX package's framework-free modules;
:class:`Replica` runs the model with PyTorch.
"""

from .batcher import (  # noqa: F401
    Batch, Cancelled, ContinuousBatcher, DeadlineExceeded, Draining,
    ForwardFailed, QueueFull, ReplicaFaulted, Request, RequestQuarantined,
    Retryable, parse_buckets,
)
from .frontdoor import FrontDoor  # noqa: F401
from .replica import Replica  # noqa: F401
from .resilience import CircuitBreaker  # noqa: F401
