"""``import horovod_tpu_torch as hvd`` — the PyTorch/CUDA port.

A second implementation of ``horovod_tpu`` in PyTorch, for NVIDIA H100
cards, one card per process.  It imports neither JAX nor ``horovod_tpu``;
the JAX package is the reference its tests hold it against.  So far the
port covers the serving path: runtime control, parameter broadcast, the
Llama decoder with its flash-attention forward kernel, and ``serve``.
"""

from .common.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    device, add_process_set, remove_process_set, process_set_included,
    NotInitializedError,
)
from .common.process_sets import ProcessSet, global_process_set  # noqa: F401
from .functions import (  # noqa: F401
    broadcast_parameters, broadcast_optimizer_state,
)
from . import serve  # noqa: F401
