"""``import horovod_tpu_torch as hvd`` — the PyTorch/CUDA port.

A second implementation of ``horovod_tpu`` in PyTorch, for NVIDIA H100
cards, one card per process.  It imports neither JAX nor ``horovod_tpu``;
the JAX package is the reference its tests hold it against.  So far the
port covers the serving path (runtime control, parameter broadcast, the
Llama decoder with its flash-attention forward kernel, and ``serve``), the
training path (``DistributedOptimizer`` over the allreduce family of
``mpi_ops``, and Llama training through the flash-attention backward
kernels), the collective engine under both (negotiation through the
copied coordinator, fusion, and one collective per fused buffer between
the pack and unpack kernels), the rest of the collectives a world above
one rank uses (allgather, alltoall, reducescatter, join) with
``SyncBatchNorm``, the launcher, ``python -m horovod_tpu_torch.runner``,
and the ZeRO-sharded optimizer (``DistributedOptimizer(sharded=True)`` and
``sharded="full"``) with its saveables, and elastic training
(``hvd.elastic``: the elastic driver behind ``--host-discovery-script``,
``TorchState``, ``@hvd.elastic.run``, the state plane's sharded
checkpoints and peer restore).
"""

from .common.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    device, add_process_set, remove_process_set, process_set_included,
    NotInitializedError, cross_rank, cross_size, is_homogeneous, nccl_built,
    gloo_enabled, mpi_enabled, mpi_threads_supported, cuda_built, rocm_built,
    start_timeline, stop_timeline, start_profile, stop_profile, profile_step,
)
from .common.process_sets import ProcessSet, global_process_set  # noqa: F401
from .compression import Compression  # noqa: F401
from .functions import (  # noqa: F401
    broadcast_parameters, broadcast_optimizer_state,
)
from .mpi_ops import (  # noqa: F401
    ReduceOp, Average, Sum, Min, Max, Product, Adasum,
    allreduce, allreduce_, allreduce_async, allreduce_async_,
    grouped_allreduce, grouped_allreduce_, grouped_allreduce_async,
    grouped_allreduce_async_, allgather, allgather_async, grouped_allgather,
    grouped_allgather_async, allgather_object, broadcast, broadcast_,
    broadcast_async, broadcast_async_, broadcast_object, alltoall,
    alltoall_async, reducescatter, reducescatter_async,
    grouped_reducescatter, grouped_reducescatter_async, barrier, join,
    synchronize, poll,
)
from .optimizer import (  # noqa: F401
    DistributedOptimizer, is_sharded_saveable, load_sharded_saveable,
)
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
from . import elastic  # noqa: F401
from . import serve  # noqa: F401
