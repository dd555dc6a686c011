# Ported from horovod_tpu/tensorflow/mpi_ops.py:1-189: the collective surface
# over the port's engine; TF tensors reach it as torch tensors through DLPack
# in place of the host-numpy bridge (horovod_tpu/ops/bridge.py, :36-38).
"""TensorFlow binding: collective op surface over the port's engine.

Parity with the reference's TF op layer (``horovod/tensorflow/mpi_ops.py``
backed by ``horovod/tensorflow/mpi_ops.cc`` — SURVEY.md §2a N27, §2b P4):
``allreduce`` / ``grouped_allreduce`` / ``allgather`` / ``broadcast`` /
``alltoall`` / ``reducescatter`` over ``tf.Tensor``/``tf.Variable`` inputs.

There is no TF custom-kernel shim: a TF tensor (a ``tf.Variable`` read
through ``.value()``) is handed to the port's collective engine
(``ops/eager.py`` → ``ops/engine.py``) as a torch tensor through DLPack
(``tf.experimental.dlpack.to_dlpack`` → ``torch.from_dlpack``), so
negotiation, fusion, the pack and unpack kernels and one NCCL (or gloo)
collective per fused buffer apply as they do to the torch binding.  The
result returns to TF the same way, on the input's device, in the input's
dtype (a promoted result, such as a bool ``Sum``'s int32, is cast back).
What the way there and back costs:

- a TF tensor on the engine's card: nothing but the hand-over, both ways
  (DLPack shares the buffer; the engine reads it where it lies and the
  result is a new card buffer TF takes over);
- a TF tensor on the host (TF kept off the card, or an int32 tensor, which
  TF keeps in host memory even for a GPU op): one host-to-card copy of
  the input from pageable memory in the engine's staging (``eager._item``)
  and one card-to-host copy of the result;
- in a CPU world (``init(device="cpu")``): no copy at all.

Two dtypes take a detour: a bool tensor crosses as uint8 (some DLPack
versions refuse bool), and an int32 tensor is read through ``.numpy()``
(host memory already).  bfloat16 arrives as ``torch.bfloat16``.

The reference's synchronous TF op semantics are preserved (TF has no
``*_async`` handles).  Graph mode: ops raise a clear error under
``tf.function`` tracing unless wrapped — :func:`graph_safe` wraps the eager
implementation in ``tf.py_function``, so compiled Keras ``fit`` loops still
negotiate out-of-graph at step-execution time; such a body runs on a TF
thread, and its submissions enter the engine from there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import tensorflow as tf
import torch
import torch.utils.dlpack

from ..common import basics
from ..common.process_sets import ProcessSet
from ..ops import collectives as C
from ..ops import eager

ReduceOp = C.ReduceOp
Average = C.ReduceOp.AVERAGE
Sum = C.ReduceOp.SUM
Min = C.ReduceOp.MIN
Max = C.ReduceOp.MAX
Product = C.ReduceOp.PRODUCT
Adasum = C.Adasum

rank = basics.rank
size = basics.size
local_rank = basics.local_rank
local_size = basics.local_size

_TORCH_DTYPE = {
    tf.float16: torch.float16, tf.bfloat16: torch.bfloat16,
    tf.float32: torch.float32, tf.float64: torch.float64,
    tf.int8: torch.int8, tf.int16: torch.int16, tf.int32: torch.int32,
    tf.int64: torch.int64, tf.uint8: torch.uint8, tf.bool: torch.bool,
    tf.complex64: torch.complex64, tf.complex128: torch.complex128,
}


def _torch_dtype(dtype: tf.DType) -> torch.dtype:
    try:
        return _TORCH_DTYPE[tf.as_dtype(dtype)]
    except KeyError:
        raise TypeError(f"the TF binding has no torch counterpart for "
                        f"{tf.as_dtype(dtype).name}") from None


def _to_torch(tensor) -> Tuple[torch.Tensor, tf.DType]:
    """``tensor`` (a TF tensor or variable, a numpy array or a Python
    value) as a torch tensor, and the caller's dtype: the TF dtype when
    given a TF tensor or variable, otherwise the array's own (never a
    silent float32)."""
    if isinstance(tensor, tf.Variable):
        tensor = tensor.value()
    if not tf.is_tensor(tensor):
        a = np.ascontiguousarray(np.asarray(tensor))
        return torch.from_numpy(a), tf.as_dtype(a.dtype)
    tensor = tf.convert_to_tensor(tensor)   # a Keras variable's value
    dtype = tf.as_dtype(tensor.dtype)
    _torch_dtype(dtype)
    if dtype == tf.int32:
        return torch.from_numpy(np.ascontiguousarray(tensor.numpy())), dtype
    if dtype == tf.bool:
        t = tf.cast(tensor, tf.uint8)
        return torch.from_dlpack(tf.experimental.dlpack.to_dlpack(t)) \
            .bool(), dtype
    return torch.from_dlpack(tf.experimental.dlpack.to_dlpack(tensor)), dtype


def _to_tf(t: torch.Tensor, dtype: tf.DType) -> tf.Tensor:
    """A torch result as a TF tensor of ``dtype`` on the tensor's device."""
    want = _torch_dtype(dtype)
    t = t.detach()
    if want == torch.bool:
        u = t.to(torch.bool).to(torch.uint8).contiguous()
        return tf.cast(tf.experimental.dlpack.from_dlpack(
            torch.utils.dlpack.to_dlpack(u)), tf.bool)
    t = t.to(want).contiguous()
    return tf.experimental.dlpack.from_dlpack(torch.utils.dlpack.to_dlpack(t))


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, tf.Variable):
        t = t.value()
    return t.numpy() if tf.is_tensor(t) else np.asarray(t)


def _check_eager(what: str):
    if not tf.executing_eagerly():
        raise RuntimeError(
            f"hvd.{what} was called inside a tf.function trace; collective "
            f"negotiation is out-of-graph.  Wrap the call with "
            f"horovod_tpu_torch.tensorflow.graph_safe(...) or run the step "
            f"eagerly (run_eagerly=True)")


def _world(process_set: Optional[ProcessSet]) -> int:
    return process_set.size() if process_set is not None else basics.size()


def allreduce(tensor, name: Optional[str] = None, op: ReduceOp = Average,
              prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None,
              compression=None,
              process_set: Optional[ProcessSet] = None) -> tf.Tensor:
    _check_eager("allreduce")
    from .compression import Compression
    compression = compression or Compression.none
    t, dtype = _to_torch(tensor)
    comp, ctx = compression.compress(t)
    out = eager.allreduce(comp, name=name, op=op,
                          prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor,
                          process_set=process_set)
    res = compression.decompress(out, ctx)
    return _to_tf(res.reshape(t.shape), dtype)


def grouped_allreduce(tensors: Sequence, name: Optional[str] = None,
                      op: ReduceOp = Average,
                      process_set: Optional[ProcessSet] = None
                      ) -> List[tf.Tensor]:
    _check_eager("grouped_allreduce")
    ins = [_to_torch(t) for t in tensors]
    outs = eager.grouped_allreduce([t for t, _ in ins], name=name, op=op,
                                   process_set=process_set)
    return [_to_tf(o.reshape(t.shape), dt)
            for o, (t, dt) in zip(outs, ins)]


def allgather(tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> tf.Tensor:
    _check_eager("allgather")
    t, dtype = _to_torch(tensor)
    out = eager.allgather(t, name=name, process_set=process_set)
    return _to_tf(out, dtype)


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> tf.Tensor:
    _check_eager("broadcast")
    t, dtype = _to_torch(tensor)
    out = eager.broadcast(t, root_rank=root_rank, name=name,
                          process_set=process_set)
    return _to_tf(out.reshape(t.shape), dtype)


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None):
    """Even splits: the gathered tensor.  With ``splits``: returns
    ``(output, received_splits)`` (ragged form, same as the torch
    binding)."""
    _check_eager("alltoall")
    t, dtype = _to_torch(tensor)
    world = _world(process_set)
    if splits is None:
        if t.dim() == 0 or t.shape[0] % world != 0:
            raise ValueError(
                f"alltoall with even splits needs dim0 divisible by the "
                f"process set size ({world}); got {tuple(t.shape)}")
        out = eager.alltoall(t, name=name, process_set=process_set)
        return _to_tf(out, dtype)
    sp = _to_numpy(splits).astype(np.int64).reshape(-1)
    out, rsp = eager.alltoall(t, splits=sp.tolist(), name=name,
                              process_set=process_set)
    return _to_tf(out, dtype), tf.constant(rsp.numpy())


def reducescatter(tensor, name: Optional[str] = None, op: ReduceOp = Sum,
                  process_set: Optional[ProcessSet] = None) -> tf.Tensor:
    _check_eager("reducescatter")
    t, dtype = _to_torch(tensor)
    world = _world(process_set)
    if t.dim() == 0 or t.shape[0] % world != 0:
        raise ValueError(
            f"reducescatter needs dim0 divisible by the process set size "
            f"({world}); got {tuple(t.shape)}")
    out = eager.reducescatter(t, name=name, op=op, process_set=process_set)
    return _to_tf(out, dtype)


def graph_safe(fn, output_dtype: tf.DType = tf.float32):
    """Wrap an eager collective call for use inside ``tf.function``.

    Executes ``fn`` as a ``tf.py_function`` at step-execution time — the
    out-of-graph negotiation the reference ran from a TF custom kernel's
    ``ComputeAsync`` (N27) happens in the py_function body here.
    """
    def wrapped(*args):
        def call(*np_args):
            return fn(*np_args)
        return tf.py_function(call, list(args), output_dtype)
    return wrapped


barrier = eager.barrier
join = eager.join
broadcast_object = eager.broadcast_object
allgather_object = eager.allgather_object
