# Ported from horovod_tpu/keras/__init__.py:1-40: the re-exports of the
# port's TF binding, and a check that Keras runs on its TensorFlow backend.
"""Keras binding: ``import horovod_tpu_torch.keras as hvd``.

Parity with the reference's Keras API (``horovod/keras/`` +
``horovod/_keras/`` — SURVEY.md §2b P5): ``DistributedOptimizer`` (shared
with the TF binding — it dynamically subclasses the Keras optimizer class
so ``model.compile`` accepts it), ``broadcast_global_variables``, and the
Keras callbacks (:mod:`horovod_tpu_torch.keras.callbacks`), all over the
port's collective engine.

Works with Keras 3 (``keras.Model.fit``) on its TensorFlow backend:
gradient reductions run as ``tf.py_function`` bodies inside the compiled
train step, so no ``run_eagerly=True`` is required.  Another backend is
refused: under ``KERAS_BACKEND=jax`` Keras would bring JAX into the port.
"""

from __future__ import annotations

import keras

if keras.backend.backend() != "tensorflow":
    raise ImportError(
        f"horovod_tpu_torch.keras needs Keras on its TensorFlow backend; "
        f"this process runs Keras on {keras.backend.backend()!r} (set "
        f"KERAS_BACKEND=tensorflow before Keras is first imported)")

from ..common.basics import (  # noqa: E402,F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size, device,
)
from ..tensorflow import (  # noqa: E402,F401
    Average, Compression, Max, Min, Product, ReduceOp, Sum,
    DistributedOptimizer, allgather, allreduce, broadcast, broadcast_object,
    broadcast_variables,
)
from . import callbacks  # noqa: E402,F401


def broadcast_global_variables(model, root_rank: int = 0):
    """Broadcast a model's (and, when built, its optimizer's) variables
    from ``root_rank`` (reference: ``hvd.keras.broadcast_global_variables``)."""
    variables = list(model.weights)
    opt = getattr(model, "optimizer", None)
    if opt is not None:
        # Keras 3 exposes ``optimizer.variables`` as a property; legacy
        # tf.keras (Keras 2) optimizers expose it as a bound method.
        opt_vars = getattr(opt, "variables", None)
        if callable(opt_vars):
            opt_vars = opt_vars()
        variables += list(opt_vars or [])
    broadcast_variables(variables, root_rank=root_rank)
