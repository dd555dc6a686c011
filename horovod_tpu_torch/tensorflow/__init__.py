# Ported from horovod_tpu/tensorflow/__init__.py:1-249: _reduce_numpy_list
# (:43-67) over torch tensors as _reduce_tensor_list, the rest over the
# port's engine, runtime and check= hook.
"""TensorFlow binding: ``import horovod_tpu_torch.tensorflow as hvd``.

Parity with the reference's TF API (``horovod/tensorflow/__init__.py`` —
SURVEY.md §2b P4): ``DistributedOptimizer``, ``DistributedGradientTape``,
``broadcast_variables``, the collective op surface, compression, plus the
core ``init/rank/size`` re-exports.  Backed by the port's collective
engine (``ops/engine.py``), as the torch binding is: TF tensors cross to
it as torch tensors through DLPack (``tensorflow/mpi_ops.py``), and the
data plane is NCCL on the card (gloo in a CPU world).

A script runs under the port's launcher as a torch script does::

    python -m horovod_tpu_torch.runner -np 2 python train_tf.py

with ``hvd.init()`` forming the world on ``cuda:<local_rank>``, or
``hvd.init(device="cpu")`` for a CPU world; where ranks share a card, keep
TF off it (``tf.config.set_visible_devices([], "GPU")`` before TF's first
op), since TF reserves most of a card's memory.

Graph mode: gradient reductions inside Keras' compiled ``train_step`` run
as ``tf.py_function`` bodies, so out-of-graph negotiation still happens at
step-execution time (the role the reference's ``xla_mpi_ops.cc`` custom
call played — SURVEY.md N28).
"""

from __future__ import annotations

from typing import Optional

import tensorflow as tf

from ..common.basics import (  # noqa: F401  (re-export, reference parity)
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size, start_timeline, stop_timeline,
    start_profile, stop_profile, profile_step, add_process_set, device,
)
from ..common.process_sets import ProcessSet  # noqa: F401
from ..ops import eager
from .compression import Compression  # noqa: F401
from .mpi_ops import (  # noqa: F401
    Adasum, Average, Max, Min, Product, ReduceOp, Sum,
    allgather, allgather_object, allreduce, alltoall, barrier,
    broadcast, broadcast_object,
    graph_safe, grouped_allreduce, join, reducescatter,
)
from .mpi_ops import _to_tf, _to_torch


def _reduce_tensor_list(tensors, name, op, compression, process_set):
    """Shared eager core: compress → ONE grouped allreduce → decompress.

    Cast-style compressors (fp16/bf16) skip the explicit cast pair: the
    engine casts to the wire dtype in its pack kernel and back in its
    unpack kernel, and results come back in the inputs' own dtype."""
    # Reverse-registration priority (first variable = highest): the grads
    # the next forward pass needs first lead the coordinator cycle.  The
    # variable order is identical across ranks, so the stamps agree.
    prios = [len(tensors) - i for i in range(len(tensors))]
    wire = getattr(compression, "wire_mode", None)
    if wire is not None:
        outs = eager.grouped_allreduce(
            list(tensors), name=name, op=op, process_set=process_set,
            compression=wire, priorities=prios)
        return [o.reshape(t.shape).to(t.dtype)
                for o, t in zip(outs, tensors)]
    comp = [compression.compress(t) for t in tensors]
    outs = eager.grouped_allreduce(
        [c for c, _ in comp], name=name, op=op, process_set=process_set,
        priorities=prios)
    return [compression.decompress(o, ctx).reshape(t.shape)
            for o, (_, ctx), t in zip(outs, comp, tensors)]


def _allreduce_grads(grads, name, op, compression, process_set):
    """Allreduce a (possibly nested, possibly None-holding) gradient
    structure; safe both eagerly and inside a ``tf.function`` trace."""
    flat = tf.nest.flatten(grads)
    idx = [i for i, g in enumerate(flat) if g is not None]
    if not idx:
        return grads
    dense = [tf.convert_to_tensor(flat[i]) for i in idx]

    def _eager_call(*tensors):
        ins = [_to_torch(t) for t in tensors]
        outs = _reduce_tensor_list([t for t, _ in ins], name, op,
                                   compression, process_set)
        return [_to_tf(o, dt) for o, (_, dt) in zip(outs, ins)]

    if tf.executing_eagerly():
        reduced = _eager_call(*dense)
    else:
        # Compiled train step: negotiation is out-of-graph, so it runs in a
        # py_function body at step-execution time (reference N28's role).
        reduced = tf.py_function(
            lambda *ts: _eager_call(*ts), dense, [t.dtype for t in dense])
        if not isinstance(reduced, (list, tuple)):
            reduced = [reduced]
        for r, t in zip(reduced, dense):
            r.set_shape(t.shape)
    out = list(flat)
    for i, r in zip(idx, reduced):
        out[i] = r
    return tf.nest.pack_sequence_as(grads, out)


class _DistributedGradientTape:
    """Wraps ``tf.GradientTape`` so ``gradient()`` returns cross-rank
    averaged gradients (reference: ``hvd.DistributedGradientTape``,
    SURVEY.md §3.5)."""

    def __init__(self, tape: tf.GradientTape, compression=Compression.none,
                 op=Average, process_set: Optional[ProcessSet] = None,
                 name: str = "DistributedGradientTape"):
        self._tape = tape
        self._compression = compression
        self._op = op
        self._process_set = process_set
        self._name = name

    def __getattr__(self, item):
        return getattr(self._tape, item)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        return _allreduce_grads(grads, f"{self._name}.Allreduce", self._op,
                                self._compression, self._process_set)


def DistributedGradientTape(gradtape: tf.GradientTape,
                            compression=Compression.none,
                            op=Average,
                            process_set: Optional[ProcessSet] = None):
    return _DistributedGradientTape(gradtape, compression=compression,
                                    op=op, process_set=process_set)


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         compression=Compression.none, op=Average,
                         backward_passes_per_step: int = 1,
                         process_set: Optional[ProcessSet] = None,
                         check=False):
    """Wrap a Keras optimizer so ``apply_gradients`` averages gradients
    across ranks first (reference: ``hvd.DistributedOptimizer`` for TF).

    ``check=True`` lints the calling script for deadlock-prone collective
    patterns at wrap time (``check="strict"`` raises on errors) — see
    ``horovod_tpu_torch.analysis``.

    Implemented as a dynamic subclass of the optimizer's own class (the
    reference's ``horovod/_keras`` pattern) so Keras ``model.compile``
    type checks still pass.

    ``backward_passes_per_step > 1`` — local gradient aggregation
    (reference: ``horovod/tensorflow/gradient_aggregation_eager.py``):
    gradients accumulate into non-trainable tf.Variables, and only every
    Nth call reduces the accumulated average across ranks and applies it;
    intermediate calls touch no weights and move no bytes, cutting
    communication N×.  N identical micro-batches under bpps=N therefore
    produce exactly one bpps=1 step on the combined batch.
    """
    if check:
        from ..analysis.hooks import run_check_hook
        run_check_hook(check)
    hvd_name = name or f"Distributed{optimizer.__class__.__name__}"

    cls = optimizer.__class__

    class _Distributed(cls):
        _hvd_spec = None

        def _hvd_state(self):
            # Lazy per-instance aggregation state (instances come from
            # from_config, so __init__ customization is off the table).
            if not hasattr(self, "_hvd_agg"):
                self._hvd_agg = {"counter": None, "acc": None}
            return self._hvd_agg

        def _hvd_reduce_apply(self, grads, hvars, args, kwargs):
            spec = type(self)._hvd_spec
            reduced = _allreduce_grads(grads, f"{spec['name']}.Allreduce",
                                       spec["op"], spec["compression"],
                                       spec["process_set"])
            return super().apply_gradients(
                list(zip(reduced, hvars)), *args, **kwargs)

        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            gv = list(grads_and_vars)
            grads = [g for g, _ in gv]
            hvars = [v for _, v in gv]
            spec = type(self)._hvd_spec
            bpps = spec["bpps"]
            if bpps == 1:
                return self._hvd_reduce_apply(grads, hvars, args, kwargs)

            st = self._hvd_state()
            if st["acc"] is None:
                st["counter"] = tf.Variable(0, dtype=tf.int64,
                                            trainable=False,
                                            name=f"{spec['name']}/agg_count")
                st["acc"] = [tf.Variable(tf.zeros_like(v), trainable=False,
                                         name=f"{spec['name']}/agg_{i}")
                             for i, v in enumerate(hvars)]
                # Vars whose grad stayed None the whole window get None at
                # the boundary too (matching bpps=1, which forwards None
                # so e.g. AdamW weight decay skips frozen branches).
                st["seen"] = [False] * len(hvars)
            for i, (a, g) in enumerate(zip(st["acc"], grads)):
                if g is not None:
                    st["seen"][i] = True
                    a.assign_add(tf.cast(g, a.dtype) / float(bpps))
            st["counter"].assign_add(1)

            def _boundary():
                agg = [a.read_value() if st["seen"][i] else None
                       for i, a in enumerate(st["acc"])]
                res = self._hvd_reduce_apply(agg, hvars, args, kwargs)
                for a in st["acc"]:
                    a.assign(tf.zeros_like(a))
                st["seen"] = [False] * len(hvars)
                return res

            if tf.executing_eagerly():
                if int(st["counter"].numpy()) % bpps == 0:
                    return _boundary()
                return None
            # Compiled train step: the skip must be a graph-level cond.
            return tf.cond(
                tf.equal(st["counter"] % bpps, 0),
                lambda: (_boundary(), tf.constant(True))[1],
                lambda: tf.constant(False))

    _Distributed.__name__ = cls.__name__
    _Distributed.__qualname__ = cls.__qualname__
    _Distributed._hvd_spec = dict(name=hvd_name, op=op,
                                  compression=compression,
                                  process_set=process_set,
                                  bpps=int(backward_passes_per_step))
    new_opt = _Distributed.from_config(optimizer.get_config())
    return new_opt


def broadcast_variables(variables, root_rank: int = 0,
                        process_set: Optional[ProcessSet] = None):
    """Assign rank ``root_rank``'s values to every rank's variables
    (reference: ``hvd.broadcast_variables`` — consistent init / restored
    checkpoints across the world): every variable submitted at once, so
    that one negotiation round covers them and the engine fuses them."""
    variables = list(variables)
    if not variables:
        return
    ins = [_to_torch(v) for v in variables]
    outs = eager.synchronize(eager.broadcast_many_async(
        [t for t, _ in ins],
        [f"broadcast_variables.{i}" for i in range(len(ins))],
        root_rank=root_rank, process_set=process_set))
    for v, o, (t, dt) in zip(variables, outs, ins):
        v.assign(_to_tf(o.reshape(t.shape), dt))
