# Ported from horovod_tpu/parallel/spmd.py:23-139 (infer_specs_like,
# shard_params, make_sharded_train_step with its check= audit :113-138 and
# _spec_axes :60-74).
"""The SPMD harness, eagerly: a per-rank train step over a process mesh.

The JAX package compiles a per-shard step over the mesh with ``shard_map``
and ``jit``: the step takes the global arrays, and ``shard_map`` hands each
device its block of every parameter (by its ``PartitionSpec``) and of the
batch (by ``data_spec``).  Here each process is one rank and runs its step
eagerly.  Its parameters are already its blocks (:func:`shard_params`, the
spec-driven slicing ``parallel/expert.py`` ``shard_on_mesh`` does) and its
optimizer holds them between steps, so :func:`make_sharded_train_step`
cuts only the batch: each array of a step's global batch to this rank's
block along the data axes (``data_axes``, the JAX ``data_spec``:
``(("dp", "ep"), "sp")`` splits dim 0 over dp × ep, dp major, and dim 1
over sp).  At the first call it refuses parameters that are not blocks of
one tree as the specs split it.

``check=True`` audits the step at its first call (``analysis/
trace_check.py``, the JAX ``check=``): it traces the per-rank loss and
gradients, which a model's step carries as ``step.audit`` (the step
itself, with its optimizer's in-place update, cannot be traced whole),
with fake tensors, logs the HVD2xx findings, and with ``check="strict"``
raises on an error finding before any collective moves.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from ..functions import _leaves
from .expert import shard_on_mesh, spec_of, splits_of
from .mesh import DP, EP, SP, ProcessMesh

# The JAX ``P(("dp", "ep"), "sp")``: the batch over dp × ep, the sequence
# over sp.
DATA_SPEC = ((DP, EP), SP)

AxisSpec = Union[None, str, Sequence[str]]


def infer_specs_like(tree, params, param_specs):
    """The specs of an arbitrary tree shaped around the parameters (an
    EMA copy, a state kept per leaf): every subtree with the parameters'
    structure and leaf shapes gets ``param_specs`` whole, everything else
    None (replicated).  Structure and shapes, not shapes alone: two leaves
    of one shape may be split differently."""
    want = [(p, tuple(getattr(t, "shape", ()))) for p, t in _leaves(params)]

    def like(sub) -> bool:
        return [(p, tuple(getattr(t, "shape", ())))
                for p, t in _leaves(sub)] == want

    def walk(sub):
        if like(sub):
            return param_specs
        if isinstance(sub, dict):
            return {k: walk(v) for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return type(sub)(walk(v) for v in sub)
        return None

    return walk(tree)


def shard_params(params, param_specs, mesh: Optional[ProcessMesh]):
    """``params`` (whole) cut to this rank's block of every leaf that
    ``param_specs`` splits over an axis of ``mesh`` of a size above 1 (the
    JAX ``shard_params``' placement; ``parallel.shard_on_mesh``)."""
    return shard_on_mesh(params, param_specs, mesh)


def _axes(entry: AxisSpec):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_batch(x, mesh: Optional[ProcessMesh], data_axes=DATA_SPEC):
    """This rank's block of the global array ``x`` (a tensor or a numpy
    array, returned as the same kind): for each dimension ``d``, the axes
    ``data_axes[d]`` split it, the first major, as ``shard_map`` splits by
    a ``PartitionSpec``.  Axes the mesh lacks are of size 1."""
    for dim, entry in enumerate(data_axes):
        idx, size = 0, 1
        for ax in _axes(entry):
            if mesh is not None and ax in mesh.axis_names:
                idx, size = idx * mesh.size(ax) + mesh.index(ax), \
                    size * mesh.size(ax)
        if size == 1:
            continue
        n = x.shape[dim]
        if n % size:
            raise ValueError(f"dimension {dim} of a batch array ({n}) does "
                             f"not divide over {_axes(entry)} ({size} "
                             f"ranks)")
        c = n // size
        cut = (slice(None),) * dim + (slice(idx * c, (idx + 1) * c),)
        x = x[cut]
    return x


def check_blocks(params, param_specs, mesh: Optional[ProcessMesh]) -> None:
    """Raise ``ValueError`` unless ``params`` are blocks of one tree as
    ``param_specs`` splits it on ``mesh``: every leaf has a spec whose
    split dimensions it has, and every rank holds the same leaves at the
    same shapes (a block is an equal part along each split axis, as
    ``shard_map``'s are; a replicated leaf is whole everywhere), gathered
    over the world with one ``allgather_object``."""
    from .. import mpi_ops
    from ..common import basics
    mine = {".".join(map(str, p)): tuple(t.shape)
            for p, t in _leaves(params) if isinstance(t, torch.Tensor)}
    bad = []
    if param_specs is not None:
        specs = spec_of(param_specs)
        for name, shape in mine.items():
            if name not in specs:
                bad.append(f"{name} has no spec")
                continue
            for part in splits_of(specs[name]):
                if part.dim >= len(shape):
                    bad.append(f"{name} {shape} has no dim {part.dim} to "
                               f"split over {part.axis}")
    if not bad and basics.is_initialized() and basics.size() > 1:
        every = mpi_ops.allgather_object(mine, name="spmd.check_blocks")
        for r, theirs in enumerate(every):
            if theirs != mine:
                diff = sorted(k for k in set(theirs) | set(mine)
                              if theirs.get(k) != mine.get(k))
                bad.append(f"rank {r} holds other leaves or shapes "
                           f"({', '.join(diff[:4])})")
                break
    if bad:
        raise ValueError("make_sharded_train_step: the parameters are not "
                         "blocks of one tree on the mesh (cut them with "
                         "shard_params): " + "; ".join(bad[:4]))


def make_sharded_train_step(step_fn: Callable, mesh: Optional[ProcessMesh],
                            param_specs=None, data_axes=DATA_SPEC,
                            check=False) -> Callable:
    """``step(params, *batch)``: ``step_fn(params, *local)`` with each
    array of the global ``batch`` cut to this rank's block along
    ``data_axes`` (:func:`local_batch`), the eager counterpart of the JAX
    ``shard_map`` + ``jit`` step.  ``step_fn`` is the per-rank step (a
    model's ``make_train_step``: its optimizer holds the parameters, its
    state and the gradient rule).  The first call runs
    :func:`check_blocks` over ``params``.

    ``check=True`` audits the first call's per-rank step (``step_fn.audit``
    where the step carries one, else ``step_fn`` itself) with
    ``trace_check.check_step_fn`` — abstractly, nothing executes — and
    logs any HVD2xx findings; ``check="strict"`` raises ``RuntimeError``
    on an error finding instead (JAX :113-138).  The declared partition
    axes are those ``param_specs`` and ``data_axes`` split over."""
    checked = []

    def step(params, *batch):
        local = [local_batch(b, mesh, data_axes) for b in batch]
        if not checked:
            check_blocks(params, param_specs, mesh)
            if check:
                _audit(getattr(step_fn, "audit", step_fn), params, local,
                       mesh, _spec_axes(param_specs, data_axes), check)
            checked.append(True)
        return step_fn(params, *local)

    return step


def _spec_axes(param_specs, data_axes) -> set:
    """Every mesh axis the specs and the data axes split over: the
    declared partition axes of the trace check's HVD112."""
    axes = set()
    if param_specs is not None:
        for spec in spec_of(param_specs).values():
            axes.update(part.axis for part in splits_of(spec))
    for entry in data_axes or ():
        if isinstance(entry, str):
            axes.add(entry)
        elif entry:
            axes.update(a for a in entry if isinstance(a, str))
    return axes


def _audit(fn, params, local, mesh, declared, check) -> None:
    """The first call's collective audit (JAX :122-136)."""
    from ..analysis import trace_check
    from ..utils.logging import get_logger
    report = trace_check.check_step_fn(
        fn, params, *local, mesh=mesh,
        partition_axes=sorted(declared) if declared else None,
        path="<make_sharded_train_step>")
    errors = [f for f in report.findings if f.is_error]
    if errors and check == "strict":
        raise RuntimeError(
            "make_sharded_train_step(check='strict'): the traced step "
            "failed the collective audit:\n"
            + "\n".join(f.render() for f in errors))
    for f in report.findings:
        get_logger().warning("trace check: %s", f.render())
