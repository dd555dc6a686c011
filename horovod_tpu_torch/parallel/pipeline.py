# Ported from horovod_tpu/parallel/pipeline.py:38-131 (stage_index,
# pipeline_apply, microbatch).
"""Pipeline parallelism: GPipe-style microbatched stages over the mesh's
``pp`` axis.

Each coordinate of the ``pp`` axis holds one stage (a contiguous slab of
layers); activations hop stage to stage over the axis's own group.  With
``S`` stages and ``M`` microbatches the schedule runs ``S + M - 1`` ticks,
and at tick ``t`` stage ``s`` holds microbatch ``m = t - s`` when ``0 <= m
< M``: GPipe's fill, steady state and drain, with the bubble ``(S-1)/(S+M-1)``.
The stage function must preserve the shape of its input.

The JAX package runs the schedule as one ``lax.scan`` inside ``shard_map``
and differentiates it with ``jax.grad``, which transposes every tick on
every stage.  Eager autograd would not: a rotation whose received tensor a
stage never uses (stage 0 never reads the carry; the last stage's send
wraps to stage 0) is never reached in the backward, so that rank would skip
an exchange its peers wait in.  So :func:`pipeline_apply` is one
``autograd.Function`` that runs the schedule itself, in both directions:

- **forward**: tick by tick, each valid tick's stage output built under
  autograd from detached copies of the stage's parameters and of its
  input, and kept; then the hop ``s -> s + 1``
  (``parallel/mesh.py`` :func:`~horovod_tpu_torch.parallel.mesh.send_recv`);
- **backward**: the ticks in reverse, each first the transposed hop
  (``s + 1 -> s``: the cotangent of the activation a stage received goes
  back to the stage that sent it), then ``torch.autograd.backward`` on
  that tick's output with the cotangent received (plus, on the last stage,
  the outputs' own cotangent), which accumulates the parameters' gradients
  and yields the input's cotangent for the next hop.

Every rank calls the hop at every tick in both directions, so the
exchanges run in one order everywhere; a hop carries data only where the
sending stage's tick was valid, which both ends know from the tick.  Unlike
the JAX stage, which computes on bubble ticks and zeroes the result, a
stage here skips its compute on bubble ticks: each stage runs its layers
exactly ``M`` times a step.  Every rank's loss must depend on the returned
outputs (a zero cotangent will do), so that every rank reaches the
backward.

``remat=True`` wraps the stage in ``torch.utils.checkpoint``
(``use_reentrant=False``): a tick keeps its stage input only and recomputes
the stage's forward in its backward.  The recomputation must draw what the
first pass drew: a stage that draws noise makes its generators inside the
stage function from a fixed seed (``models/moe.py`` ``fold_in``), as
checkpointing restores only the global RNG state.

``with_aux=True``: ``fn`` returns ``(y, aux)``, and the call returns
``(outs, aux_total)``, ``aux_total`` the sum of this stage's aux over its
valid ticks (the caller sums the stages' partials).  Its cotangent reaches
each tick's aux, and through the hops the earlier stages whose activations
that aux depends on.

``broadcast_out=True`` sums the outputs over pp with the mesh's
``ReduceOutput``: exact, because every stage but the last holds zeros.
Its backward is the identity, so the last stage takes its own whole
cotangent, the port's convention that each rank's loss is its own mean.

Not carried over: the JAX scan's uniform tick (a stage computing on bubble
ticks) and a 1F1B schedule, which neither package implements.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .mesh import ProcessMesh, ReduceOutput, send_recv


def stage_index(mesh: ProcessMesh, axis: str = "pp") -> int:
    """This rank's stage: its coordinate along ``axis``."""
    return mesh.index(axis)


def _stages(mesh: Optional[ProcessMesh], axis: str):
    """``(S, s)``: one stage without a mesh or without ``axis``."""
    if mesh is None or axis not in mesh.axis_names:
        return 1, 0
    return mesh.size(axis), mesh.index(axis)


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """``[B, ...] -> [n_micro, B // n_micro, ...]`` (B must divide
    evenly)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} "
                         f"microbatches")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def _flatten(tree, out: List):
    """The tensors of a dict/list/tuple tree into ``out``, and a function
    that rebuilds the tree from a list shaped like ``out``."""
    if isinstance(tree, dict):
        parts = {k: _flatten(v, out) for k, v in tree.items()}
        return lambda ls: {k: f(ls) for k, f in parts.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, out) for v in tree]
        kind = type(tree)
        return lambda ls: kind(f(ls) for f in parts)
    if isinstance(tree, torch.Tensor):
        i = len(out)
        out.append(tree)
        return lambda ls: ls[i]
    return lambda ls: tree


class _Schedule:
    """The state of one call: the stage function, the mesh, and each
    valid tick's ``(input, output, aux)`` under autograd until the
    backward has used them."""

    def __init__(self, fn, rebuild, mesh, axis, remat, with_aux, aux_init):
        self.fn, self.rebuild, self.mesh, self.axis = fn, rebuild, mesh, axis
        self.remat, self.with_aux, self.aux_init = remat, with_aux, aux_init

    def _stage(self, tree, x):
        if self.remat:
            from torch.utils.checkpoint import checkpoint
            return checkpoint(self.fn, tree, x, use_reentrant=False)
        return self.fn(tree, x)

    def forward(self, micro_x, leaves, grad: bool):
        mesh, axis = self.mesh, self.axis
        n, s = _stages(mesh, axis)
        m_total = micro_x.shape[0]
        self.shape = (n, s, m_total)
        self.leaves = [p.detach().requires_grad_(grad and p.requires_grad)
                       for p in leaves]
        tree = self.rebuild(self.leaves)
        self.x = micro_x.detach().requires_grad_(
            grad and s == 0 and micro_x.requires_grad)
        self.x_grad = micro_x.requires_grad
        self.like = micro_x[0]
        outs = torch.zeros_like(micro_x)
        aux_total = (torch.zeros((), dtype=torch.float32,
                                 device=micro_x.device)
                     if self.aux_init is None else self.aux_init.detach()
                     .clone())
        self.ticks = {}
        buf = None
        for t in range(m_total + n - 1):
            m = t - s
            y = None
            if 0 <= m < m_total:
                # Under grad mode: a view taken without it (Function's
                # forward runs under no_grad) would not reach self.x.
                with torch.set_grad_enabled(grad):
                    x_in = self.x[m] if s == 0 else \
                        buf.requires_grad_(grad)
                    out = self._stage(tree, x_in)
                y, aux = out if self.with_aux else (out, None)
                if y.shape != self.like.shape:
                    raise ValueError(
                        f"the stage function must preserve its input's "
                        f"shape {tuple(self.like.shape)}, returned "
                        f"{tuple(y.shape)}")
                if grad:
                    self.ticks[t] = (x_in, y, aux)
                if s == n - 1:
                    outs[m] = y.detach()
                if aux is not None:
                    aux_total = aux_total + aux.detach()
            if n == 1:
                continue
            # Stage s sends at its valid ticks; stage s + 1 receives what
            # stage s sent, and uses it at its next tick (the same m).
            buf = send_recv(y.detach() if y is not None else self.like,
                            mesh, axis, send=y is not None,
                            recv=0 <= t - s + 1 < m_total)
        return outs, aux_total

    def backward(self, g_outs, g_aux):
        mesh, axis = self.mesh, self.axis
        n, s, m_total = self.shape
        dx = None                       # the cotangent of the last input
        for t in reversed(range(m_total + n - 1)):
            m = t - s
            # The transposed hop of tick t: stage s + 1 hands back the
            # cotangent of what stage s sent it at tick t.
            dy = None if n == 1 else send_recv(
                dx if dx is not None else self.like, mesh, axis,
                send=dx is not None, recv=0 <= m < m_total, shift=-1)
            dx = None
            if not 0 <= m < m_total:
                continue
            x_in, y, aux = self.ticks.pop(t)
            cot = g_outs[m] if s == n - 1 else dy
            tensors, grads = [], []
            if y.requires_grad:
                tensors.append(y)
                grads.append(cot)
            if aux is not None and aux.requires_grad and g_aux is not None:
                tensors.append(aux)
                grads.append(g_aux.to(aux.dtype).expand_as(aux))
            if tensors:
                torch.autograd.backward(tensors, grads)
            if s > 0:
                dx = x_in.grad if x_in.grad is not None else \
                    torch.zeros_like(x_in)
        grads = [p.grad for p in self.leaves]
        if self.x.requires_grad:
            gx = self.x.grad
        else:
            gx = torch.zeros_like(self.x) if self.x_grad else None
        self.leaves = self.x = None
        return gx, grads


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, micro_x, *leaves):
        ctx.run = run
        return run.forward(micro_x, leaves, grad=True)

    @staticmethod
    def backward(ctx, g_outs, g_aux):
        gx, grads = ctx.run.backward(g_outs, g_aux)
        ctx.run = None
        return (None, gx, *grads)


def pipeline_apply(fn: Callable, stage_params, micro_x: torch.Tensor,
                   mesh: Optional[ProcessMesh], axis: str = "pp",
                   broadcast_out: bool = False, remat: bool = False,
                   with_aux: bool = False,
                   aux_init: Optional[torch.Tensor] = None):
    """Run microbatches through the stage pipeline.

    ``fn(stage_params, x[mb, ...]) -> y[mb, ...]`` (shape-preserving)
    applies this rank's stage; ``stage_params`` is a dict/list tree of its
    tensors.  ``micro_x [M, mb, ...]`` is the microbatched input, read on
    stage 0 only.  Returns ``[M, mb, ...]`` outputs: real on the last
    stage and zeros elsewhere, unless ``broadcast_out``, which hands every
    stage the last stage's (module docstring).  With ``with_aux``, ``fn``
    returns ``(y, aux)`` and the call ``(outs, aux_total)``, this stage's
    aux summed over its valid ticks (``aux_init``'s shape, a float32
    scalar by default).  Every rank of ``axis`` must call it with the same
    ``M``.  Without ``mesh`` or without ``axis`` in it the one stage runs
    the microbatches in turn."""
    leaves: List[torch.Tensor] = []
    rebuild = _flatten(stage_params, leaves)
    run = _Schedule(fn, rebuild, mesh, axis, remat, with_aux, aux_init)
    grad = torch.is_grad_enabled() and (
        micro_x.requires_grad or any(p.requires_grad for p in leaves))
    if grad:
        outs, aux_total = _Pipeline.apply(run, micro_x, *leaves)
    else:
        outs, aux_total = run.forward(micro_x, leaves, grad=False)
    if broadcast_out and _stages(mesh, axis)[0] > 1:
        outs = ReduceOutput.apply(outs, mesh, axis)
    return (outs, aux_total) if with_aux else outs
