# Ported from horovod_tpu/models/moe.py:322-338 (lm_sync_grads), with
# horovod_tpu/models/llama.py:586-623 (sync_grads) and
# horovod_tpu/models/dlrm.py:154-167 (sync_grads), the spec-gated gradient
# sums, and horovod_tpu/parallel/spmd.py:52-57 (shard_params) for leaves
# split along dim 0.
"""Expert parallelism's gradient rule and parameter broadcast.

A model with expert parallelism (``models/moe.py``, ``models/dlrm.py``,
Llama's MoE MLP) holds two kinds of leaves.  Its ``param_specs(cfg)`` says
which, as a tree shaped like the parameters whose leaves are the mesh axis
a leaf is split over along dim 0 (``"ep"``: an expert slab, a block of
embedding tables) or None (replicated: router, embeddings, attention,
norms, MLPs).  That tree is the one place this module reads.

The JAX package's step differentiates a partial loss (this rank's share of
the global mean) under ``shard_map`` and sums the gradients: every leaf
over dp, replicated leaves over ep too, sharded leaves never over ep,
because their cotangents already arrived from every ep rank through the
all-to-all's transpose.  Here each rank's loss is the mean over its own
tokens and ``hvd.DistributedOptimizer`` averages, so:

- **replicated leaves** go to ``DistributedOptimizer`` as before, which
  averages them over the whole world (dp × ep ranks);
- **sharded leaves** go to an optimizer of their own, held by
  :class:`ExpertParallel`.  Their gradient sums the ``ep`` ranks' mean
  losses' cotangents, ``ep`` times the gradient of the global mean over
  those ranks, so :meth:`ExpertParallel.sync_grads` scales it by ``1/ep``
  and then averages it over the ranks that hold the same slab (the same
  ``ep`` coordinate, a process set), never over ``ep``.

Parameters start alike by :meth:`ExpertParallel.broadcast_parameters`:
the replicated leaves from a root over the world, each slab from the first
rank of its own process set, so that no rank's slab is overwritten by
another coordinate's.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import mpi_ops
from ..common import basics
from ..functions import _leaves, broadcast_parameters as _broadcast
from .mesh import ProcessMesh

Named = List[Tuple[str, torch.Tensor]]


def spec_of(specs) -> Dict[str, Optional[str]]:
    """``{"layers.0.moe.w1": "ep", ...}``: every leaf's dotted name (as
    ``models/llama.py`` ``named_parameters`` spells it) and its axis."""
    return {".".join(map(str, path)): s for path, s in _leaves(specs)}


def split_named(named: Iterable[Tuple[str, torch.Tensor]], specs,
                axis: str = "ep") -> Tuple[Named, Named]:
    """``(replicated, sharded)``: the ``(name, tensor)`` pairs whose spec is
    not ``axis``, and those whose spec is, each in the given order."""
    by_name = spec_of(specs)
    replicated, sharded = [], []
    for name, t in named:
        if name not in by_name:
            raise KeyError(f"{name!r} has no spec in the model's param_specs")
        (sharded if by_name[name] == axis else replicated).append((name, t))
    return replicated, sharded


def _block(x, index: int, size: int):
    if x.shape[0] % size:
        raise ValueError(f"a leaf of {x.shape[0]} rows along its sharded "
                         f"dim does not divide over {size} ranks")
    c = x.shape[0] // size
    return x[index * c:(index + 1) * c]


def shard_tree(tree, specs, index: int, size: int, axis: str = "ep"):
    """``tree`` (a full parameter tree: tensors or numpy arrays) with every
    leaf whose spec is ``axis`` cut along dim 0 to block ``index`` of
    ``size`` (``shard_map``'s slicing of ``P(axis)``).  A sharded tensor
    leaf becomes a fresh copy, so that the full one can be freed; other
    leaves are the tree's own."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], index, size, axis)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, index, size, axis)
                          for v, s in zip(tree, specs))
    if specs != axis:
        return tree
    out = _block(tree, index, size)
    if isinstance(out, torch.Tensor):
        return out.detach().clone().requires_grad_(tree.requires_grad)
    return np.ascontiguousarray(out)


class ExpertParallel:
    """The gradient rule and the broadcast for the leaves split over
    ``ep_axis`` of ``mesh``, and the optimizer that steps them.

    Construction registers, on every rank and in one order, one process
    set a coordinate of ``ep_axis``: the ranks that hold that coordinate's
    slab (a collective, like the mesh's own).  With ``ep`` = 1 every rank
    holds every slab (the global set); with ``ep`` = the world no rank
    shares one (no set).  :meth:`shutdown` removes them.

    ``optimizer`` (a torch optimizer over the sharded leaves only, never a
    ``DistributedOptimizer``) is stepped by :meth:`step` after
    :meth:`sync_grads`."""

    def __init__(self, mesh: Optional[ProcessMesh],
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 ep_axis: str = "ep"):
        self.optimizer = optimizer
        self.axis = ep_axis
        if mesh is None or ep_axis not in mesh.axis_names:
            self.ep, self.index, self.peers = 1, 0, None
            world = basics.size() if basics.is_initialized() else 1
            if world > 1:
                self.peers = basics.global_process_set
            self._added = []
            return
        self.ep, self.index = mesh.size(ep_axis), mesh.index(ep_axis)
        sizes = list(mesh.shape.values())
        world = int(np.prod(sizes))
        grid = np.arange(world).reshape(sizes)
        d = mesh.axis_names.index(ep_axis)
        holders = [sorted(int(r) for r in np.take(grid, i, axis=d).ravel())
                   for i in range(self.ep)]
        self._added = []
        self.peers = None
        if len(holders[0]) == world:
            self.peers = basics.global_process_set
        elif len(holders[0]) > 1:
            for i, ranks in enumerate(holders):
                ps = basics.add_process_set(ranks)
                self._added.append(ps)
                if i == self.index:
                    self.peers = ps

    @property
    def params(self) -> List[torch.Tensor]:
        if self.optimizer is None:
            return []
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def sync_grads(self, tensors: Optional[Sequence[torch.Tensor]] = None,
                   name: str = "expert") -> None:
        """The rule, in place on each tensor's ``.grad`` (the optimizer's
        parameters by default): times ``1/ep``, then the average over the
        ranks that hold the same slab.  A leaf no token reached this step
        takes a zero gradient, so that every holder submits the same
        tensors."""
        tensors = list(self.params if tensors is None else tensors)
        for t in tensors:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        grads = [t.grad for t in tensors]
        if not grads:
            return
        if self.ep > 1:
            # Each ep rank's mean loss sent its cotangent through the
            # all-to-all's backward: the slab's gradient is ep times that
            # of the global mean over the ep ranks.
            torch._foreach_mul_(grads, 1.0 / self.ep)
        if self.peers is not None and self.peers.size() > 1:
            mpi_ops.grouped_allreduce_(grads, name=f"{name}.grads",
                                       op=mpi_ops.Average,
                                       process_set=self.peers)

    def zero_grad(self) -> None:
        if self.optimizer is not None:
            self.optimizer.zero_grad()

    def step(self) -> None:
        """:meth:`sync_grads`, then the optimizer's step."""
        if self.optimizer is None:
            return
        self.sync_grads()
        self.optimizer.step()

    def broadcast_parameters(self, named: Iterable[Tuple[str, torch.Tensor]],
                             specs, root_rank: int = 0) -> None:
        """Start every rank alike: the replicated leaves of ``named`` from
        ``root_rank`` over the world, each sharded leaf from the first rank
        of the process set that holds its slab (``root_rank`` must hold
        coordinate 0's).  No slab crosses an ``ep`` coordinate."""
        replicated, sharded = split_named(named, specs, self.axis)
        _broadcast(replicated, root_rank=root_rank)
        if sharded and self.peers is not None:
            _broadcast(sharded, root_rank=0, process_set=self.peers)

    def shutdown(self) -> None:
        """Remove the process sets this object registered."""
        added, self._added = self._added, []
        for ps in added:
            basics.remove_process_set(ps)
