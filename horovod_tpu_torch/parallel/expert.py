# Ported from horovod_tpu/models/moe.py:322-338 (lm_sync_grads), with
# horovod_tpu/models/llama.py:586-623, bert.py:197-209 and dlrm.py:154-167
# (sync_grads), the spec-gated gradient sums, and
# horovod_tpu/parallel/spmd.py:52-57 (shard_params), shard_map's slicing of
# a PartitionSpec.
"""The gradient rule and the parameter broadcast for leaves split over mesh
axes.

A model whose leaves are split over mesh axes names them in its
``param_specs(cfg)``: a tree shaped like the parameters whose leaves are
None (replicated), an axis name (split along dim 0: ``"ep"`` for an expert
slab or a block of embedding tables, as in ``models/moe.py`` and
``models/dlrm.py``) or a :class:`Split` with the dimension (tensor
parallelism: ``Split("tp", 1)`` for a column-split weight, the JAX ``P(None,
tp)``; ``Split("tp", 0)`` for a row-split weight or a split bias, ``P(tp,
None)`` and ``P(tp)``).  That tree is the one place this module reads.

The JAX package's step differentiates a partial loss (this rank's share of
the global mean) under ``shard_map`` and sums the gradients: every leaf over
dp and sp, replicated leaves over tp and ep too, a split leaf never over
its own axis, whose cotangent already arrived whole (tp: through the
transpose of the row-split product's psum) or from every ep rank (through
the all-to-all's transpose).  Here each rank's loss is the mean over its
own tokens, the tp ranks run Megatron's ``f``/``g`` pair
(``parallel/mesh.py``), and ``hvd.DistributedOptimizer`` averages, so:

- **replicated leaves** go to ``DistributedOptimizer`` as before, which
  averages them over the whole world (the tp ranks hold equal gradients of
  equal losses, so that is the average over the data ranks);
- **split leaves** go to an optimizer of their own, held by
  :class:`ShardedParallel`.  A leaf split over an axis is averaged over the
  ranks that hold the same block: those that share this rank's coordinate
  on that axis (a process set it registers).  Where the axis is a **data**
  axis (dp, sp, ep: each rank there has other tokens), the leaf's gradient
  sums that axis's ranks' mean losses' cotangents, ``size`` times the
  gradient of their global mean, so it is scaled by ``1/size`` first; a tp
  shard's gradient is already exact for this rank's loss and is not, nor
  is a pipeline stage's slab (pp is not a data axis: every stage sees the
  same tokens).

:class:`ExpertParallel` is the case of leaves split over ep.  At tp = 2 a
tp shard has the same shape on both ranks: handed to
``DistributedOptimizer`` by mistake, nothing raises and different columns
are averaged together.  :func:`refuse_world_averaged`, which the models'
``make_train_step`` calls at the first step, refuses that.

Parameters start alike by :meth:`ShardedParallel.broadcast_parameters`:
the replicated leaves from a root over the world, each block from the
first rank of its holders' set, so that no rank's block is overwritten by
another coordinate's.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import mpi_ops
from ..common import basics
from ..functions import _leaves, broadcast_parameters as _broadcast
from .mesh import DP, EP, SP, ProcessMesh

Named = List[Tuple[str, torch.Tensor]]
# The axes over which ranks hold other tokens: a leaf split over one sums
# that axis's ranks' mean losses' cotangents.
DATA_AXES = (DP, SP, EP)


@dataclasses.dataclass(frozen=True)
class Split:
    """A spec leaf: the leaf is cut into contiguous blocks along ``dim``,
    block ``i`` on coordinate ``i`` of mesh axis ``axis``."""
    axis: str
    dim: int = 0


@dataclasses.dataclass(frozen=True)
class Splits:
    """A spec leaf split over several mesh axes, each along its own
    dimension: ``Splits((Split("pp", 0), Split("tp", 2)))`` is the JAX
    ``P(pp, None, tp)``."""
    parts: Tuple[Split, ...]


def splits_of(spec) -> Tuple[Split, ...]:
    """Every :class:`Split` of a spec leaf: none for a replicated leaf,
    one for an axis name or a :class:`Split`, the parts of a
    :class:`Splits`."""
    if spec is None:
        return ()
    if isinstance(spec, Splits):
        return tuple(spec.parts)
    return (spec if isinstance(spec, Split) else Split(str(spec), 0),)


def split_of(spec) -> Optional[Split]:
    """A spec leaf of one axis as a :class:`Split` (an axis name alone
    splits dim 0), None for a replicated leaf; a :class:`Splits` of
    several axes raises (read it with :func:`splits_of`)."""
    parts = splits_of(spec)
    if len(parts) > 1:
        raise ValueError(f"{spec} splits over several axes; read it with "
                         f"splits_of")
    return parts[0] if parts else None


def _axes_of_spec(spec) -> Tuple[str, ...]:
    return tuple(sorted(p.axis for p in splits_of(spec)))


def spec_of(specs) -> Dict[str, object]:
    """``{"layers.0.moe.w1": "ep", ...}``: every leaf's dotted name (as
    ``models/llama.py`` ``named_parameters`` spells it) and its spec."""
    return {".".join(map(str, path)): s for path, s in _leaves(specs)}


def split_named(named: Iterable[Tuple[str, torch.Tensor]], specs,
                axis: Union[str, Iterable[str]] = "ep"
                ) -> Tuple[Named, Named]:
    """``(replicated, sharded)``: the ``(name, tensor)`` pairs whose spec
    splits them over ``axis`` (an axis name, or several: ``("tp", "ep")``)
    are sharded, the others replicated, each in the given order."""
    axes = {axis} if isinstance(axis, str) else set(axis)
    by_name = spec_of(specs)
    replicated, sharded = [], []
    for name, t in named:
        if name not in by_name:
            raise KeyError(f"{name!r} has no spec in the model's param_specs")
        (sharded if axes.intersection(_axes_of_spec(by_name[name]))
         else replicated).append((name, t))
    return replicated, sharded


def _block(x, index: int, size: int, dim: int):
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"a leaf of {n} along its sharded dim {dim} does "
                         f"not divide over {size} ranks")
    c = n // size
    cut = (slice(None),) * dim + (slice(index * c, (index + 1) * c),)
    return x[cut]


def shard_tree(tree, specs, index: int, size: int, axis: str = "ep"):
    """``tree`` (a full parameter tree: tensors or numpy arrays) with every
    leaf whose spec splits it over ``axis`` cut along its dim to block
    ``index`` of ``size`` (``shard_map``'s slicing of a PartitionSpec).  A
    cut tensor leaf becomes a fresh contiguous copy, so that the full one
    can be freed; other leaves are the tree's own."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], index, size, axis)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, index, size, axis)
                          for v, s in zip(tree, specs))
    dims = [p.dim for p in splits_of(specs) if p.axis == axis]
    if not dims:
        return tree
    out = _block(tree, index, size, dims[0])
    if isinstance(out, torch.Tensor):
        return out.detach().clone(memory_format=torch.contiguous_format
                                  ).requires_grad_(tree.requires_grad)
    return np.ascontiguousarray(out)


def _live(mesh: Optional[ProcessMesh], axes: Iterable[str]) -> Tuple:
    """The axes among ``axes`` that ``mesh`` has at a size above 1."""
    if mesh is None:
        return ()
    return tuple(a for a in axes
                 if a in mesh.axis_names and mesh.size(a) > 1)


def shard_on_mesh(tree, specs, mesh: Optional[ProcessMesh],
                  axes: Optional[Iterable[str]] = None):
    """``tree`` cut to this rank's block along every axis of ``mesh`` of a
    size above 1 (those among ``axes`` only, when given); the tree itself
    where no such axis is left."""
    if mesh is None:
        return tree
    for ax in _live(mesh, mesh.axis_names if axes is None else axes):
        tree = shard_tree(tree, specs, mesh.index(ax), mesh.size(ax), ax)
    return tree


def refuse_world_averaged(optimizer, params, specs,
                          mesh: Optional[ProcessMesh]) -> None:
    """Raise ``ValueError`` when ``optimizer`` is a
    ``DistributedOptimizer`` (it averages its leaves over the world) and
    steps a leaf of ``params`` that ``specs`` splits over an axis of
    ``mesh`` of a size above 1: that average would mix the blocks of other
    coordinates."""
    if not (hasattr(optimizer, "synchronize")
            or hasattr(optimizer, "gather_params")):  # a torch optimizer
        return
    live = set(_live(mesh, mesh.axis_names)) if mesh is not None else set()
    if not live:
        return
    stepped = {id(p) for g in optimizer.param_groups for p in g["params"]}
    by_name = spec_of(specs)
    bad = []
    for path, t in _leaves(params):
        name = ".".join(map(str, path))
        axes = [a for a in _axes_of_spec(by_name.get(name)) if a in live]
        if id(t) in stepped and axes:
            bad.append(f"{name} ({', '.join(axes)})")
    if bad:
        raise ValueError(
            f"DistributedOptimizer steps {len(bad)} leaves split over the "
            f"mesh ({', '.join(bad[:4])}{', ...' if len(bad) > 4 else ''}): "
            f"it would average other coordinates' blocks together; hand "
            f"them to parallel.ShardedParallel (split_named(named, specs, "
            f"axes) gives the two lists)")


class ShardedParallel:
    """The gradient rule and the broadcast for the leaves split over mesh
    axes, and the optimizer that steps them.

    ``named`` (the split leaves' ``(name, tensor)`` pairs) and ``specs``
    (the model's ``param_specs``) say which axis each leaf is split over.
    Construction registers, on every rank and in one order, one process
    set for each coordinate of each such axis: the ranks that hold that
    coordinate's blocks (a collective, like the mesh's own).  An axis that
    ``mesh`` lacks or has at size 1 splits nothing: its leaves are held by
    every rank.  :meth:`shutdown` removes the sets.

    ``optimizer`` (a torch optimizer over the split leaves only, never a
    ``DistributedOptimizer``) is stepped by :meth:`step` after
    :meth:`sync_grads`.  ``data_axes`` are the axes whose ranks hold other
    tokens (the ``1/size`` factor)."""

    _name = "sharded"

    def __init__(self, mesh: Optional[ProcessMesh],
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 named: Iterable[Tuple[str, torch.Tensor]] = (),
                 specs=None, data_axes: Sequence[str] = DATA_AXES):
        self.optimizer = optimizer
        self._mesh = mesh
        self._data_axes = tuple(data_axes)
        self._added: list = []
        self._sets: Dict[Tuple[int, ...], object] = {}
        by_name = spec_of(specs) if specs is not None else {}
        self._axes: Dict[int, Tuple[str, ...]] = {}
        for name, t in named:
            if name not in by_name:
                raise KeyError(f"{name!r} has no spec in the model's "
                               f"param_specs")
            self._axes[id(t)] = _live(mesh, _axes_of_spec(by_name[name]))
        self._default: Optional[Tuple[str, ...]] = None
        self._groups: Dict[Tuple[str, ...], Tuple[object, float]] = {}
        for axes in sorted(set(self._axes.values())):
            self._register(axes)

    def _register(self, axes: Tuple[str, ...]) -> None:
        """The holders' set and the factor of the leaves split over the
        live ``axes``: process sets for every coordinate, in one order."""
        world = basics.size() if basics.is_initialized() else 1
        scale = 1.0
        peers = basics.global_process_set if world > 1 else None
        if axes:
            mesh = self._mesh
            for a in axes:
                if a in self._data_axes:
                    scale /= mesh.size(a)
            sizes = list(mesh.shape.values())
            grid = np.arange(int(np.prod(sizes))).reshape(sizes)
            dims = [mesh.axis_names.index(a) for a in axes]
            mine = tuple(mesh.index(a) for a in axes)
            peers = None
            for coords in itertools.product(*(range(sizes[d])
                                              for d in dims)):
                cut = [slice(None)] * len(sizes)
                for d, c in zip(dims, coords):
                    cut[d] = c
                ranks = tuple(sorted(int(r)
                                     for r in grid[tuple(cut)].ravel()))
                if len(ranks) == world:
                    ps = basics.global_process_set
                elif len(ranks) > 1:
                    ps = self._sets.get(ranks)
                    if ps is None:
                        ps = self._sets[ranks] = basics.add_process_set(
                            list(ranks))
                        self._added.append(ps)
                else:
                    ps = None
                if coords == mine:
                    peers = ps
        self._groups[axes] = (peers, scale)

    def _axes_of(self, t: torch.Tensor) -> Tuple[str, ...]:
        axes = self._axes.get(id(t), self._default)
        if axes is None:
            raise KeyError("a tensor this ShardedParallel was not given "
                           "(named=) reached its gradient rule")
        return axes

    @property
    def params(self) -> List[torch.Tensor]:
        if self.optimizer is None:
            return []
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def sync_grads(self, tensors: Optional[Sequence[torch.Tensor]] = None,
                   name: Optional[str] = None) -> None:
        """The rule, in place on each tensor's ``.grad`` (the optimizer's
        parameters by default): times the data axes' ``1/size``, then the
        average over the ranks that hold the same block, one grouped
        allreduce a split.  A leaf that no token reached this step takes a
        zero gradient, so that every holder submits the same tensors."""
        name = name or self._name
        tensors = list(self.params if tensors is None else tensors)
        groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for t in tensors:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            groups.setdefault(self._axes_of(t), []).append(t.grad)
        for axes, grads in sorted(groups.items()):
            peers, scale = self._groups[axes]
            if scale != 1.0:
                # Each data rank's mean loss sent its cotangent here: the
                # block's gradient is size times that of their global mean.
                torch._foreach_mul_(grads, scale)
            if peers is not None and peers.size() > 1:
                mpi_ops.grouped_allreduce_(
                    grads, name=f"{name}.{'.'.join(axes) or 'world'}.grads",
                    op=mpi_ops.Average, process_set=peers)

    def zero_grad(self) -> None:
        if self.optimizer is not None:
            self.optimizer.zero_grad()

    def step(self) -> None:
        """:meth:`sync_grads`, then the optimizer's step."""
        if self.optimizer is None:
            return
        self.sync_grads()
        self.optimizer.step()

    def _split(self, named, specs) -> Tuple[Named, Dict[Tuple, Named]]:
        """``(replicated, {axes: split pairs})`` of ``named``."""
        replicated, split = [], {}
        by_name = spec_of(specs)
        for name, t in named:
            axes = self._axes.get(id(t))
            if axes is None:
                axes = _live(self._mesh, _axes_of_spec(by_name[name]))
            if axes:
                split.setdefault(axes, []).append((name, t))
            else:
                replicated.append((name, t))
        return replicated, split

    def broadcast_parameters(self, named: Iterable[Tuple[str, torch.Tensor]],
                             specs, root_rank: int = 0) -> None:
        """Start every rank alike: the replicated leaves of ``named`` from
        ``root_rank`` over the world, each split leaf from the first rank
        of the process set that holds its block (``root_rank`` must hold
        coordinate 0's).  No block crosses a coordinate of its axis."""
        replicated, split = self._split(list(named), specs)
        _broadcast(replicated, root_rank=root_rank)
        for axes, pairs in sorted(split.items()):
            peers = self._groups[axes][0]
            if peers is not None:
                _broadcast(pairs, root_rank=0, process_set=peers)

    def shutdown(self) -> None:
        """Remove the process sets this object registered."""
        added, self._added, self._sets = self._added, [], {}
        for ps in added:
            basics.remove_process_set(ps)


class ExpertParallel(ShardedParallel):
    """:class:`ShardedParallel` for the leaves split over ``ep_axis`` of
    ``mesh``: every parameter of ``optimizer`` is one (an expert slab, a
    block of embedding tables), and ep is the data axis of its ``1/ep``
    factor.  With ``ep`` = 1 every rank holds every slab (the global set);
    with ``ep`` = the world no rank shares one (no set)."""

    _name = "expert"

    def __init__(self, mesh: Optional[ProcessMesh],
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 ep_axis: str = "ep"):
        super().__init__(mesh, optimizer, data_axes=(ep_axis,))
        self.axis = ep_axis
        self._default = _live(mesh, (ep_axis,))
        self._register(self._default)

    def _split(self, named, specs):
        replicated, sharded = split_named(named, specs, self.axis)
        return replicated, ({self._default: sharded} if sharded else {})
