# Ported from horovod_tpu/parallel/hierarchical.py: hierarchical_allreduce
# :22-44 and hierarchical_allreduce_minmax :47-81; the two-level broadcast
# and allgather from the JAX engine's _build_hier_broadcast (:2096-2134) and
# _build_hier_allgather (:2204-2222).
"""Two-level collectives over a (cross, local) grid of ranks.

Parity: the reference's ``HOROVOD_HIERARCHICAL_ALLREDUCE`` path in
``horovod/common/ops/nccl_operations.cc`` (SURVEY.md §2a N17, §2c): NCCL
reduce-scatter inside a node, an allreduce across nodes, NCCL allgather
inside the node.  ``local`` is the group of a slice's ranks (a host's GPUs,
on NVLink), ``cross`` the group of the ranks that share a local index
across slices (one a host, on the slow links), which carries 1/local_size
of the flat ring's bytes.

This module issues no collective: :class:`Legs` holds the ones it needs,
each bound by the caller (the engine's cycle thread) to this rank's local
or cross group.  Every function takes and returns flat tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Legs:
    """This rank's two groups and the collectives bound to them.

    ``reduce_scatter(out, inp, op)`` and ``all_gather_local(out, inp)`` run
    over the local group, ``all_reduce(t, op)`` (in place) and
    ``all_gather_cross(out, inp)`` over the cross group; ``op`` is
    ``"sum"``, ``"min"`` or ``"max"``.  ``broadcast_local(t, src)`` and
    ``broadcast_cross(t, src)`` broadcast in place from the group's rank at
    index ``src``."""
    local_size: int
    cross_size: int
    local_index: int
    cross_index: int
    reduce_scatter: Callable
    all_reduce: Callable
    all_gather_local: Callable
    all_gather_cross: Callable
    broadcast_local: Callable
    broadcast_cross: Callable


def _two_level(x: torch.Tensor, op: str, legs: Legs) -> torch.Tensor:
    """RS(local) → AR(cross) → AG(local) of ``x`` flat, padded with zeros
    to a multiple of the local size (the pad is reduced with itself only,
    elementwise, and dropped)."""
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % legs.local_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat.new_empty(flat.numel() // legs.local_size)
    legs.reduce_scatter(shard, flat, op)
    legs.all_reduce(shard, op)
    full = flat.new_empty(flat.numel())
    legs.all_gather_local(full, shard)
    return full[:n].view(x.shape)


def hierarchical_allreduce(x: torch.Tensor, legs: Legs,
                           average: bool = False) -> torch.Tensor:
    """Two-level sum; ``average`` divides by the world in ``x``'s dtype."""
    out = _two_level(x, "sum", legs)
    if average:
        out = out / (legs.local_size * legs.cross_size)
    return out.to(x.dtype)


def hierarchical_allreduce_minmax(x: torch.Tensor, op: str,
                                  legs: Legs) -> torch.Tensor:
    """Two-level ``"min"``/``"max"``.  The JAX function gathers the slice
    and reduces, as XLA has no min/max scatter; NCCL's reduce-scatter takes
    both, and min/max are exact in any order, so the result is bitwise the
    flat one either way."""
    if op not in ("min", "max"):
        raise ValueError(f"op must be 'min' or 'max', got {op!r}")
    return _two_level(x, op, legs)


def hierarchical_allgather(x: torch.Tensor, legs: Legs) -> torch.Tensor:
    """AG(local) then AG(cross): rank order cross-major, local-minor,
    which is the world's order, so the bytes are the flat gather's."""
    flat = x.reshape(-1)
    slice_ = flat.new_empty(legs.local_size * flat.numel())
    legs.all_gather_local(slice_, flat)
    out = flat.new_empty(legs.cross_size * slice_.numel())
    legs.all_gather_cross(out, slice_)
    return out


def hierarchical_broadcast(x: torch.Tensor, root: int,
                           legs: Legs) -> torch.Tensor:
    """Root's ``x`` to every rank, in place: to the rank of each slice
    that shares the root's local index over the cross group, then to the
    rest of each slice over the local group."""
    root_cross, root_local = divmod(root, legs.local_size)
    if legs.local_index == root_local:
        legs.broadcast_cross(x, root_cross)
    legs.broadcast_local(x, root_local)
    return x
