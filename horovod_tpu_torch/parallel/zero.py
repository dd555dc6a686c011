# Copied from horovod_tpu/parallel/zero.py:40-72 (shard_info, shard_slice_host,
# unshard_host); the two host helpers also take CPU tensors (numpy has no
# bfloat16).
"""The pad+slice convention of the ZeRO-sharded optimizer.

A leaf of ``n`` elements is flattened, padded with zeros to the next
multiple of ``world`` and sliced into ``world`` even shards of
``(n + pad) // world`` elements; rank ``r`` owns elements
``[r*per, (r+1)*per)`` of the padded buffer.  ``shard_info`` is the one
pure function every rank derives identical boundaries from.  The sharded
``DistributedOptimizer`` (``optimizer.py``, ``sharded=True`` and
``sharded="full"``) slices its shards and lays its reduce-scatter and
allgather buffers out by it.

The JAX module's in-graph ``sharded_optimizer``/``full_sharded_optimizer``
(``horovod_tpu/parallel/zero.py:180-338``) run under ``shard_map`` in
single-controller mode and have no counterpart here: one process is one
rank, and its optimizer is the eager one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def shard_info(n: int, world: int) -> Tuple[int, int]:
    """``(pad, per)`` of the pad+slice convention: a flattened leaf of
    ``n`` elements pads with ``pad`` zeros and splits into ``world`` even
    shards of ``per`` elements.  Pure math — rank-invariant by
    construction."""
    world = max(1, int(world))
    n = int(n)
    pad = (-n) % world
    return pad, (n + pad) // world


def shard_slice_host(arr, rank: int, world: int):
    """Rank ``rank``'s 1/world shard of a host array under the pad+slice
    convention, flattened: a numpy array for a numpy array, a tensor for
    a tensor."""
    if isinstance(arr, torch.Tensor):
        flat = arr.detach().reshape(-1)
        pad, per = shard_info(flat.shape[0], world)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat[rank * per:(rank + 1) * per]
    flat = np.asarray(arr).reshape(-1)
    pad, per = shard_info(flat.shape[0], world)
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    return flat[rank * per:(rank + 1) * per]


def unshard_host(shards, n: int, shape, dtype=None):
    """Reassemble a leaf from its per-rank host shards (inverse of
    :func:`shard_slice_host`): concatenate, drop the pad, reshape.  Tensor
    shards give a tensor (``dtype`` a torch dtype), others a numpy
    array."""
    if shards and all(isinstance(s, torch.Tensor) for s in shards):
        flat = torch.cat([s.detach().reshape(-1) for s in shards])[:n]
        out = flat.reshape(tuple(shape))
        return out.to(dtype) if dtype is not None else out
    flat = np.concatenate([np.asarray(s).reshape(-1) for s in shards])[:n]
    out = flat.reshape(shape)
    return out.astype(dtype) if dtype is not None else out
