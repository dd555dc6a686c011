"""Parameter and optimizer-state broadcast.

Port of ``horovod_tpu/jax/optimizer.py:900-922`` (reference:
``horovod/torch/functions.py``).  In a world of one process the params
are returned unchanged.  Otherwise every tensor is broadcast from
``root_rank`` with ``torch.distributed.broadcast``, in place, one call per
tensor, in the sorted order of the tensors' paths so that every rank issues
the same calls in the same order.  This direct broadcast stands in until
the collective engine (negotiation and fusion) is ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import basics
from .common.process_sets import ProcessSet


def _leaves(tree, path=()):
    """``(path, tensor)`` for every tensor of a dict/list/tuple tree."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"{i:08d}",))


def broadcast_parameters(params, root_rank: int = 0,
                         process_set: Optional[ProcessSet] = None):
    """Synchronize a parameter tree from ``root_rank`` to every rank of
    ``process_set`` (the global set by default).  Tensors are overwritten
    in place on the receiving ranks; the tree itself is returned."""
    if not basics.is_initialized() or basics.size() == 1:
        return params
    import torch.distributed as dist
    ps = process_set if process_set is not None else \
        basics.global_process_set
    if not ps.included(basics.rank()):
        return params
    for _, t in sorted(_leaves(params), key=lambda kv: kv[0]):
        if not t.is_contiguous():
            raise ValueError("broadcast_parameters needs contiguous tensors")
        dist.broadcast(t, src=root_rank, group=ps.group)
    return params


def broadcast_optimizer_state(opt_state, root_rank: int = 0,
                              process_set: Optional[ProcessSet] = None):
    """Reference: ``horovod/torch/functions.py broadcast_optimizer_state``."""
    return broadcast_parameters(opt_state, root_rank=root_rank,
                                process_set=process_set)
