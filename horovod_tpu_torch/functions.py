"""Parameter and optimizer-state broadcast.

Port of ``horovod_tpu/jax/optimizer.py:900-922`` and of the torch binding's
``horovod_tpu/torch/functions.py:17-90`` (reference:
``horovod/torch/functions.py``).  ``broadcast_parameters`` takes a tree of
dicts, lists and tuples with tensor leaves (the port's Llama parameters), a
``state_dict``, an ``nn.Module`` (through its ``state_dict``, whose tensors
share storage with the module) or an iterable of ``(name, tensor)`` pairs.
``broadcast_optimizer_state`` takes a ``torch.optim.Optimizer``, through its
``state_dict``, or a tree.

Before ``init()`` both return at once.  Otherwise every tensor is broadcast
from ``root_rank`` in place through the collective engine: all of them are
submitted at once, named ``broadcast.<path>``, so that one negotiation
round covers them and the engine fuses them into buffers cut at the fusion
threshold, one broadcast each (in a world of one process the broadcast is
the identity, the pack and unpack still run).  The non-tensor values of a
``state_dict`` ride one ``broadcast_object`` and are written back.  An
optimizer's state is sent as root's structure first, so a rank whose
optimizer holds no state yet (no step taken) receives root's.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from . import mpi_ops
from .common import basics
from .common.process_sets import ProcessSet
from .ops import eager

# A tensor of root's optimizer state, as its structure is sent.
_TensorSpec = collections.namedtuple("_TensorSpec", "shape dtype on_cpu")


def _leaves(tree, path=()):
    """``(path, leaf)`` for every leaf of a dict/list/tuple tree: dict keys
    as strings, list and tuple positions as ints, so that paths sort."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _active_set(process_set: Optional[ProcessSet]) -> Optional[ProcessSet]:
    """The set to broadcast over, or None where there is nothing to do (no
    runtime yet, or a rank outside the set)."""
    if not basics.is_initialized():
        return None
    ps = process_set if process_set is not None else \
        basics.global_process_set
    return ps if ps.included(basics.rank()) else None


def _broadcast_tensors(tree, root_rank: int, ps: ProcessSet) -> None:
    """Broadcast every tensor leaf in place, submitted together in sorted
    path order."""
    named = [(".".join(map(str, path)), t)
             for path, t in sorted(_leaves(tree), key=lambda kv: kv[0])
             if isinstance(t, torch.Tensor)]
    if not named:
        return
    eager.synchronize(eager.broadcast_many_async(
        [t for _, t in named], [f"broadcast.{n}" for n, _ in named],
        root_rank=root_rank, process_set=ps, inplace=True))


def broadcast_parameters(params, root_rank: int = 0,
                         process_set: Optional[ProcessSet] = None):
    """Synchronize parameters from ``root_rank`` to every rank of
    ``process_set`` (the global set by default).  Tensors are overwritten
    in place on the receiving ranks; ``params`` itself is returned."""
    ps = _active_set(process_set)
    if ps is None:
        return params
    module = params if isinstance(params, torch.nn.Module) else None
    tree = params.state_dict() if module is not None else params
    top = tree if isinstance(tree, dict) else {}
    if not isinstance(tree, (dict, list, tuple)):
        tree = dict(tree)      # (name, tensor) pairs: nothing to write into
    elif isinstance(tree, (list, tuple)) and tree and all(
            isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
            and isinstance(x[1], torch.Tensor) for x in tree):
        tree = dict(tree)      # a list of (name, tensor) pairs
    extras = {k: v for k, v in top.items()
              if not isinstance(v, (torch.Tensor, dict, list, tuple))}
    stray = sorted(".".join(map(str, path)) for path, x in _leaves(tree)
                   if not isinstance(x, torch.Tensor)
                   and not (len(path) == 1 and path[0] in map(str, extras)))
    if stray:
        raise ValueError(
            f"broadcast_parameters got non-tensor entries {stray}; only the "
            f"top-level values of a state_dict may be other objects")
    _broadcast_tensors(tree, root_rank, ps)
    if extras:
        top.update(eager.broadcast_object(extras, root_rank,
                                          process_set=ps))
        if module is not None:
            module.load_state_dict(top)
    return params


def _spec(x):
    if isinstance(x, torch.Tensor):
        return _TensorSpec(tuple(x.shape), x.dtype, x.device.type == "cpu")
    if isinstance(x, dict):
        return {k: _spec(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_spec(v) for v in x)
    return x


def _materialize(x):
    if isinstance(x, _TensorSpec):
        return torch.empty(x.shape, dtype=x.dtype,
                           device="cpu" if x.on_cpu else basics.device())
    if isinstance(x, dict):
        return {k: _materialize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_materialize(v) for v in x)
    return x


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set: Optional[ProcessSet] = None):
    """Broadcast an optimizer's full state from ``root_rank`` (reference:
    ``horovod/torch/functions.py broadcast_optimizer_state``).

    A ``torch.optim.Optimizer`` goes through its ``state_dict``: root's
    structure and non-tensor values (hyperparameters, step counts) as one
    object, then every state tensor in place, then ``load_state_dict`` on
    the other ranks.  Anything else is a tree for
    :func:`broadcast_parameters`.  Returns ``optimizer``."""
    if not isinstance(optimizer, torch.optim.Optimizer):
        return broadcast_parameters(optimizer, root_rank=root_rank,
                                    process_set=process_set)
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    ps = _active_set(process_set)
    if ps is None:
        return optimizer
    is_root = basics.rank() == root_rank
    state = optimizer.state_dict() if is_root else None
    spec = eager.broadcast_object(_spec(state) if is_root else None,
                                  root_rank, process_set=ps)
    if not is_root:
        state = _materialize(spec)
    _broadcast_tensors(state, root_rank, ps)
    if not is_root:
        optimizer.load_state_dict(state)
    return optimizer


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None):
    """Broadcast a picklable object from ``root_rank``; a pass-through to
    ``mpi_ops.broadcast_object``, as ``horovod_tpu/torch/functions.py:88-90``
    is."""
    return mpi_ops.broadcast_object(obj, root_rank=root_rank, name=name,
                                    process_set=process_set)
