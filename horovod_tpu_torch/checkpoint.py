# Ported from horovod_tpu/checkpoint.py: latest_step :41, save :53,
# restore :71, CheckpointManager :106-149 and save_state/restore_state
# :153-172, with torch.save and a two-phase write in place of orbax.
"""Sharded checkpointing to disk.

The JAX package writes a step with orbax, each process its own shards.
Here a step is a directory ``<dir>/step_<N>`` (the JAX names) holding:

- ``tree.pt``: the tree's replicated part, written by rank 0 — tensors as
  host tensors, an ``nn.Module`` or ``torch.optim.Optimizer`` as its
  ``state_dict()``;
- ``<key>.shard_<r>_of_<W>.pt``: for each top-level value that is a
  ``DistributedOptimizer(sharded=...)``, rank r's own state
  (``state_dict()``: its 1/W shards), one file a rank;
- ``manifest.json``: the step, the world and the sharded keys, written by
  rank 0 after ``tree.pt``.

Every file is written to ``<file>.tmp``, flushed, fsync'ed and renamed, so
no reader sees half a file, and a step counts (``latest_step``) only when
its manifest and every file it names are there: a step cut off part-way is
never restored.  ``CheckpointManager`` keeps the last N steps.

Surface:
    save(dir, tree, step)          — sharded save
    restore(dir, template, step)   — restore (onto the template's devices)
    latest_step(dir)               — newest complete step on disk, or None
    CheckpointManager              — keep-last-N + save-interval policy
    save_state / restore_state     — elastic ``State`` integration: durable
                                     commit/resume for TorchState-style
                                     objects
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_TREE = "tree.pt"
_MANIFEST = "manifest.json"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}")


def _shard_file(key: str, rank: int, world: int) -> str:
    return f"{key}.shard_{rank}_of_{world}.pt"


def _world():
    from .common import basics
    if basics.is_initialized():
        return basics.rank(), basics.size()
    return 0, 1


def _write(path: str, dump) -> None:
    """Two-phase file write: ``path.tmp`` → flush + fsync → rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        dump(fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _manifest(path: str) -> Optional[dict]:
    """The step's manifest when the step is complete, else None."""
    try:
        with open(os.path.join(path, _MANIFEST)) as fh:
            man = json.load(fh)
    except (OSError, ValueError):
        return None
    names = [_TREE] + [_shard_file(k, r, man["world"])
                       for k in man["sharded"] for r in range(man["world"])]
    if all(os.path.exists(os.path.join(path, n)) for n in names):
        return man
    return None


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := _STEP_RE.match(d)))


def latest_step(directory: str) -> Optional[int]:
    steps = [s for s in _steps(directory)
             if _manifest(_step_dir(directory, s)) is not None]
    return max(steps) if steps else None


def _is_sharded_opt(v) -> bool:
    return hasattr(v, "hvd_sharded_saveable")


def _plain(v):
    """A tree value as it is written: host tensors, state dicts."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    if isinstance(v, (torch.nn.Module, torch.optim.Optimizer)):
        return _plain(v.state_dict())
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def save(directory: str, tree: Any, step: int = 0, force: bool = True):
    """Save a tree (tensors, modules, optimizers, scalars) as checkpoint
    ``step``.

    Multi-process: every rank calls this; rank 0 writes the replicated
    part, and every rank its own shards of each sharded optimizer (no
    gather, no copy of another rank's state)."""
    rank, world = _world()
    path = _step_dir(directory, step)
    if not force and _manifest(path) is not None:
        raise FileExistsError(f"checkpoint {path!r} exists (force=False)")
    os.makedirs(path, exist_ok=True)
    sharded = sorted(k for k, v in tree.items()
                     if _is_sharded_opt(v)) if isinstance(tree, dict) else []
    for k in sharded:
        sd = tree[k].state_dict()
        _write(os.path.join(path, _shard_file(k, rank, world)),
               lambda fh, sd=sd: torch.save(sd, fh))
    if rank != 0:
        return
    rest = ({k: _plain(v) for k, v in tree.items() if k not in sharded}
            if isinstance(tree, dict) else _plain(tree))
    _write(os.path.join(path, _TREE), lambda fh: torch.save(rest, fh))
    _write(os.path.join(path, _MANIFEST), lambda fh: fh.write(json.dumps(
        {"step": step, "world": world, "sharded": sharded}).encode()))


def restore(directory: str, template: Any = None,
            step: Optional[int] = None) -> Any:
    """Restore a checkpoint.  ``template`` (e.g. the freshly-initialized
    state) places it: a tensor of the template gives its leaf's device and
    dtype, a module or optimizer of the template is loaded and returned.
    A sharded optimizer's state loads only in a world of the size that
    saved it (each rank its own file)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {directory!r}")
    path = _step_dir(directory, step)
    man = _manifest(path)
    if man is None:
        raise FileNotFoundError(f"checkpoint {path!r} is incomplete")
    tree = torch.load(os.path.join(path, _TREE), weights_only=False)
    if man["sharded"]:
        rank, world = _world()
        if world != man["world"]:
            raise ValueError(
                f"checkpoint {path!r} holds sharded optimizer state of "
                f"{man['world']} ranks; this world has {world}")
        for k in man["sharded"]:
            tree[k] = torch.load(os.path.join(
                path, _shard_file(k, rank, world)), weights_only=False)
    if template is not None:
        tree = _onto(template, tree)
    return tree


def _onto(template, value):
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(value).to(template.device, template.dtype)
    if isinstance(template, (torch.nn.Module, torch.optim.Optimizer)) or \
            _is_sharded_opt(template):
        template.load_state_dict(value)
        return template
    if isinstance(template, dict) and isinstance(value, dict):
        return {k: (_onto(template[k], v) if k in template else v)
                for k, v in value.items()}
    if isinstance(template, (list, tuple)) and isinstance(
            value, (list, tuple)) and len(template) == len(value):
        return type(value)(_onto(t, v) for t, v in zip(template, value))
    return value


class CheckpointManager:
    """Keep-last-N + interval policy.

    Example::

        mgr = CheckpointManager(dir, max_to_keep=3, save_interval_steps=100)
        for step in ...:
            mgr.save(step, {"params": params, "opt": opt})
        state = mgr.restore(template)
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(directory, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step % self.save_interval_steps == 0

    def save(self, step: int, tree: Any, force: bool = False) -> bool:
        if not force and not self.should_save(step):
            return False
        save(self.directory, tree, step)
        self._gc()
        return True

    def restore(self, template: Any = None, step: Optional[int] = None):
        return restore(self.directory, template, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def all_steps(self):
        return _steps(self.directory)

    def _gc(self):
        if _world()[0] != 0:
            return
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)


# ------------------------------------------------------- elastic integration
def save_state(state, directory: str, step: int = 0):
    """Durable commit of an elastic ``ObjectState``/``TorchState``: persists
    the saved (committed) attribute dict."""
    state.save()
    tree = dict(state._saved_state)
    save(directory, tree, step)


def restore_state(state, directory: str, step: Optional[int] = None):
    """Resume an elastic state from disk: loads into the state's attributes
    and its committed backup (so a later ``restore()`` rolls back to it);
    a ``TorchState`` writes into its live tensors in place."""
    tree = restore(directory, None, step)
    state.load_recovered(tree)
