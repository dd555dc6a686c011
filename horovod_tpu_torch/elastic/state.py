# Ported from horovod_tpu/elastic/state.py: State and ObjectState (:35-148)
# and run (:254-326) are copied; TorchState is the counterpart of JaxState
# (:151-245) over the torch binding's surface
# (horovod_tpu/torch/elastic/state.py:63-108).
"""Elastic state objects and the retrying run wrapper.

Reference files mirrored: ``horovod/common/elastic.py`` (State, run_fn),
``horovod/torch/elastic/state.py`` (TorchState).  See SURVEY.md §3.4 for
the control flow being reproduced.

``TorchState`` follows ``JaxState``'s contract, not the JAX torch
binding's: everything it holds is in ``_saved_state``, so the state plane
makes the model and the optimizer durable, not only the scalars.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, Optional

import torch

from ..common.exceptions import (  # noqa: F401  (re-export)
    ControlPlaneError, DrainRequested, HorovodInternalError,
    HostsUpdatedInterrupt, PeerFailureError, PeerLeftInterrupt,
    RoundTimeoutError,
)


class State:
    """Base elastic state: commit/restore/sync + reset listeners.

    Matches the reference's ``horovod.common.elastic.State`` surface:
    ``register_reset_callbacks``, ``on_reset``, ``commit``, ``restore``,
    ``sync``.
    """

    def __init__(self, **kwargs):
        self._reset_callbacks = []
        self._kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def register_reset_callbacks(self, callbacks):
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self, timestamp, update_res):
        pass

    def commit(self):
        self.save()
        # Resilient state plane: when HOROVOD_CKPT_DIR armed a plane
        # (attached by the @run wrapper), every commit also streams this
        # rank's 1/N durable shard through the engine's checkpoint lane
        # and publishes the epoch for peer-to-peer restore.  The committed
        # attribute dict is exactly what restore() rolls back to, so it is
        # exactly what becomes durable.
        sp = getattr(self, "_stateplane", None)
        saved = getattr(self, "_saved_state", None)
        if sp is not None and saved:
            try:
                sp.commit(state=saved)
            except Exception as exc:  # noqa: BLE001 - durability must
                # never fail the training step; the previous epoch stays.
                from ..utils.logging import get_logger
                get_logger().error("state plane commit failed: %s", exc)
        self.check_host_updates()

    def check_host_updates(self):
        # Hooked by the worker-notification client in multi-process mode.
        notifier = getattr(self, "_notification_manager", None)
        if notifier is not None:
            notifier.raise_if_updated()

    def should_commit(self) -> bool:
        """Checkpoint pacing: True when the elastic driver has requested an
        immediate state commit (a ``COMMIT`` notification — sent just
        before it executes a scale or preemption decision, so the last
        commit predates the world change by milliseconds, not a timer
        period).  Consult it alongside any periodic cadence::

            if state.should_commit() or batch % commit_every == 0:
                state.commit()

        Consumed on read; False when no notification manager is attached
        (single-process / non-elastic runs)."""
        notifier = getattr(self, "_notification_manager", None)
        if notifier is None:
            return False
        return bool(notifier.consume_commit_request())

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def load_recovered(self, data: Dict[str, Any]):
        """Load a state dict recovered by the state plane's peer/disk
        restore (``stateplane.maybe_restore``) into the LIVE attributes
        and re-save.  The base implementation is a raw attribute load;
        :class:`TorchState` overrides it to copy into the live tensors
        (and re-slice a sharded optimizer's own 1/N shard)."""
        for k, v in data.items():
            setattr(self, k, v)
        self.save()


class ObjectState(State):
    """Elastic state of plain Python attributes, synced via
    ``broadcast_object`` (reference: ``horovod/common/elastic.py``)."""

    def __init__(self, bcast_object: Optional[Callable] = None, **kwargs):
        if bcast_object is None:
            from ..ops.eager import broadcast_object as bcast_object
        self._bcast_object = bcast_object
        self._saved_state: Dict[str, Any] = {}
        super().__init__(**kwargs)
        self.save()

    def save(self):
        self._saved_state = {k: copy.deepcopy(getattr(self, k))
                             for k in self._kwargs}

    def restore(self):
        for k, v in self._saved_state.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self):
        if self._saved_state:
            synced = self._bcast_object(self._saved_state, root_rank=0)
            for k, v in synced.items():
                setattr(self, k, v)
                self._saved_state[k] = copy.deepcopy(v)


# ----------------------------------------------------------------- TorchState
def _host(t: torch.Tensor):
    """A host copy of a tensor: a numpy array where numpy has its dtype
    (what ``JaxState``'s ``device_get`` gives), else a CPU tensor
    (bfloat16 and the float8 types)."""
    c = t.detach().to("cpu", copy=True)
    try:
        return c.numpy()
    except TypeError:
        return c


def _host_tree(x):
    """Host copies of every tensor of a tree; dicts in sorted key order,
    as JAX's tree utilities give them."""
    if isinstance(x, torch.Tensor):
        return _host(x)
    if isinstance(x, dict):
        return {k: _host_tree(x[k]) for k in sorted(x, key=_order)}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_tree(y) for y in x)
    return copy.deepcopy(x)


def _order(k):
    return (type(k).__name__, k)


def _as_tensor(v) -> torch.Tensor:
    import numpy as np
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v)
    return v


def _torch_tree(x):
    """The tree with every array a tensor of its own (for
    ``load_state_dict`` and ``load_sharded_saveable``): an optimizer keeps
    some of what it loads as given (its ``step``) and updates it in place,
    which must touch neither the saved state nor a recovered blob."""
    import numpy as np
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x, copy=True))
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _torch_tree(y) for k, y in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_torch_tree(y) for y in x)
    return x


@torch.no_grad()
def _copy_into(live, saved) -> None:
    """Write a saved tree into the live tensors IN PLACE (``copy_``), so
    that every holder of them — the optimizer's parameter list, the
    gradient hooks — goes on seeing the same tensors."""
    if isinstance(live, torch.Tensor):
        live.copy_(_as_tensor(saved))
    elif isinstance(live, dict):
        if set(live) != set(saved):
            raise ValueError(f"restored keys {sorted(saved, key=_order)} are "
                             f"not the live {sorted(live, key=_order)}")
        for k in live:
            _copy_into(live[k], saved[k])
    elif isinstance(live, (list, tuple)):
        if len(live) != len(saved):
            raise ValueError(f"restored length {len(saved)} is not the "
                             f"live {len(live)}")
        for a, b in zip(live, saved):
            _copy_into(a, b)


def _is_tensor_tree(v) -> bool:
    if isinstance(v, torch.Tensor):
        return True
    if isinstance(v, dict):
        return bool(v) and all(_is_tensor_tree(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return bool(v) and all(_is_tensor_tree(x) for x in v)
    return False


def _reset_sync(opt) -> None:
    """Forget a DistributedOptimizer's gradient handles of a dead
    generation (they would be waited on, and zero_grad refuses them)."""
    reset = getattr(opt, "_reset_handles", None)
    if reset is not None:
        reset()


class TorchState(ObjectState):
    """Elastic state of a torch train state: ``nn.Module``s, optimizers
    (``DistributedOptimizer`` too), tensors and dicts or lists of them
    (the port's models keep their parameters as dicts), and any picklable
    value.

    The counterpart of ``JaxState``: ``save()`` (each ``commit``) copies
    every tensor to host memory — what ``_saved_state`` holds is what the
    state plane makes durable; ``restore()``, ``sync()`` and
    ``load_recovered()`` write into the LIVE tensors in place
    (``copy_``), so that an optimizer's parameter list and its gradient
    hooks stay valid.  An optimizer loads through ``load_state_dict``
    (its state tensors are its own), after its gradient handles of the
    dead generation are dropped.

    A ``DistributedOptimizer(sharded=...)`` saves as its rank-invariant
    ``hvd_sharded_saveable()`` (a collective, like every ``commit``) and
    every load re-slices this rank's own 1/N with
    ``load_sharded_saveable``; where the world's size differs from the
    saveable's, the optimizer is left as it is and the saveable kept.

    Usage::

        state = hvd.elastic.TorchState(params=params, optimizer=opt,
                                       step=0)
    """

    def __init__(self, model=None, optimizer=None, **kwargs):
        if model is not None:
            kwargs["model"] = model
        if optimizer is not None:
            kwargs["optimizer"] = optimizer
        super().__init__(**kwargs)

    # ------------------------------------------------------------- saving
    def save(self):
        self._saved_state = {k: self._save_one(k, getattr(self, k))
                             for k in self._kwargs}

    def _save_one(self, k, v):
        if hasattr(v, "hvd_sharded_saveable"):
            from ..common import basics
            if v._plan.world != basics.size():
                # Sharded for another world (a resize it was not rebuilt
                # for): its gather would be wrong; the last saveable stays.
                return self._saved_state.get(k)
            return v.hvd_sharded_saveable()
        if isinstance(v, torch.optim.Optimizer):
            return _host_tree(v.state_dict())
        if isinstance(v, torch.nn.Module):
            return _host_tree(dict(v.state_dict()))
        if _is_tensor_tree(v):
            return _host_tree(v)
        return copy.deepcopy(v)

    # ------------------------------------------------------------ loading
    def _load(self, k, live, v, local: bool) -> None:
        """One saved value into the live attribute ``k``."""
        from ..optimizer import is_sharded_saveable, load_sharded_saveable
        if hasattr(live, "hvd_sharded_saveable") and is_sharded_saveable(v):
            _reset_sync(live)
            from ..common import basics
            v = _torch_tree(v)
            if load_sharded_saveable(v, basics.rank(),
                                     basics.size()) is not None:
                live.load_sharded_saveable(v)
            else:
                from ..utils.logging import get_logger
                get_logger().warning(
                    "elastic: the saved sharded optimizer state of %r is "
                    "for a world of %s ranks, this one has %d: left as it "
                    "is", k, v.get("world"), basics.size())
        elif isinstance(live, torch.optim.Optimizer):
            _reset_sync(live)
            live.load_state_dict(_torch_tree(v))
        elif isinstance(live, torch.nn.Module):
            _copy_into(dict(live.state_dict()), v)
        elif _is_tensor_tree(live):
            _copy_into(live, v)
        else:
            setattr(self, k, copy.deepcopy(v) if not local else v)

    def restore(self):
        for k, v in self._saved_state.items():
            self._load(k, getattr(self, k), v, local=False)

    def sync(self):
        """Rank 0's state everywhere: tensors broadcast in place through
        the engine (``broadcast_parameters``; an optimizer's through
        ``broadcast_optimizer_state``), the other values as one object;
        then re-saved, so that every rank's ``_saved_state`` is rank 0's.
        A sharded optimizer's state and its saveable stay as each rank
        holds them (its shards are not replicas)."""
        if not self._saved_state:
            return
        from .. import functions
        objects = {}
        for k in self._kwargs:
            v = getattr(self, k)
            if hasattr(v, "hvd_sharded_saveable"):
                continue
            if isinstance(v, torch.optim.Optimizer):
                _reset_sync(v)
                functions.broadcast_optimizer_state(v, root_rank=0)
            elif isinstance(v, torch.nn.Module):
                functions.broadcast_parameters(v.state_dict(), root_rank=0)
            elif _is_tensor_tree(v):
                functions.broadcast_parameters(v, root_rank=0)
            else:
                objects[k] = self._saved_state.get(k, v)
        if objects:
            synced = self._bcast_object(objects, root_rank=0)
            for k, v in synced.items():
                setattr(self, k, v)
        for k in self._kwargs:
            v = getattr(self, k)
            if not hasattr(v, "hvd_sharded_saveable"):
                self._saved_state[k] = self._save_one(k, v)

    def load_recovered(self, data):
        """Peer/disk-recovered state into the live tensors: tensor trees
        and modules are copied in place, an optimizer loads its state
        dict, a sharded optimizer's saveable comes back as THIS rank's
        1/N shard.

        The recovered dict itself becomes the new ``_saved_state`` —
        NEVER ``self.save()`` here: a sharded save gathers collectively,
        and only the stale (re-joining) rank runs this path, so a
        collective would deadlock against the survivors."""
        for k, v in data.items():
            if k in self._kwargs:
                self._load(k, getattr(self, k), v, local=True)
            else:
                setattr(self, k, v)
            self._saved_state[k] = v


def _drop_frames(exc: BaseException) -> None:
    """Let a caught fault's frames go: the engine keeps the exception (its
    latched fault, each waiter's error), and its traceback would keep the
    failed step's frames, with their tensors, as long."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__


def _world_faulted(wait_s: float = 10.0) -> bool:
    """Whether the runtime's engine has latched a control-plane fault
    (HVD303), waiting up to ``wait_s`` for the control plane to declare
    it: a data-plane error of a collective comes first when a peer
    dies."""
    import time
    from ..common import basics
    eng = getattr(basics._get_state(), "engine", None)
    if eng is None or eng.controller is None:
        return False
    deadline = time.monotonic() + wait_s
    while eng.fault is None and time.monotonic() < deadline:
        time.sleep(0.05)
    return eng.fault is not None


def run(func: Callable) -> Callable:
    """``@hvd.elastic.run`` — retrying elastic train-loop wrapper.

    Control flow mirrors SURVEY.md §3.4: sync, run; on
    ``HorovodInternalError`` restore to last commit; on
    ``HostsUpdatedInterrupt`` keep params; either way re-init the runtime
    (which tears the world's communicators down and forms the next
    generation's) and retry.
    """
    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        from ..common import basics
        cfg = basics._get_state().config
        if cfg is not None and cfg.elastic:
            from . import worker
            worker.attach_notification_manager(state)
        # Resilient state plane: HOROVOD_CKPT_DIR arms a per-rank plane on
        # the engine — attach it so state.commit() streams durable shards,
        # and re-attach after every re-init (the reset builds a fresh
        # engine, which re-binds the process's plane).
        from . import stateplane as _sp
        plane = _sp.attach(state)
        reset_required = False
        skip_sync = False
        # Peer restore applies only while this rank's live state is
        # actually STALE: a fresh process (initial params) or one that
        # just rolled back to its last commit after a fault.  A survivor
        # re-entering on a clean HostsUpdatedInterrupt holds the fleet's
        # CURRENT state — its plane epoch may still lag a peer's (commit
        # pings land on skewed cadence), and pulling that peer's older
        # commit would roll live training backwards (and, re-ranked to
        # rank 0, sync() the rollback fleet-wide).
        stale = True
        while True:
            if reset_required:
                _reset(state)
                plane = _sp.attach(state)
                state.on_reset()
            try:
                if not skip_sync:
                    if plane is not None and stale:
                        # Peer-first restore: a (re-)joining rank whose
                        # epoch lags the survivors' pulls the committed
                        # state from their shard servers (disk manifest
                        # as the fallback) BEFORE sync — so even a
                        # re-ranked rank 0 broadcasts recovered state,
                        # never its own stale/empty one.
                        _sp.maybe_restore(state, plane)
                    state.sync()
                stale = False
                return func(state, *args, **kwargs)
            except HorovodInternalError as exc:
                _drop_frames(exc)
                state.restore()
                skip_sync = False
                stale = True
            except RuntimeError as exc:
                # A collective whose peer died may fail in the data plane
                # (gloo raises when the peer's socket closes) before the
                # control plane has declared the peer dead: the same fault
                # once the engine latches it, anything else as it was.
                if not _world_faulted():
                    raise
                _drop_frames(exc)
                state.restore()
                skip_sync = False
                stale = True
            except DrainRequested:
                # The driver asked this worker to drain: the batch that
                # just committed is the last one — shut down, which sends
                # the clean LEAVE so survivors see an orderly departure,
                # and return.  Exit 0 is the contract the driver's
                # clean-exit classification keys on.
                basics.shutdown()
                return None
            except HostsUpdatedInterrupt as e:
                skip_sync = e.skip_sync
            reset_required = True

    def _reset(state: State):
        import gc
        from ..common import basics
        # The next generation computes where this one did: init() is told
        # the device only where the caller told it (the CPU, as tests do).
        device = basics._get_state().requested_device
        basics.shutdown()
        # The dead generation's engine, its entries and the failed step's
        # autograd graph hang in reference cycles (the fault held by the
        # engine, its traceback's frames holding the engine): free their
        # memory on the card before the next generation allocates.
        gc.collect()
        if device is None:
            basics.init()
        else:
            basics.init(device=device)

    return wrapper
