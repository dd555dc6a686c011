# Ported from horovod_tpu/callbacks.py:1-160: Callback (:29-43) and the
# learning-rate multipliers (:92-147) as they are; the broadcast, the metric
# average and warmup_scaled_schedule (an optax schedule there) over torch
# tensors and the port's engine.
"""Training-loop callbacks for PyTorch training loops.

Parity: the reference Keras callbacks (``horovod/_keras/callbacks.py`` —
SURVEY.md §2b P5): ``BroadcastGlobalVariablesCallback``,
``MetricAverageCallback``, ``LearningRateWarmupCallback``,
``LearningRateScheduleCallback``.

The callbacks drive an imperative loop through a ``state`` object:
``state.params`` (a tree of dicts, lists and tuples with tensor leaves, a
``state_dict`` or an ``nn.Module``) and ``state.opt_state`` (a
``torch.optim.Optimizer`` or a tree of tensors) are broadcast in place from
the root rank at the start of training; ``state.lr`` is the learning rate
the loop's step consumes, and where ``state.optimizer`` is a
``torch.optim.Optimizer`` the schedules write the same value into each of
its ``param_groups``.  ``warmup_scaled_schedule`` is the same warmup as a
``step -> lr`` function, for ``torch.optim.lr_scheduler.LambdaLR`` once
divided by the base rate.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import functions
from .common import basics
from .ops import collectives as C
from .ops import eager


class Callback:
    """Minimal hook protocol (a structural subset of keras.Callback)."""

    def on_train_begin(self, state: Any = None):
        pass

    def on_epoch_begin(self, epoch: int, state: Any = None):
        pass

    def on_epoch_end(self, epoch: int, state: Any = None,
                     metrics: Optional[Dict[str, float]] = None):
        pass

    def on_batch_end(self, batch: int, state: Any = None):
        pass


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast rank 0's parameters to all ranks at train start.

    Reference: ``BroadcastGlobalVariablesCallback`` — ensures consistent
    initialization (or checkpoint-restored state) across ranks.  ``state``
    must expose ``params``; ``opt_state`` is broadcast too when present:
    a ``torch.optim.Optimizer`` through ``broadcast_optimizer_state`` (its
    structure from the root, so a rank with no step taken receives the
    root's state), a tree of tensors in place.  At size 1 it does nothing.
    """

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state: Any = None):
        if state is None or basics.size() <= 1:
            return
        state.params = broadcast_pytree(state.params, self.root_rank)
        opt_state = getattr(state, "opt_state", None)
        if isinstance(opt_state, torch.optim.Optimizer):
            functions.broadcast_optimizer_state(opt_state, self.root_rank)
        elif opt_state is not None:
            state.opt_state = broadcast_pytree(opt_state, self.root_rank)


def broadcast_pytree(tree, root_rank: int = 0, process_set=None):
    """Broadcast every tensor of a nested dict, list or tuple (or of a
    ``state_dict`` or module) from ``root_rank``, in place, in one
    negotiation round; returns ``tree``.  The counterpart of the JAX
    ``eager.broadcast_pytree`` that callback users reach for alongside
    :class:`BroadcastGlobalVariablesCallback`."""
    return functions.broadcast_parameters(tree, root_rank=root_rank,
                                          process_set=process_set)


class MetricAverageCallback(Callback):
    """Average epoch metrics over all ranks (reference:
    ``MetricAverageCallback``) so logged values reflect the global job:
    the numeric values, in sorted key order, as one float32 allreduce
    under Average named ``metric_avg.<epoch>`` on ``hvd.device()``."""

    def on_epoch_end(self, epoch: int, state: Any = None,
                     metrics: Optional[Dict[str, float]] = None):
        if not metrics or basics.size() <= 1:
            return
        keys = sorted(k for k, v in metrics.items()
                      if isinstance(v, (int, float, np.floating, np.integer)))
        if not keys:
            return
        vec = torch.tensor([float(metrics[k]) for k in keys],
                           dtype=torch.float32, device=basics.device())
        out = eager.allreduce(vec, name=f"metric_avg.{epoch}",
                              op=C.ReduceOp.AVERAGE)
        for k, v in zip(keys, out.cpu().tolist()):
            metrics[k] = float(v)


class LearningRateScheduleCallback(Callback):
    """Multiply the base LR by ``multiplier(epoch)`` within [start_epoch,
    end_epoch) (reference: ``LearningRateScheduleCallback``).  ``state``
    must expose an ``lr`` attribute consumed by the train step; a
    ``torch.optim.Optimizer`` at ``state.optimizer`` gets the same value in
    each of its ``param_groups``."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True):
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def _in_range(self, epoch: int) -> bool:
        return epoch >= self.start_epoch and (
            self.end_epoch is None or epoch < self.end_epoch)

    def on_epoch_begin(self, epoch: int, state: Any = None):
        if state is not None and self._in_range(epoch):
            state.lr = self.initial_lr * self.multiplier(epoch)
            optimizer = getattr(state, "optimizer", None)
            if isinstance(optimizer, torch.optim.Optimizer):
                for group in optimizer.param_groups:
                    group["lr"] = state.lr


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual LR warmup to ``initial_lr * size()`` over ``warmup_epochs``
    (reference: ``LearningRateWarmupCallback``, implementing the Goyal et
    al. linear-scaling + warmup recipe).

    ``momentum_correction`` is accepted for reference-API compatibility but
    has no effect here, as in the JAX package: the reference rescales the
    optimizer's momentum buffers as the LR steps, which this callback does
    not do.
    """

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 momentum_correction: bool = True, verbose: int = 0):
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

        def multiplier(epoch):
            size = basics.size() if basics.is_initialized() else 1
            # epoch+1 so the first epoch already makes progress; the last
            # warmup epoch lands exactly on size().
            return 1.0 + (size - 1.0) * (epoch + 1) / max(warmup_epochs, 1)

        # end_epoch bounds the warmup (reference behavior) so composed decay
        # schedules own the LR afterwards.
        super().__init__(initial_lr, multiplier, start_epoch=0,
                         end_epoch=warmup_epochs)

    def on_epoch_begin(self, epoch: int, state: Any = None):
        super().on_epoch_begin(epoch, state)
        if self.verbose and state is not None and self._in_range(epoch):
            print(f"Epoch {epoch}: warmup lr = {state.lr:.6g}")


def warmup_scaled_schedule(base_lr: float, steps_per_epoch: int,
                           warmup_epochs: int = 5,
                           size: Optional[int] = None
                           ) -> Callable[[int], float]:
    """The same policy as a step-indexed ``step -> lr`` function: linear
    warmup from ``base_lr`` to ``base_lr * size`` over ``warmup_epochs``
    epochs, constant after.  Computed in float32 as
    ``optax.linear_schedule(base_lr, base_lr * size, warmup_steps)`` is, so
    the two agree at every step; ``LambdaLR(opt, lambda s: sched(s) /
    base_lr)`` applies it to an optimizer whose rate is ``base_lr``."""
    n = size if size is not None else (
        basics.size() if basics.is_initialized() else 1)
    end = base_lr * n
    warmup_steps = max(warmup_epochs * steps_per_epoch, 1)

    def schedule(step: int) -> float:
        count = np.float32(min(max(int(step), 0), warmup_steps))
        frac = np.float32(1) - count / np.float32(warmup_steps)
        return float(np.float32(base_lr - end) * frac + np.float32(end))

    return schedule
