# Ported from horovod_tpu/keras/callbacks.py:1-125: the four callbacks over
# the port's engine; the metric average is one float64 allreduce on
# hvd.device().
"""Keras callbacks (reference: ``horovod/_keras/callbacks.py`` —
SURVEY.md §2b P5).

These adapt the framework-generic policies in
``horovod_tpu_torch/callbacks.py`` to real ``keras.callbacks.Callback``
hooks so they attach to ``model.fit(...)`` directly.
"""

from __future__ import annotations

from typing import Optional

import keras
import numpy as np
import torch

from ..common import basics
from ..ops import collectives as C
from ..ops import eager


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """Broadcast rank 0's model + optimizer state at train start
    (reference: ``BroadcastGlobalVariablesCallback``) so all ranks begin
    from identical initialization / restored checkpoints."""

    def __init__(self, root_rank: int = 0):
        super().__init__()
        self.root_rank = root_rank
        self._done = False

    def on_batch_end(self, batch, logs=None):
        # End of the FIRST batch: the optimizer's slot variables now exist,
        # so momentum state broadcasts too (the reference hooks the same
        # point for the same reason).  Every later step applies identical
        # reduced gradients, so ranks stay in lock-step from here.
        if self._done or basics.size() <= 1:
            return
        from . import broadcast_global_variables
        broadcast_global_variables(self.model, self.root_rank)
        self._done = True


class MetricAverageCallback(keras.callbacks.Callback):
    """Average epoch metrics over all ranks (reference:
    ``MetricAverageCallback``) so logged/early-stopping values reflect the
    global job, not one rank's shard."""

    def on_epoch_end(self, epoch, logs=None):
        if not logs or basics.size() <= 1:
            return
        keys = sorted(k for k, v in logs.items()
                      if isinstance(v, (int, float, np.floating)))
        if not keys:
            return
        vec = torch.tensor([float(logs[k]) for k in keys],
                           dtype=torch.float64, device=basics.device())
        out = eager.allreduce(vec, name=f"metric_avg.{epoch}",
                              op=C.ReduceOp.AVERAGE)
        for k, v in zip(keys, out.cpu().tolist()):
            logs[k] = float(v)


class LearningRateScheduleCallback(keras.callbacks.Callback):
    """Multiply the LR by ``multiplier(epoch)`` within an epoch range
    (reference: ``LearningRateScheduleCallback``)."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True):
        super().__init__()
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.multiplier = (multiplier if callable(multiplier)
                           else (lambda epoch: multiplier))

    def _in_range(self, epoch: int) -> bool:
        return epoch >= self.start_epoch and (
            self.end_epoch is None or epoch < self.end_epoch)

    def on_epoch_begin(self, epoch, logs=None):
        if self._in_range(epoch):
            lr = self.initial_lr * float(self.multiplier(epoch))
            self.model.optimizer.learning_rate.assign(lr)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Linear warmup from ``initial_lr`` to ``initial_lr * size()`` over
    ``warmup_epochs`` (reference: ``LearningRateWarmupCallback`` — the
    'scale LR by world size, warm up to it' large-batch recipe)."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 momentum_correction: bool = True, verbose: int = 0):
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose
        if momentum_correction:
            # Accepted for reference API parity; the reference rescales SGD
            # momentum as the LR steps during warmup, which this binding
            # does not implement — say so instead of silently differing.
            import warnings
            warnings.warn(
                "LearningRateWarmupCallback: momentum_correction is not "
                "applied in horovod_tpu_torch (pass momentum_correction="
                "False to silence); training dynamics during warmup may "
                "differ slightly from reference Horovod with momentum "
                "optimizers", stacklevel=2)
        world = basics.size()

        def multiplier(epoch):
            if warmup_epochs <= 0:
                return world
            progress = min(1.0, (epoch + 1) / float(warmup_epochs))
            return 1.0 + progress * (world - 1.0)

        super().__init__(initial_lr=initial_lr, multiplier=multiplier,
                         start_epoch=0, end_epoch=warmup_epochs)

    def on_epoch_begin(self, epoch, logs=None):
        super().on_epoch_begin(epoch, logs)
        if self.verbose and epoch < self.warmup_epochs:
            lr = float(self.model.optimizer.learning_rate.numpy())
            print(f"Epoch {epoch}: LearningRateWarmupCallback lr={lr:.6f}")
