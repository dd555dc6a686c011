# Copied from horovod_tpu/ops/collectives.py:30-50 (the ReduceOp enum and its aliases; the port keeps its own copy).
"""Reduction ops, value-compatible with the reference's module constants."""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    """Reduction ops, value-compatible with the reference's hvd module consts

    (``horovod/torch/mpi_ops.py``: Average=0, Sum=1, Adasum=2, Min=3, Max=4,
    Product=5).
    """
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


# Module-level aliases matching `hvd.Average` etc.
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT
