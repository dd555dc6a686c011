# Copied from horovod_tpu/ops/collectives.py:30-50 (the ReduceOp enum and its
# aliases; the port keeps its own copy); ported from :61-68 (``_scale``).
"""Reduction ops, value-compatible with the reference's module constants,
and the scale step that the fused collectives apply before and after the
reduction."""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch


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


def scale_factor(factor: float, dtype: torch.dtype) -> torch.Tensor:
    """``factor`` rounded as the JAX package rounds it for a tensor of
    ``dtype`` (a 0-d tensor): ``jnp.asarray(factor, dtype)`` for floating
    dtypes (numpy's direct float64 → float16 rounding; float32 first for
    bfloat16, as ml_dtypes converts), float32 for integers, which scale in
    float32 (``horovod_tpu/ops/collectives.py:66-68``)."""
    if dtype == torch.float16:
        value = float(np.float16(factor))
    elif dtype in (torch.float64, torch.complex128):
        value = float(factor)
    else:
        value = float(np.float32(factor))
    floating = dtype.is_floating_point or dtype.is_complex
    return torch.tensor(value, dtype=dtype if floating else torch.float32)


def _scale(x: torch.Tensor, factor: Optional[float]) -> torch.Tensor:
    """``x * factor`` in x's dtype, with the factor first rounded to that
    dtype; integers scale in float32 and are cast back (truncating)."""
    if factor is None or factor == 1.0:
        return x
    f = scale_factor(factor, x.dtype).to(x.device)
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        return (x.to(torch.float32) * f).to(x.dtype)
    return x * f
