# Ported from horovod_tpu/tensorflow/compression.py:1-72: the compressors
# cast the torch tensor a TF tensor is bridged to, in place of host numpy
# through ml_dtypes.
"""Gradient compression for the TF binding.

Parity: reference ``horovod/tensorflow/compression.py`` —
``Compression.none`` / ``Compression.fp16`` with ``compress``/``decompress``
returning a context, and ``Compression.bf16`` (float32's range, the card's
native tensor-core type).  The binding hands TF tensors to the engine as
torch tensors (``tensorflow/mpi_ops.py``), so the compressors cast those,
and the compressed dtype is what crosses into the engine.
"""

from __future__ import annotations

import torch


class Compressor:
    # Cast-style compressors set wire_mode ("bf16"/"fp16") so the binding
    # routes them through the engine's wire compression (the casts in the
    # fusion kernels); custom compressors keep the explicit hooks.
    wire_mode = None

    @staticmethod
    def compress(t: torch.Tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(t: torch.Tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(t: torch.Tensor):
        return t, None

    @staticmethod
    def decompress(t: torch.Tensor, ctx):
        return t


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, t: torch.Tensor):
        if t.is_floating_point():
            return t.to(cls.wire_dtype), t.dtype
        return t, None

    @classmethod
    def decompress(cls, t: torch.Tensor, ctx):
        return t if ctx is None else t.to(ctx)


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16
    wire_mode = "fp16"


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16
    wire_mode = "bf16"


class Compression:
    """Reference-parity namespace: ``Compression.none`` / ``.fp16`` /
    ``.bf16``."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
