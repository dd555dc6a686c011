# Copied from horovod_tpu/torch/compression.py:1-72 (jax-free; the port keeps its own copy).
"""Gradient compression for the torch binding.

Parity: reference ``horovod/torch/compression.py`` — ``Compression.none`` /
``Compression.fp16`` with ``compress``/``decompress`` returning a context.
On TPU the natural wire dtype is bfloat16 (same dynamic range as fp32,
native MXU type), so ``Compression.bf16`` is added; ``fp16`` is kept for
API parity.
"""

from __future__ import annotations

import torch


class Compressor:
    # Cast-style compressors set wire_mode ("bf16"/"fp16") so the optimizer
    # routes them through the engine's fused wire compression (see
    # jax/compression.py); custom compressors keep the explicit hooks.
    wire_mode = None

    @staticmethod
    def compress(tensor: torch.Tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor: torch.Tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    wire_mode = "fp16"

    @staticmethod
    def compress(tensor: torch.Tensor):
        if tensor.dtype.is_floating_point:
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class BF16Compressor(Compressor):
    wire_mode = "bf16"

    @staticmethod
    def compress(tensor: torch.Tensor):
        if tensor.dtype.is_floating_point:
            return tensor.to(torch.bfloat16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class Compression:
    """Namespace matching ``hvd.Compression.{none,fp16}`` (+ TPU ``bf16``)."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
