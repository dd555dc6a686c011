# Ported from horovod_tpu/parallel/ulysses.py: seq_to_heads :23-26,
# heads_to_seq :29-32 and ulysses_attention :35-66.
"""Ulysses-style sequence parallelism: an all-to-all between sequence and
heads.

Attention is local in the head dimension, so one all-to-all along the
mesh's ``sp`` axis turns a sequence-split layout ``[B, T/sp, H, D]`` into
a head-split one ``[B, T, H/sp, D]``; full-sequence attention runs on the
local heads, and a second all-to-all turns the output back (DeepSpeed-
Ulysses).  Two all-to-alls an attention against the ring's sp - 1
rotations; it needs the q heads and the kv heads to divide by sp.

The exchange is the mesh's :class:`~.mesh.AllToAll`, whose backward is
the inverse exchange (``mesh.all_to_all`` with the split and concatenated
dimensions swapped), as the transpose of ``lax.all_to_all`` is.  The
regrouping around it is plain tensor ops: no Pallas kernel stands behind
it.  The default inner attention is the port's ``flash_attention``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .mesh import AllToAll, ProcessMesh


def seq_to_heads(x, mesh: ProcessMesh, axis_name: str = "sp"):
    """``[B, T/sp, H, D]`` -> ``[B, T, H/sp, D]`` by an all-to-all along
    ``axis_name``."""
    return AllToAll.apply(x, mesh, axis_name, 2, 1)


def heads_to_seq(x, mesh: ProcessMesh, axis_name: str = "sp"):
    """``[B, T, H/sp, D]`` -> ``[B, T/sp, H, D]``: the inverse exchange."""
    return AllToAll.apply(x, mesh, axis_name, 1, 2)


def ulysses_attention(q, k, v, mesh: ProcessMesh,
                      attn_fn: Optional[Callable] = None,
                      axis_name: str = "sp",
                      causal: bool = False) -> torch.Tensor:
    """Attention over a sequence split along ``axis_name`` of ``mesh`` by
    head exchange.

    ``attn_fn(q, k, v, causal=...)`` runs on full-sequence, local-head
    tensors; the default is the port's ``flash_attention`` (the Hopper
    kernels on the card).  GQA kv travels un-repeated, so both head
    counts must divide by the axis size."""
    if attn_fn is None:
        from ..ops.flash_attention import flash_attention
        attn_fn = flash_attention
    H, K = q.shape[2], k.shape[2]
    n = mesh.size(axis_name)
    if H % n or K % n:
        raise ValueError(
            f"ulysses_attention needs q heads ({H}) AND kv heads ({K}) "
            f"divisible by the {axis_name!r} axis size ({n}) — GQA kv "
            f"travels un-repeated through the alltoall; use "
            f"ring_attention when the kv head count is below the sp "
            f"degree")
    qh, kh, vh = (seq_to_heads(x, mesh, axis_name) for x in (q, k, v))
    out = attn_fn(qh, kh, vh, causal=causal)
    return heads_to_seq(out, mesh, axis_name)
