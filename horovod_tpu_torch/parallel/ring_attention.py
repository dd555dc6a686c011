# Ported from horovod_tpu/parallel/ring_attention.py: ring_attention
# :51-87, the flash ring engine :157-301 (_ring_flash_bthd,
# _ring_flash_forward, _ring_flash_core and its custom VJP), _causal_mask
# :304-310, local_flash_attention :313-345 and NEG_INF.
"""Ring attention: exact attention over a sequence split across ranks.

Each rank holds ``[B, T/sp, heads, D]`` shards of q, k and v, in rank
order along the mesh's ``sp`` axis.  k and v rotate around the ring, so
every rank's queries meet every block of keys once; per step the flash
kernels of ``ops/flash_attention.py`` give a normalised ``(o, lse)`` pair,
and the pairs merge by log-add-exp in float32.  Memory stays
O(T/sp · T/sp) a step and the full sequence is never gathered.

    out = ring_attention(q, k, v, mesh, axis_name="sp", causal=True)

The ring is a ``torch.autograd.Function``.  Forward: ``(k, v)`` rotates
n - 1 times; at step ``s`` the held block belongs to rank ``(my - s) % n``;
step 0 is the diagonal block (causal when the attention is), a step
``s > 0`` attends the whole block when ``my >= s`` or without causality,
and is skipped otherwise (its merge would be the identity ``(0,
NEG_INF)``).  The causal ring is unbalanced by design: the last rank
computes n blocks, rank 0 one.  Backward: k and v stay where they live
and accumulate dk/dv in float32 there; ``(q, do, lse, delta, dq)``
rotates n times, so that dq arrives home, and every step calls the flash
backward with the **global** ``lse``/``delta``, whose rows of ``p`` no
longer sum to one on a block.  Every dk/dv contribution thus returns to
the rank that owns the k/v.

GQA: k and v travel with their own ``K = H / rep`` heads; the port's flash
functions read shared kv heads natively, so the JAX ``to_bh`` flattening
(:168-174) has no counterpart.

Overlap: each step posts the next step's exchange (``mesh.ppermute`` with
``async_op``) before launching its kernel and waits on it after, the
port's counterpart of XLA overlapping the ``ppermute`` with compute
(:147-149).  In the backward, the float32 dq that a step sends on is
waited for only where the next step adds its own block's dq, so it too
travels beside that step's kernels; only the last hop home is exposed.
On the card the wait is the stream's, not the host's.

Not carried over: the jnp blockwise engine (``_block_attn`` :33-48 and
the online-softmax ring :88-153) — on the CPU this ring runs over the
kernels' plain versions, as everything in the port does — and the TPU's
routing knobs (``use_flash``, ``block_q``/``block_k``, ``interpret``,
``resolve_flash``): the port routes by device only.  There is no
fallback: CUDA tensors launch the kernels or raise, and a failed exchange
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import (NEG_INF, _check, flash_attention_bwd,
                                   flash_attention_fwd)
from .mesh import ProcessMesh, ppermute


def _t(x):
    """``[B, heads, T]`` -> ``[B, T, heads, 1]``, to scale ``o`` rows."""
    return x.transpose(1, 2)[..., None]


def _ring_forward(q, k, v, mesh, axis, causal, scale):
    """Returns ``(o [B, Tq, H, D] in q's dtype, lse [B, H, Tq] float32)``,
    both global over the ring."""
    n, my = mesh.size(axis), mesh.index(axis)
    o_acc = lse_acc = None
    kv = (k, v)
    for step in range(n):
        pending = (ppermute(kv, mesh, axis, async_op=True)
                   if step != n - 1 else None)
        if step == 0 or not causal or my >= step:
            o_i, lse_i = flash_attention_fwd(q, *kv, causal=causal
                                             and step == 0, scale=scale)
            o_i = o_i.float()
            if o_acc is None:
                # The merge with the identity (0, NEG_INF) is exact.
                o_acc, lse_acc = o_i, lse_i
            else:
                lse_new = torch.logaddexp(lse_acc, lse_i)
                o_acc = (o_acc * _t(torch.exp(lse_acc - lse_new))
                         + o_i * _t(torch.exp(lse_i - lse_new)))
                lse_acc = lse_new
        if pending is not None:
            kv = tuple(pending.wait())
    return o_acc.to(q.dtype), lse_acc


def _ring_backward(q, k, v, o, lse, do, mesh, axis, causal, scale):
    """``(dq, dk, dv)`` of this rank's shards: q's tuple travels, dq comes
    home after n hops, dk/dv accumulate here."""
    n, my = mesh.size(axis), mesh.index(axis)
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()
    # The kernels dot do against v and q in the operands' dtype, as
    # _flash_bwd casts it.
    do = do.to(q.dtype)
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    held, dq_pending = (q, do, lse, delta), None
    for t in range(n):
        # The read-only tuple leaves before this step's kernels run, and
        # the dq that the last step sent on travels beside them: it is
        # waited for only where this step adds to it.
        pending = (ppermute(held, mesh, axis, async_op=True)
                   if t != n - 1 else None)
        dq_i = None
        if t == 0 or not causal or my < t:
            dq_i, dk_i, dv_i = flash_attention_bwd(
                *held[:1], k, v, *held[1:], causal=causal and t == 0,
                scale=scale)
            dk_acc += dk_i.float()
            dv_acc += dv_i.float()
        if dq_pending is None:      # step 0 always computes its block
            dq_t = dq_i.float()
        else:
            dq_t, = dq_pending.wait()
            if dq_i is not None:
                dq_t += dq_i.float()
        dq_pending = ppermute([dq_t], mesh, axis, async_op=True)
        if pending is not None:
            held = tuple(pending.wait())
    dq_t, = dq_pending.wait()
    return dq_t.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """``o`` of the ring, with the backward ring as its gradient
    (``_ring_flash_core`` and its custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        o, lse = _ring_forward(q, k, v, mesh, axis, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attrs = (mesh, axis, causal, scale)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis, causal, scale = ctx.attrs
        dq, dk, dv = _ring_backward(q, k, v, o, lse, do, mesh, axis, causal,
                                    scale)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, mesh: ProcessMesh, axis_name: str = "sp",
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence split along ``axis_name`` of
    ``mesh``, differentiable through the backward ring.

    q: this rank's ``[B, T_loc, H, D]``; k, v: ``[B, T_loc, K, D]`` with
    ``H % K == 0``; every rank holds the same ``T_loc``.  Returns this
    rank's ``[B, T_loc, H, D]`` in q's dtype."""
    _check(q, k, v, causal, None)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"ring attention takes q and kv shards of one "
                         f"length, got {q.shape[1]} and {k.shape[1]}")
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    return _RingFlash.apply(q, k, v, mesh, axis_name, causal, scale)


def _causal_mask(Tq: int, Tk: int, window: Optional[int], device=None):
    rows = torch.arange(Tq, device=device)[:, None]
    cols = torch.arange(Tk, device=device)[None, :]
    m = rows >= cols
    if window:
        m = m & (rows - cols < window)
    return m


def local_flash_attention(q, k, v, causal: bool = False,
                          scale: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """Single-rank reference attention (the same math, no ring), dense and
    differentiable by autograd, for tests.  GQA is native: kv may have
    ``K = H / rep`` heads, read by a grouped einsum with no repeat.
    ``window``: sliding-window causal attention over the last ``window``
    positions."""
    B, Tq, H, D = q.shape
    K = k.shape[2]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if v.shape[2] != K or H % K:
        raise ValueError(f"GQA heads mismatch: q={H} k={K} v={v.shape[2]}")
    qg = q.reshape(B, Tq, K, H // K, D).float()
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float()) * scale
    if causal:
        mask = _causal_mask(Tq, k.shape[1], window, q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Tq, H, D).to(q.dtype)
