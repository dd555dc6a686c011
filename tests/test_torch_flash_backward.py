"""Port parity: the port's flash-attention backward (plain version, which is
what a CPU tensor runs, and the autograd function around it) against the
JAX package's Pallas ``_bwd_impl`` in interpret mode and ``jax.grad`` of
its ``flash_attention``.

The cases are those of tests/test_flash_attention.py: padded and exact
blocks, causal and full, GQA, non-causal cross shapes (Tq != Tk), sliding
windows, and rows no key may attend.  ``lse`` and ``delta`` are supplied
from outside (the forward's own values, shifted), as ring attention
supplies its global ones.  Tolerance 1e-4, that of
tests/test_flash_attention.py:47: both sides compute in float32 and differ
only in the order of their sums (blockwise against dense).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import _bwd_impl
from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, B, Tq, Tk, H, K, D):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32)
                 for shape in ((B, Tq, H, D), (B, Tk, K, D), (B, Tk, K, D),
                               (B, Tq, H, D)))


def _external_lse_delta(seed, q, k, v, do, causal, window):
    """The forward's lse and rowsum(do * o), shifted as a global logsumexp
    and a foreign delta would be: the backward must take them as given."""
    o, lse = tfa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                     causal=causal, window=window)
    rng = np.random.RandomState(seed + 1)
    delta = (torch.from_numpy(do) * o).sum(-1).transpose(1, 2).numpy()
    lse = lse.numpy() + rng.uniform(0.0, 0.5, lse.shape).astype(np.float32)
    delta = delta + 0.1 * rng.randn(*delta.shape).astype(np.float32)
    return lse, delta


def _to_bh(x):
    B, T, h, D = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * h, T, D)


def _from_bh(x, B):
    BH, T, D = x.shape
    return np.asarray(x).reshape(B, BH // B, T, D).transpose(0, 2, 1, 3)


def _jax_bwd(q, k, v, do, lse, delta, causal, blocks, window=0):
    B, Tq, H, D = q.shape
    K = k.shape[2]
    dq, dk, dv = _bwd_impl(
        _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(do),
        jnp.asarray(lse.reshape(B * H, Tq)),
        jnp.asarray(delta.reshape(B * H, Tq)), scale=1.0 / D ** 0.5,
        causal=causal, block_q=blocks[0], block_k=blocks[1], interpret=True,
        rep=H // K, window=window)
    return _from_bh(dq, B), _from_bh(dk, B), _from_bh(dv, B)


# (B, Tq, Tk, H, K, D), causal, window, Pallas blocks
_CASES = [
    ((2, 70, 70, 3, 3, 16), False, None, (32, 32)),    # padded
    ((2, 70, 70, 3, 3, 16), True, None, (32, 32)),
    ((1, 64, 64, 2, 2, 32), False, None, (32, 32)),    # exact multiple
    ((1, 64, 64, 2, 2, 32), True, None, (32, 32)),
    ((2, 33, 33, 1, 1, 8), True, None, (16, 16)),      # tiny + padding
    ((2, 40, 40, 4, 2, 16), False, None, (16, 16)),    # GQA
    ((2, 40, 40, 4, 2, 16), True, None, (16, 16)),
    ((1, 17, 50, 2, 2, 16), False, None, (16, 16)),    # cross, Tq < Tk
    ((1, 50, 17, 2, 2, 16), False, None, (16, 16)),    # cross, Tq > Tk
    ((1, 40, 24, 2, 2, 16), True, None, (16, 16)),     # causal cross
    ((2, 70, 70, 3, 3, 16), True, 8, (32, 32)),        # window < block
    ((1, 64, 64, 2, 2, 32), True, 40, (16, 16)),       # window > block
    ((2, 48, 48, 4, 2, 16), True, 12, (16, 16)),       # window + GQA
    ((1, 40, 16, 2, 1, 16), True, 8, (16, 16)),        # empty rows
    # The bf16 kernels' tile edges at a small width: rep 8 (one kv head),
    # T one past a block, and a window that is a multiple of no block, so
    # that a row's first key falls inside a tile.
    ((1, 33, 33, 8, 1, 16), True, None, (16, 16)),     # rep 8, T = 2 B + 1
    ((2, 17, 17, 2, 2, 16), False, None, (16, 16)),    # T one past a block
    ((1, 65, 65, 8, 1, 16), True, 25, (16, 16)),       # window mid-block
    ((1, 257, 257, 8, 1, 16), True, 100, (64, 64)),    # the card's geometry
]


@pytest.mark.parametrize("shape,causal,window,blocks", _CASES)
def test_torch_flash_bwd_plain_matches_jax(shape, causal, window, blocks):
    B, Tq, Tk, H, K, D = shape
    seed = hash((shape, causal, window)) % (2 ** 31)
    q, k, v, do = _inputs(seed, B, Tq, Tk, H, K, D)
    lse, delta = _external_lse_delta(seed, q, k, v, do, causal, window)
    ref = _jax_bwd(q, k, v, do, lse, delta, causal, blocks, window or 0)
    out = tfa.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, do, lse, delta)),
        causal=causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)


def test_torch_flash_bwd_empty_rows_are_zero():
    """A row no key may attend, with the forward's lse = 0 sentinel, gets
    dq = 0 exactly and adds nothing to dk, dv."""
    Tq, Tk, W = 40, 16, 8
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(13, 1, Tq, Tk, 2, 1,
                                                        16))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, window=W)
    delta = (do * o).sum(-1).transpose(1, 2)
    empty = np.arange(Tq) >= Tk + W - 1
    assert empty.any() and np.all(lse[:, :, empty].numpy() == 0)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, do, lse, delta,
                                         causal=True, window=W)
    assert np.all(dq[:, empty].numpy() == 0)
    keep = torch.from_numpy(~empty)
    dq2, dk2, dv2 = tfa.flash_attention_bwd(
        q[:, keep], k, v, do[:, keep], lse[:, :, keep].contiguous(),
        delta[:, :, keep].contiguous(), causal=True, window=W)
    torch.testing.assert_close(dk, dk2, **TOL)
    torch.testing.assert_close(dv, dv2, **TOL)


@pytest.mark.parametrize("shape,causal,window", [
    ((2, 70, 70, 3, 3, 16), True, None),
    ((2, 40, 40, 4, 2, 16), False, None),     # GQA
    ((2, 48, 48, 4, 2, 16), True, 12),        # window + GQA
])
def test_torch_flash_bwd_plain_matches_autograd(shape, causal, window):
    """The plain backward in float32 equals autograd through the plain
    forward: the same function, differentiated two ways."""
    B, Tq, Tk, H, K, D = shape
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, B, Tq, Tk, H, K,
                                                        D))
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = tfa.flash_attention_plain(*qkv, causal=causal, window=window)
    o.backward(do)
    delta = (do * o.detach()).sum(-1).transpose(1, 2)
    out = tfa.flash_attention_bwd_plain(q, k, v, do, lse.detach(), delta,
                                        causal=causal, window=window)
    for name, a, x in zip(("dq", "dk", "dv"), out, qkv):
        torch.testing.assert_close(a, x.grad, msg=name, **TOL)


@pytest.mark.parametrize("shape,causal,window,blocks", [
    ((2, 70, 70, 3, 3, 16), False, None, (32, 32)),
    ((2, 70, 70, 3, 3, 16), True, None, (32, 32)),
    ((2, 40, 40, 4, 2, 16), True, None, (16, 16)),     # GQA
    ((1, 64, 64, 2, 2, 32), True, 40, (16, 16)),       # window
    ((1, 17, 50, 2, 2, 16), False, None, (16, 16)),    # cross
])
def test_torch_flash_grad_matches_jax_grad(shape, causal, window, blocks):
    """Gradients of the port's differentiable flash_attention against
    jax.grad of the JAX flash_attention (Pallas, interpret mode)."""
    B, Tq, Tk, H, K, D = shape
    q, k, v, _ = _inputs(hash((shape, causal)) % (2 ** 31), B, Tq, Tk, H, K,
                         D)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, window=window,
                                 block_q=blocks[0], block_k=blocks[1],
                                 interpret=True) ** 2)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (tfa.flash_attention(*qkv, causal=causal, window=window) ** 2).sum() \
        .backward()
    for name, x, r in zip(("dq", "dk", "dv"), qkv, ref):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r),
                                   err_msg=name, **TOL)


def test_torch_flash_bwd_casts_f32_cotangent():
    """An f32 cotangent over bf16 operands (the output cast to float32
    before the loss) is cast to bf16 before the backward, as _flash_bwd
    casts it; the gradients come back in bf16, finite, within bf16
    rounding of the float32 gradients."""
    q, k, v, _ = _inputs(1, 1, 32, 32, 2, 2, 8)
    grads = {}
    for dt in (torch.bfloat16, torch.float32):
        qkv = [torch.from_numpy(x).to(dt).requires_grad_(True)
               for x in (q, k, v)]
        (tfa.flash_attention(*qkv, causal=True).float() ** 2).sum().backward()
        grads[dt] = [x.grad for x in qkv]
    for g16, g32 in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert g16.dtype == torch.bfloat16
        assert torch.isfinite(g16.float()).all()
        scale = g32.abs().max()
        assert (g16.float() - g32).abs().max() <= 5e-2 * scale


def test_torch_flash_bwd_cpu_uses_plain_and_counts_no_launch():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 1, 20, 20, 4, 2,
                                                        8))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    delta = (do * o).sum(-1).transpose(1, 2)
    before = (tfa.flash_attention_bwd.launches_dq,
              tfa.flash_attention_bwd.launches_dkv,
              tfa.flash_attention_fwd.launches)
    out = tfa.flash_attention_bwd(q, k, v, do, lse, delta, causal=True)
    ref = tfa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tfa.flash_attention(*qkv, causal=True).backward(do)
    assert all(torch.equal(x.grad, r) for x, r in zip(qkv, ref))
    assert (tfa.flash_attention_bwd.launches_dq,
            tfa.flash_attention_bwd.launches_dkv,
            tfa.flash_attention_fwd.launches) == before


def test_torch_flash_bwd_rejects_malformed_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4, 1, 16, 16, 2, 2,
                                                        8))
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="lse must be float32"):
        tfa.flash_attention_bwd(q, k, v, do, lse[:, :, :8], lse)
    with pytest.raises(ValueError, match="delta must be float32"):
        tfa.flash_attention_bwd(q, k, v, do, lse, lse.double())
    with pytest.raises(ValueError, match="q's dtype"):
        tfa.flash_attention_bwd(q, k, v, do.bfloat16(), lse, lse)
    with pytest.raises(ValueError, match="q's shape"):
        tfa.flash_attention_bwd(q, k, v, do[:, :8], lse, lse)
    # The non-differentiable forward refuses to drop a gradient silently.
    with pytest.raises(ValueError, match="records no gradient"):
        tfa.flash_attention_fwd(q.requires_grad_(True), k, v, causal=True)
    with torch.no_grad():
        assert tfa.flash_attention_fwd(q, k, v, causal=True)[0].shape \
            == q.shape
