"""Port parity: the port's flash-attention forward (plain version, which is
what a CPU tensor runs) against the JAX package's Pallas ``_fwd_impl`` in
interpret mode — ``(o, lse)`` on the same numpy inputs, float32, 1e-5.

The cases are those of tests/test_flash_attention.py: padded and exact
blocks, causal and full, GQA, cross shapes (Tq != Tk) and sliding windows.
Tolerance 1e-5: both sides compute in float32 and differ only in the
order of their sums (blockwise online softmax against a dense one).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.ops.flash_attention import _fwd_impl
from horovod_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, B, Tq, Tk, H, K, D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Tq, H, D).astype(np.float32)
    k = rng.randn(B, Tk, K, D).astype(np.float32)
    v = rng.randn(B, Tk, K, D).astype(np.float32)
    return q, k, v


def _jax_fwd(q, k, v, causal, blocks, window=0):
    """The JAX kernel on [BH, T, D] operands, as flash_attention feeds it."""
    B, Tq, H, D = q.shape
    K = k.shape[2]

    def to_bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
            B * x.shape[2], x.shape[1], D)

    o, lse = _fwd_impl(to_bh(q), to_bh(k), to_bh(v), 1.0 / D ** 0.5, causal,
                       blocks[0], blocks[1], True, rep=H // K, window=window)
    o = np.asarray(o).reshape(B, H, Tq, D).transpose(0, 2, 1, 3)
    return o, np.asarray(lse).reshape(B, H, Tq)


def _port_fwd(q, k, v, causal, window=None):
    o, lse = tfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal,
                                     window=window)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,blocks", [
    ((2, 70, 3, 16), (32, 32)),   # padded: 70 % 32 != 0
    ((1, 64, 2, 32), (32, 32)),   # exact multiple
    ((2, 33, 1, 8), (16, 16)),    # tiny + padding
])
def test_torch_flash_matches_jax(shape, blocks, causal):
    B, T, H, D = shape
    q, k, v = _inputs(hash((shape, causal)) % (2 ** 31), B, T, T, H, H, D)
    o_j, lse_j = _jax_fwd(q, k, v, causal, blocks)
    o_t, lse_t = _port_fwd(q, k, v, causal)
    np.testing.assert_allclose(o_t, o_j, **TOL)
    np.testing.assert_allclose(lse_t, lse_j, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_torch_flash_gqa_matches_jax(causal):
    q, k, v = _inputs(7, 2, 40, 40, 4, 2, 16)
    o_j, lse_j = _jax_fwd(q, k, v, causal, (16, 16))
    o_t, lse_t = _port_fwd(q, k, v, causal)
    np.testing.assert_allclose(o_t, o_j, **TOL)
    np.testing.assert_allclose(lse_t, lse_j, **TOL)


def test_torch_flash_cross_shapes_match_jax():
    """Tq != Tk in both directions, non-causal and causal."""
    for seed, (Tq, Tk), causal in ((3, (17, 50), False), (4, (50, 17), False),
                                   (5, (40, 24), True)):
        q, k, v = _inputs(seed, 1, Tq, Tk, 2, 2, 16)
        o_j, lse_j = _jax_fwd(q, k, v, causal, (16, 16))
        o_t, lse_t = _port_fwd(q, k, v, causal)
        np.testing.assert_allclose(o_t, o_j, **TOL)
        np.testing.assert_allclose(lse_t, lse_j, **TOL)


@pytest.mark.parametrize("window,shape,blocks", [
    (8, (2, 70, 3, 16), (32, 32)),    # window smaller than a block
    (40, (1, 64, 2, 32), (16, 16)),   # window spans several blocks
    (4, (2, 33, 1, 8), (16, 16)),     # tiny + padding
])
def test_torch_flash_sliding_window_matches_jax(window, shape, blocks):
    B, T, H, D = shape
    q, k, v = _inputs(hash((shape, window)) % (2 ** 31), B, T, T, H, H, D)
    o_j, lse_j = _jax_fwd(q, k, v, True, blocks, window)
    o_t, lse_t = _port_fwd(q, k, v, True, window)
    np.testing.assert_allclose(o_t, o_j, **TOL)
    np.testing.assert_allclose(lse_t, lse_j, **TOL)


def test_torch_flash_sliding_window_gqa_matches_jax():
    q, k, v = _inputs(11, 2, 48, 48, 4, 2, 16)
    o_j, lse_j = _jax_fwd(q, k, v, True, (16, 16), 12)
    o_t, lse_t = _port_fwd(q, k, v, True, 12)
    np.testing.assert_allclose(o_t, o_j, **TOL)
    np.testing.assert_allclose(lse_t, lse_j, **TOL)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=False, window=12)


def test_torch_flash_empty_rows_are_zero():
    """A row no key may attend (Tq > Tk + window: the band has slid past
    the last key) stores o = 0 and the lse = 0 sentinel; every other row
    matches JAX.  The Pallas kernel stores that sentinel only where no
    k-block of the row's q-block is live; inside a live block such a row
    ends with lse = -1e30 and o = the block's mean v, so the empty rows
    are not compared with it."""
    Tq, Tk, W = 40, 16, 8
    q, k, v = _inputs(13, 1, Tq, Tk, 2, 1, 16)
    o_t, lse_t = _port_fwd(q, k, v, True, W)
    empty = np.arange(Tq) >= Tk + W - 1
    assert empty.any() and not empty.all()
    assert np.all(o_t[:, empty] == 0) and np.all(lse_t[:, :, empty] == 0)
    o_j, lse_j = _jax_fwd(q, k, v, True, (16, 16), W)
    np.testing.assert_allclose(o_t[:, ~empty], o_j[:, ~empty], **TOL)
    np.testing.assert_allclose(lse_t[:, :, ~empty], lse_j[:, :, ~empty],
                               **TOL)


def test_torch_flash_rejects_mixed_dtypes():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 16, 2, 8).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 16, 2, 8).astype(np.float32))
    with pytest.raises(ValueError, match="share one dtype"):
        tfa.flash_attention(q, k.bfloat16(), k.bfloat16(), causal=True)


def test_torch_flash_gradient_raises():
    """No silent plain backward: a call that needs a gradient raises until
    the backward kernels are ported."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 1, 16, 16, 2, 2, 8))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v, causal=True).shape == q.shape


def test_torch_flash_cpu_uses_plain_and_counts_no_launch():
    """A CPU tensor runs the plain version and never counts a launch."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 1, 20, 20, 4, 2, 8))
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert tfa.flash_attention_fwd.launches == before


def test_torch_flash_bf16_plain_close_to_f32():
    """bf16 operands through the plain version stay within bf16 rounding of
    the float32 answer (p is rounded to bf16 before p.v, like the
    kernel)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(9, 2, 64, 64, 4, 1, 32))
    o32, lse32 = tfa.flash_attention_fwd(q, k, v, causal=True)
    o16, lse16 = tfa.flash_attention_fwd(q.bfloat16(), k.bfloat16(),
                                         v.bfloat16(), causal=True)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    torch.testing.assert_close(o16.float(), o32, atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(lse16, lse32, atol=3e-2, rtol=3e-2)
