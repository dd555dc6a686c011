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


def _bf16_storage(n, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(n).astype(
        np.float32)).bfloat16()


def test_torch_flash_tma_ok_accepts_aligned_views():
    """TMA eligibility of [B, T, heads, D] views: contiguous tensors, head
    slices of a wider tensor and a storage offset of 8 bf16 elements (16
    bytes) pass; a size-1 dimension's stride does not matter."""
    B, T, H, D = 2, 24, 4, 64
    big = _bf16_storage(B * T * 11 * D).reshape(B, T, 11, D)
    assert tfa.tma_ok(big[:, :, :H].contiguous())
    assert tfa.tma_ok(big[:, :, 3:3 + H])          # head slice: strides fine
    store = _bf16_storage(8 + B * T * H * D)
    assert tfa.tma_ok(store.as_strided((B, T, H, D),
                                       (T * H * D, H * D, D, 1), 8))
    one = store.as_strided((1, T, 1, D), (7, D, 3, 1), 0)
    assert tfa.tma_ok(one)


@pytest.mark.parametrize("view", ["row_stride", "odd_offset", "expanded"])
def test_torch_flash_tma_ok_refuses_what_tma_cannot_map(view):
    """A row stride that is not a multiple of 8 bf16 elements, an odd
    storage offset (a base not 16-byte aligned) and a stride-0 dimension
    are refused; the kernels' wrapper then copies the operand."""
    B, T, H, D = 2, 24, 4, 64
    store = _bf16_storage(16 + B * T * (H * D + 4))
    if view == "row_stride":
        x = store.as_strided((B, T, H, D), (T * (H * D + 4), H * D + 4, D, 1))
    elif view == "odd_offset":
        x = store.as_strided((B, T, H, D), (T * H * D, H * D, D, 1), 1)
    else:
        x = store[:D].reshape(1, 1, 1, D).expand(B, T, H, D)
    assert not tfa.tma_ok(x)
    fixed = tfa._tma_operand(x)
    assert tfa.tma_ok(fixed) and torch.equal(fixed, x)


def test_torch_flash_tma_operand_leaves_float32_alone():
    """Only bfloat16 goes through TMA: a float32 operand is never copied."""
    x = torch.zeros(1, 4, 2, 8).as_strided((1, 4, 2, 7), (64, 16, 8, 1), 1)
    assert tfa._tma_operand(x) is x


def test_torch_flash_plain_answers_unchanged_on_refused_views():
    """The plain versions give the same answer on a view TMA refuses as on
    its contiguous copy, forward and backward."""
    B, T, H, K, D = 1, 20, 4, 2, 64
    store = _bf16_storage(1 + 3 * B * T * (H + 1) * D, seed=4)

    def view(i, heads):
        off = 1 + i * B * T * (H + 1) * D
        return store.as_strided((B, T, heads, D),
                                (T * (H + 1) * D, (H + 1) * D, D, 1), off)

    q, k, v = view(0, H), view(1, K), view(2, K)
    assert not any(tfa.tma_ok(x) for x in (q, k, v))
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    o_c, lse_c = tfa.flash_attention_fwd(qc, kc, vc, causal=True)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    do = torch.ones_like(o)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    grads = tfa.flash_attention_bwd(q, k, v, do, lse, delta, causal=True)
    grads_c = tfa.flash_attention_bwd(qc, kc, vc, do, lse, delta, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_c))
