"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version on the same inputs, and the tiny model served and trained on the
card against the CPU.  Marked ``cuda``; every test skips on a
machine without a card.  Run on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda`` (this file imports
no JAX, so it runs where JAX is not installed).

Tolerances: float32 1e-4 (same arithmetic, different summation order and
exp/log implementations); bfloat16 2e-2 on o (p is rounded to bfloat16
before p.v at a different running max in the kernel's online softmax than
in the dense plain version, so the rounding points differ), 1e-4 on lse
(float32 on both sides).  The backward's dq, dk and dv: 1e-4 in float32
and 2e-2 in bfloat16, both relative to the largest reference value of the
three (ds is rounded to bfloat16 from f32 sums taken in another order, so
an element near a rounding boundary may round the other way, and the
outputs are bfloat16; one scale for the three because dq can be all
rounding noise, as with a single key, where ds = p (dp - delta) cancels).
"""

import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.serve import ContinuousBatcher, Replica


@pytest.fixture()
def cuda_device():
    """The card; decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


# The edges of the bfloat16 kernels' tiles (128 rows; the dq kernel's k
# tiles are 64): Tq = Tk one past a 64-row tile, one short of, one past and
# one past two 128-row tiles, causal and not, D 64 and 128, GQA rep 1 and 8
# (one kv head).
TILE_EDGES = [((1, T, T, rep, 1, D), torch.bfloat16, causal, None)
              for T in (65, 127, 129, 257) for causal in (True, False)
              for D in (64, 128) for rep in (1, 8)]
# A causal window that is a multiple of neither tile size: a row's first
# key, and a block's first live k tile, fall mid-tile.
WINDOW_MID_TILE = [((1, 257, 257, 8, 1, D), torch.bfloat16, True, 100)
                   for D in (64, 128)]


def _inputs(seed, B, Tq, Tk, H, K, D, device, dtype):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, T, h, D).astype(np.float32))
                 .to(device, dtype)
                 for T, h in ((Tq, H), (Tk, K), (Tk, K)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal,window", [
    ((2, 130, 130, 8, 2, 128), torch.bfloat16, True, None),
    ((2, 130, 130, 8, 2, 128), torch.float32, True, None),
    ((1, 300, 200, 4, 4, 64), torch.float32, False, None),
    ((1, 200, 200, 4, 1, 128), torch.bfloat16, True, 48),
    ((1, 160, 40, 2, 1, 64), torch.float32, True, 16),   # empty rows
    ((1, 1, 1, 4, 4, 64), torch.bfloat16, True, None),   # one row
    ((3, 77, 77, 16, 2, 128), torch.bfloat16, True, None),   # rep 8
    ((2, 64, 64, 4, 4, 64), torch.bfloat16, False, None),    # exact tile
    ((1, 100, 300, 4, 2, 128), torch.float32, True, None),   # Tq < Tk
] + TILE_EDGES + WINDOW_MID_TILE)
def test_torch_flash_kernel_matches_plain(cuda_device, shape, dtype, causal,
                                          window):
    B, Tq, Tk, H, K, D = shape
    q, k, v = _inputs(5, B, Tq, Tk, H, K, D, cuda_device, dtype)
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_torch_flash_kernel_takes_strided_views(cuda_device):
    """q/k/v as views into wider tensors (head and row strides that are
    not those of a contiguous [B, T, H, D]) give the plain version's
    answer: the kernel reads through the strides it is given."""
    B, T, H, K, D = 2, 96, 4, 2, 64
    big = torch.from_numpy(np.random.RandomState(3).randn(
        B, T, H + 2 * K + 3, D).astype(np.float32)).to(cuda_device)
    q, k, v = big[:, :, :H], big[:, :, H:H + K], big[:, :, H + K:H + 2 * K]
    assert not q.is_contiguous()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(o, o_p, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_torch_flash_kernel_takes_strided_bf16_views(cuda_device):
    """bfloat16 q/k/v as head slices of a wider tensor go to TMA as they lie
    (their strides are multiples of 16 bytes) and give the plain answer."""
    B, T, H, K, D = 2, 200, 8, 2, 128
    big = torch.from_numpy(np.random.RandomState(4).randn(
        B, T, H + 2 * K + 3, D).astype(np.float32)).to(cuda_device,
                                                       torch.bfloat16)
    q, k, v = big[:, :, :H], big[:, :, H:H + K], big[:, :, H + K:H + 2 * K]
    assert not q.is_contiguous() and all(tfa.tma_ok(x) for x in (q, k, v))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), o_p.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_torch_flash_kernels_copy_unaligned_bf16_operands(cuda_device):
    """bfloat16 operands at an odd storage offset (a base TMA refuses) are
    copied by the wrapper and still give the plain answers, forward and
    backward, with one launch of each kernel."""
    B, T, H, K, D = 1, 150, 4, 2, 64
    sizes = (B * T * H * D, B * T * K * D, B * T * K * D)
    store = torch.from_numpy(np.random.RandomState(5).randn(
        1 + sum(sizes)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    offs = 1 + np.cumsum((0,) + sizes[:2])     # odd: 2-byte aligned bases
    q, k, v = (store.as_strided((B, T, h, D), (T * h * D, h * D, D, 1),
                                int(off)) for h, off in zip((H, K, K), offs))
    do = torch.from_numpy(np.random.RandomState(6).randn(
        B, T, H, D).astype(np.float32)).to(cuda_device, torch.bfloat16)
    assert not any(tfa.tma_ok(x) for x in (q, k, v))
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert tfa.flash_attention_fwd.launches == before + 1
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), o_p.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    out = tfa.flash_attention_bwd(q, k, v, do, lse, delta, causal=True)
    ref = tfa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=True)
    _assert_rel_close(out, ref, 2e-2)


@pytest.mark.cuda
def test_torch_flash_dkv_bf16_rep8_is_bitwise_reproducible(cuda_device):
    """The bfloat16 dk/dv kernel sums the 8 q heads of each kv head inside
    one block, in a fixed order: a second call is bitwise equal."""
    q, k, v, do, lse, delta = _bwd_inputs(9, (1, 1000, 1000, 16, 2, 128),
                                          torch.bfloat16, True, None,
                                          cuda_device)
    ops = tfa._bwd_operands(q, k, v, do, lse, delta)
    first = tfa._launch_dkv(*ops, True, 128 ** -0.5, None)
    again = tfa._launch_dkv(*ops, True, 128 ** -0.5, None)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_torch_flash_dq_bf16_rep8_is_bitwise_reproducible(cuda_device):
    """The bfloat16 dq kernel sums every key of a row inside one block, in
    a fixed order and without atomics: a second call is bitwise equal, at
    rep 8 as at any other."""
    q, k, v, do, lse, delta = _bwd_inputs(9, (1, 1000, 1000, 16, 2, 128),
                                          torch.bfloat16, True, None,
                                          cuda_device)
    ops = tfa._bwd_operands(q, k, v, do, lse, delta)
    first = tfa._launch_dq(*ops, True, 128 ** -0.5, None)
    again = tfa._launch_dq(*ops, True, 128 ** -0.5, None)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def _bf16_views(layout, B, T, H, K, D, device):
    """bfloat16 q, k, v, do as head slices of a wider tensor ("strided":
    strides TMA can map) or at an odd storage offset ("unaligned": a base
    TMA refuses, so the wrapper copies)."""
    rng = np.random.RandomState(12)
    if layout == "strided":
        big = torch.from_numpy(rng.randn(B, T, 2 * H + 2 * K + 3, D).astype(
            np.float32)).to(device, torch.bfloat16)
        cuts = np.cumsum((0, H, K, K, H))
        return tuple(big[:, :, a:b] for a, b in zip(cuts[:-1], cuts[1:]))
    heads = (H, K, K, H)
    store = torch.from_numpy(rng.randn(1 + B * T * D * sum(heads)).astype(
        np.float32)).to(device, torch.bfloat16)
    offs = 1 + np.cumsum((0,) + tuple(B * T * h * D for h in heads[:-1]))
    return tuple(store.as_strided((B, T, h, D), (T * h * D, h * D, D, 1),
                                  int(off)) for h, off in zip(heads, offs))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "unaligned"])
def test_torch_flash_dq_bf16_views_match_plain(cuda_device, layout):
    """dq (and dk/dv) of bfloat16 views, read through their strides or
    copied where TMA cannot map them, give the plain backward's answer
    with one launch of each kernel."""
    B, T, H, K, D = 2, 200, 8, 2, 128
    q, k, v, do = _bf16_views(layout, B, T, H, K, D, cuda_device)
    assert all(tfa.tma_ok(x) == (layout == "strided") for x in (q, k, v, do))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, window=100)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    before = (tfa.flash_attention_bwd.launches_dq,
              tfa.flash_attention_bwd.launches_dkv)
    out = tfa.flash_attention_bwd(q, k, v, do, lse, delta, causal=True,
                                  window=100)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd.launches_dq,
            tfa.flash_attention_bwd.launches_dkv) == (before[0] + 1,
                                                      before[1] + 1)
    ref = tfa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=True,
                                        window=100)
    _assert_rel_close(out, ref, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("kd", [64, 128])
def test_torch_wgmma_operand_layouts_match_matmul(cuda_device, mode, n, kd):
    """The layouts the bfloat16 kernels rely on, one product at a time:
    K-major operands through TMA and the 128B swizzle (mode 0, as q k^T)
    and an MN-major B with A from registers (mode 1, as p v), against
    torch.matmul in float32 (1e-4: bf16 products are exact in f32, only
    the order of the sums differs)."""
    g = torch.Generator(device=cuda_device).manual_seed(mode * 4 + n + kd)
    a = torch.randn(64, kd, generator=g, device=cuda_device).bfloat16()
    shape = (n, kd) if mode == 0 else (kd, n)
    b = torch.randn(*shape, generator=g, device=cuda_device).bfloat16()
    out = torch.zeros(64, n, device=cuda_device)
    err = tfa._lib("flash_fwd").hvd_wgmma_probe(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), mode, n, kd,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    ref = a.float() @ (b.float().t() if mode == 0 else b.float())
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_torch_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = _inputs(1, 1, 16, 16, 2, 2, 32, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, k, v, causal=True)
    q, k, v = _inputs(1, 1, 16, 16, 2, 2, 64, cuda_device, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention_fwd(q, k, v, causal=True)
    q, k, v = _inputs(1, 1, 16, 16, 2, 2, 64, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="contiguous in its head dim"):
        tfa.flash_attention_fwd(
            q.transpose(1, 3).contiguous().transpose(1, 3), k, v,
            causal=True)


@pytest.mark.cuda
def test_torch_serving_on_card_matches_cpu(cuda_device):
    """The tiny float32 model served on the card through Replica and the
    batcher gives the tokens the CPU gives, and its prefill launched the
    kernel once per layer.  head_dim 64: the kernel takes 64 or 128."""
    cfg = tl.tiny(dtype=torch.float32, d_model=256, n_heads=4,
                  n_kv_heads=2, d_ff=512)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.RandomState(4).randint(0, cfg.vocab_size,
                                               (3, 20)).astype(np.int32)
    ref = tl.generate(params, torch.from_numpy(prompts), 6, cfg).numpy()
    card = {k: ([{n: w.to(cuda_device) for n, w in lay.items()}
                 for lay in v] if k == "layers" else v.to(cuda_device))
            for k, v in params.items()}
    rep = Replica(lambda p, x: tl.generate(p, x, 6, cfg), device=cuda_device)
    rep.load(card, version=1)
    batcher = ContinuousBatcher(max_batch=4, buckets=(1, 2, 4),
                                max_inflight=1, deadline_ms=60000)
    reqs = [batcher.submit(p) for p in prompts]
    before = tfa.flash_attention_fwd.launches
    stop = threading.Event()
    th = threading.Thread(target=rep.serve_loop, args=(batcher, stop),
                          daemon=True)
    th.start()
    try:
        out = np.stack([r.wait(timeout=120) for r in reqs])
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive()
    np.testing.assert_array_equal(out, ref)
    assert tfa.flash_attention_fwd.launches - before == cfg.n_layers


def _bwd_inputs(seed, shape, dtype, causal, window, device):
    """q, k, v, do and the forward kernel's own lse with delta from o."""
    B, Tq, Tk, H, K, D = shape
    q, k, v = _inputs(seed, B, Tq, Tk, H, K, D, device, dtype)
    do = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        B, Tq, H, D).astype(np.float32)).to(device, dtype)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _assert_rel_close(out, ref, tol, names=("dq", "dk", "dv")):
    scale = max(b.float().abs().max().item() for b in ref)
    for name, a, b in zip(names, out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * max(scale, 1e-30), (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal,window", [
    ((2, 130, 130, 8, 2, 128), torch.bfloat16, True, None),
    ((2, 130, 130, 8, 2, 128), torch.float32, True, None),
    ((1, 300, 200, 4, 4, 64), torch.float32, False, None),
    ((1, 200, 200, 4, 1, 128), torch.bfloat16, True, 48),
    ((1, 160, 40, 2, 1, 64), torch.float32, True, 16),   # empty rows
    ((1, 1, 1, 4, 4, 64), torch.bfloat16, True, None),   # one row
    ((3, 77, 77, 16, 2, 128), torch.bfloat16, True, None),   # rep 8
    ((2, 64, 64, 4, 4, 64), torch.bfloat16, False, None),    # exact tile
    ((1, 100, 300, 4, 2, 128), torch.float32, True, None),   # Tq < Tk
] + TILE_EDGES + WINDOW_MID_TILE)
def test_torch_flash_bwd_kernels_match_plain(cuda_device, shape, dtype,
                                             causal, window):
    """dq and dk/dv kernels against the plain backward, each launched once
    per call, and bitwise equal on a second call (no atomics)."""
    q, k, v, do, lse, delta = _bwd_inputs(6, shape, dtype, causal, window,
                                          cuda_device)
    before = (tfa.flash_attention_bwd.launches_dq,
              tfa.flash_attention_bwd.launches_dkv)
    out = tfa.flash_attention_bwd(q, k, v, do, lse, delta, causal=causal,
                                  window=window)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd.launches_dq,
            tfa.flash_attention_bwd.launches_dkv) == (before[0] + 1,
                                                      before[1] + 1)
    ref = tfa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                        causal=causal, window=window)
    _assert_rel_close(out, ref, 2e-2 if dtype == torch.bfloat16 else 1e-4)
    again = tfa.flash_attention_bwd(q, k, v, do, lse, delta, causal=causal,
                                    window=window)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
def test_torch_flash_bwd_kernels_take_strided_views(cuda_device):
    """q/k/v as views into a wider tensor and an expanded cotangent (head
    dim stride 0) give the plain version's answer."""
    B, T, H, K, D = 2, 96, 4, 2, 64
    big = torch.from_numpy(np.random.RandomState(3).randn(
        B, T, H + 2 * K + 3, D).astype(np.float32)).to(cuda_device)
    q, k, v = big[:, :, :H], big[:, :, H:H + K], big[:, :, H + K:H + 2 * K]
    assert not q.is_contiguous()
    qkv = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    do = torch.full((1, 1, 1, 1), 0.5, device=cuda_device).expand_as(o)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    out = tfa.flash_attention_bwd(q, k, v, do, lse, delta, causal=True)
    ref = tfa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=True)
    _assert_rel_close(out, ref, 1e-4)
    # Through autograd: the cotangent of a sum is expanded too.
    (tfa.flash_attention(*qkv, causal=True) * 0.5).sum().backward()
    _assert_rel_close([x.grad for x in qkv], ref, 1e-4)


@pytest.mark.cuda
def test_torch_training_on_card_matches_cpu(cuda_device):
    """Two steps of make_train_step + DistributedOptimizer(SGD) on the tiny
    float32 model give the CPU's losses and parameters (1e-4: float32 on
    both sides, sums in another order), and each step launched the forward,
    dq and dk/dv kernels once per layer.  head_dim 64: the kernels take 64
    or 128."""
    cfg = tl.tiny(dtype=torch.float32, d_model=256, n_heads=4,
                  n_kv_heads=2, d_ff=512)
    hvd.init(device="cpu")    # size 1: the optimizer registers no hooks
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (2, 41)).astype(np.int64))
    runs = {}
    for dev in (torch.device("cpu"), cuda_device):
        params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        if dev.type == "cuda":
            params = {k: ([{n: w.detach().to(dev).requires_grad_(True)
                            for n, w in lay.items()} for lay in v]
                          if k == "layers" else
                          v.detach().to(dev).requires_grad_(True))
                      for k, v in params.items()}
        named = list(tl.named_parameters(params))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in named], lr=0.5),
            named_parameters=named)
        step = tl.make_train_step(cfg, opt)
        before = (tfa.flash_attention_fwd.launches,
                  tfa.flash_attention_bwd.launches_dq,
                  tfa.flash_attention_bwd.launches_dkv)
        x, y = toks[:, :-1].to(dev), toks[:, 1:].to(dev)
        losses = [float(step(params, x, y)) for _ in range(2)]
        after = (tfa.flash_attention_fwd.launches,
                 tfa.flash_attention_bwd.launches_dq,
                 tfa.flash_attention_bwd.launches_dkv)
        runs[dev.type] = (losses, [t.detach().cpu() for _, t in named],
                          [a - b for a, b in zip(after, before)])
    assert runs["cpu"][2] == [0, 0, 0]
    assert runs["cuda"][2] == [2 * cfg.n_layers] * 3
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ------------------------------------------------- fusion pack and unpack
# Bitwise against the plain versions in every case: a product of a value
# and a factor of its own dtype is exact in float32 (double for float64)
# and rounded once, a division is an IEEE division in the buffer's
# precision rounded once to it, and every cast rounds to nearest even, in
# the kernels and in PyTorch.  The byte path copies.
_F64, _I8, _U8 = torch.float64, torch.int8, torch.uint8
FUSION_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                (torch.float32, torch.float16), (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float16), (torch.float16, torch.float16),
                (torch.float16, torch.bfloat16), (torch.int32, torch.int32),
                (torch.int64, torch.int64), (_F64, _F64), (_F64, torch.bfloat16),
                (_F64, torch.float16), (_I8, _I8), (_U8, _U8)]
# Dtypes only the byte path carries: no factors, no division.
BYTE_ONLY = [torch.bool, torch.int16, torch.complex64, torch.complex128]
FUSION_CASES = ([(a, b, pre, post, div) for a, b in FUSION_PAIRS
                 for pre, post, div in ((None, None, 1), (0.5, 1 / 3, 3))]
                + [(d, d, None, None, 1) for d in BYTE_ONLY])
_INT_RANGE = {_I8: (-128, 128), _U8: (0, 256), torch.int16: (-32768, 32768)}


def _fusion_inputs(dt, shapes, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    if dt.is_floating_point or dt.is_complex:
        base = dt if dt in (_F64, torch.complex64, torch.complex128) \
            else torch.float32
        return [(torch.randn(s, generator=g, dtype=base) * 4).to(dt)
                .to(device) for s in shapes]
    if dt == torch.bool:
        return [torch.randint(0, 2, s, generator=g).bool().to(device)
                for s in shapes]
    lo, hi = _INT_RANGE.get(dt, (-1000, 1000))
    return [torch.randint(lo, hi, s, generator=g, dtype=dt).to(device)
            for s in shapes]


def _pack_unpack_match_plain(xs, buf, pre, post, divisor, outs=None):
    """One pack and one unpack launch, each bitwise the plain version."""
    from horovod_tpu_torch.ops import fusion
    n0 = (fusion.pack.launches, fusion.unpack.launches)
    b = fusion.pack(xs, buf, pre)
    outs = [torch.empty_like(x) for x in xs] if outs is None else outs
    fusion.unpack(b, outs, divisor, post)
    torch.cuda.synchronize()
    assert (fusion.pack.launches, fusion.unpack.launches) == (n0[0] + 1,
                                                              n0[1] + 1)
    ref_b = fusion.pack_plain([x.cpu() for x in xs], buf, pre)
    assert b.dtype == ref_b.dtype and torch.equal(b.cpu(), ref_b)
    ref_outs = [torch.empty_like(x.cpu()) for x in xs]
    fusion.unpack_plain(ref_b, ref_outs, divisor, post)
    for o, r in zip(outs, ref_outs):
        assert torch.equal(o.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("src,buf,pre,post,divisor", FUSION_CASES,
                         ids=[f"{a}-{b}-{d}".replace("torch.", "")
                              for a, b, _, _, d in FUSION_CASES])
def test_torch_fusion_kernels_match_plain(cuda_device, src, buf, pre, post,
                                          divisor):
    shapes = [(3, 5), (0,), (1000,), (7, 1, 9), (257,)]
    _pack_unpack_match_plain(_fusion_inputs(src, shapes, cuda_device), buf,
                             pre, post, divisor)


def _shifted(dt, numels, device, seed):
    """Views whose bases lie 1-7 elements past an aligned one."""
    return [x[1 + k % 7:] for k, x in enumerate(_fusion_inputs(
        dt, [(1 + k % 7 + n,) for k, n in enumerate(numels)], device, seed))]


@pytest.mark.cuda
@pytest.mark.parametrize("src,buf", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16),
                                     (torch.int32, torch.int32)])
@pytest.mark.parametrize("pre,post,divisor", [(None, None, 1),
                                              (0.5, 1 / 3, 2)])
def test_torch_fusion_kernels_alignment_sweep(cuda_device, src, buf, pre,
                                              post, divisor):
    """Numels 1, 7, 8, 9, 4095 and 4097 with an empty tensor between, every
    input and output base 1-7 elements past an aligned one: the kernels'
    scalar heads and tails and their realigned 16-byte body."""
    numels = (1, 7, 8, 9, 0, 4095, 4097)
    _pack_unpack_match_plain(_shifted(src, numels, cuda_device, 1), buf, pre,
                             post, divisor,
                             outs=_shifted(src, numels, cuda_device, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dt,numels", [
    (torch.uint8, (16 * 4096, 0, 16 * 1000, 48 * 10**6 + 7)),
    (torch.bfloat16, (8 * 3, 8 * 10**6, 13)),
    (torch.complex64, (2 * 5, 2**22 + 1))],
    ids=["uint8", "bfloat16", "complex64"])
def test_torch_fusion_bulk_copies_match_plain(cuda_device, dt, numels):
    """Tensors on the allocator's 16-byte boundaries, each but the last a
    whole number of 16 bytes: the byte path's bulk copies, with a ragged
    end, an empty tensor, and enough chunks that every stage of the ring
    is reused."""
    xs = _fusion_inputs(dt, [(n,) for n in numels], cuda_device, 5)
    _pack_unpack_match_plain(xs, dt, None, None, 1)


@pytest.mark.cuda
def test_torch_fusion_kernels_past_2gb(cuda_device):
    """Two bf16 tensors of 1.2 GB each: offsets past 2^31 bytes, and an
    element of the second tensor past 2^31 bytes into the buffer, land
    where the plain version puts them."""
    from horovod_tpu_torch.ops import fusion
    n = 600_000_000
    xs = [torch.full((n,), 3.0, dtype=torch.bfloat16, device=cuda_device),
          torch.full((n,), -5.0, dtype=torch.bfloat16, device=cuda_device)]
    xs[0][::99_999_989] = 7.0
    xs[1][-1] = 11.0
    b = fusion.pack(xs, torch.bfloat16, 0.5)
    outs = [torch.empty_like(x) for x in xs]
    fusion.unpack(b, outs, 2, 2.0)
    torch.cuda.synchronize()
    assert b.numel() * b.element_size() > 2 ** 31
    for x, o in zip(xs, outs):
        want = fusion.pack_plain([x], torch.bfloat16, 0.5) / 2 * 2
        assert torch.equal(o, want)
    assert b[n].item() == -2.5 and b[-1].item() == 5.5 and b[0].item() == 3.5


@pytest.mark.cuda
def test_torch_fusion_takes_unaligned_refuses_strided(cuda_device):
    """A view one element past an aligned base goes to the kernel as it is;
    a strided view is refused by the wrapper and copied by the engine."""
    from horovod_tpu_torch.ops import fusion
    base = _fusion_inputs(torch.bfloat16, [(1001,)], cuda_device)[0]
    view = base[1:]
    assert view.data_ptr() % 4 != 0
    b = fusion.pack([view], torch.bfloat16, 0.5)
    assert torch.equal(b.cpu(), fusion.pack_plain([view.cpu()],
                                                  torch.bfloat16, 0.5))
    strided = base[:1000].view(40, 25).t()
    with pytest.raises(ValueError, match="contiguous"):
        fusion.pack([strided], torch.bfloat16)


@pytest.mark.cuda
def test_torch_engine_round_trip_on_card(cuda_device, monkeypatch):
    """Size 1 on the card: grouped allreduce (mixed dtypes, wire bf16,
    factors), in-place on strided and unaligned views, and
    broadcast_parameters, each equal to the CPU engine's result; one pack
    and one unpack launch per dtype group."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import fusion
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    xs = (_fusion_inputs(torch.float32, [(4, 6), (33,)], "cpu", 1)
          + _fusion_inputs(torch.bfloat16, [(17,)], "cpu", 2)
          + _fusion_inputs(torch.int32, [(5,)], "cpu", 3))
    results = {}
    for dev in ("cpu", cuda_device):
        monkeypatch.setattr(basics, "_state", basics.GlobalState())
        hvd.init(device=dev)
        eng = basics._get_state().engine
        n0 = (fusion.pack.launches, fusion.unpack.launches, eng.fused_groups)
        outs = hvd.grouped_allreduce([x.to(dev) for x in xs], op=hvd.Sum,
                                     prescale_factor=0.5,
                                     postscale_factor=1 / 3)
        base = xs[0].to(dev).clone().t()
        hvd.allreduce_(base, op=hvd.Sum, postscale_factor=2.0)
        unaligned = xs[1].to(dev).clone()[1:]
        hvd.allreduce_(unaligned, op=hvd.Sum, prescale_factor=0.5)
        params = {"w": xs[0].to(dev).clone(), "l": [xs[3].to(dev).clone()]}
        assert hvd.broadcast_parameters(params) is params
        results[str(dev)] = [t.cpu() for t in outs + [base, unaligned,
                                                      params["w"]]]
        if dev != "cpu":
            torch.cuda.synchronize()
            groups = eng.fused_groups - n0[2]
            assert groups == 3 + 1 + 1 + 2
            assert (fusion.pack.launches - n0[0],
                    fusion.unpack.launches - n0[1]) == (groups, groups)
        hvd.shutdown()
    for a, b in zip(results["cpu"], results[str(cuda_device)]):
        assert torch.equal(a, b)


def _init_on(dev, monkeypatch):
    from horovod_tpu_torch.common import basics
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(basics, "_state", basics.GlobalState())
    hvd.init(device=dev)
    return basics._get_state().engine


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int8,
                                   torch.int16, torch.float64,
                                   torch.complex64, torch.complex128])
def test_torch_broadcast_carries_dtype_on_card(cuda_device, monkeypatch,
                                               dtype):
    """broadcast_ and broadcast_parameters of a dtype the byte path
    carries, through the engine on the card: the tensor's own bytes, one
    pack and one unpack launch a dtype group."""
    from horovod_tpu_torch.ops import fusion
    eng = _init_on(cuda_device, monkeypatch)
    try:
        x, y = _fusion_inputs(dtype, [(37, 3), (1001,)], cuda_device, 4)
        want = (x.clone(), y.clone())
        n0 = (fusion.pack.launches, fusion.unpack.launches, eng.fused_groups)
        assert hvd.broadcast_(x, root_rank=0) is x
        params = {"w": y, "b": [torch.ones(5, device=cuda_device)]}
        assert hvd.broadcast_parameters(params) is params
        torch.cuda.synchronize()
        assert torch.equal(x, want[0]) and torch.equal(params["w"], want[1])
        groups = eng.fused_groups - n0[2]
        assert groups == 1 + 2
        assert (fusion.pack.launches - n0[0],
                fusion.unpack.launches - n0[1]) == (groups, groups)
    finally:
        hvd.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bool, torch.int16, torch.complex64])
def test_torch_allreduce_refuses_on_card(cuda_device, monkeypatch, dtype):
    """The card refuses at submission only what the JAX engine refuses, a
    complex Average, naming it, and nothing reaches the cycle; a bool or
    int16 Average gives the JAX engine's dtype (int32 counts, int16) and
    the CPU engine's values."""
    x = _fusion_inputs(dtype, [(4,)], "cpu")[0]
    if dtype.is_complex:
        eng = _init_on(cuda_device, monkeypatch)
        try:
            with pytest.raises(TypeError,
                               match=str(dtype).replace("torch.", "")):
                hvd.allreduce(x.to(cuda_device))
            assert eng.pipeline_dispatches == 0
        finally:
            hvd.shutdown()
        return
    got = []
    for dev in ("cpu", cuda_device):
        _init_on(dev, monkeypatch)
        try:
            got.append(hvd.allreduce(x.to(dev)).cpu())
        finally:
            hvd.shutdown()
    want = torch.int32 if dtype == torch.bool else dtype
    assert got[0].dtype == got[1].dtype == want
    assert torch.equal(got[0], got[1])


# The promoting casts of an allreduce and a reducescatter: widening in the
# pack kernel, narrowing (then floor division) or an integer buffer into
# float32 (then division) in the unpack kernel.
PROMOTE_PACK = [torch.bool, _I8, _U8, torch.int16]
PROMOTE_UNPACK = [(torch.int32, torch.int16, 1), (torch.int32, torch.int16, 2),
                  (torch.int32, torch.float32, 2), (_I8, torch.float32, 2),
                  (_U8, torch.float32, 2), (torch.int64, torch.float32, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("src", PROMOTE_PACK,
                         ids=[str(d)[6:] for d in PROMOTE_PACK])
def test_torch_fusion_widening_pack_matches_plain(cuda_device, src):
    from horovod_tpu_torch.ops import fusion
    xs = _fusion_inputs(src, [(3, 5), (0,), (1000,), (257,)], cuda_device)
    b = fusion.pack(xs, torch.int32)
    torch.cuda.synchronize()
    ref = fusion.pack_plain([x.cpu() for x in xs], torch.int32, None)
    assert b.dtype == torch.int32 and torch.equal(b.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("buf,out,divisor", PROMOTE_UNPACK,
                         ids=[f"{str(b)[6:]}-{str(o)[6:]}-{d}"
                              for b, o, d in PROMOTE_UNPACK])
def test_torch_fusion_narrowing_unpack_matches_plain(cuda_device, buf, out,
                                                     divisor):
    """int32 sums past int16's range wrap before the floor division, as
    the JAX program's int16 sum does."""
    from horovod_tpu_torch.ops import fusion
    lo, hi = (-70000, 70000) if buf == torch.int32 else \
        _INT_RANGE.get(buf, (-1000, 1000))
    g = torch.Generator().manual_seed(3)
    b = torch.randint(lo, hi, (2301,), generator=g, dtype=buf)
    outs = [torch.empty(n, dtype=out, device=cuda_device)
            for n in (1000, 0, 1301)]
    fusion.unpack(b.to(cuda_device), outs, divisor)
    torch.cuda.synchronize()
    ref = [torch.empty(o.shape, dtype=out) for o in outs]
    fusion.unpack_plain(b, ref, divisor, None)
    for o, r in zip(outs, ref):
        assert torch.equal(o.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [1, 2, 3])
def test_torch_fusion_narrow_divide_unpack_matches_plain(cuda_device,
                                                         divisor):
    """An int32 buffer of int16 sums into float32 outputs: narrowed to
    int16 (wrapping) before the division, as a reducescatter's int16
    ``Average`` in the JAX program wraps before its ``/``."""
    from horovod_tpu_torch.ops import fusion
    g = torch.Generator().manual_seed(5)
    b = torch.randint(-70000, 70000, (2301,), generator=g, dtype=torch.int32)
    outs = [torch.empty(n, dtype=torch.float32, device=cuda_device)
            for n in (1000, 0, 1301)]
    fusion.unpack(b.to(cuda_device), outs, divisor, narrow=torch.int16)
    torch.cuda.synchronize()
    ref = [torch.empty(o.shape) for o in outs]
    fusion.unpack_plain(b, ref, divisor, None, torch.int16)
    for o, r in zip(outs, ref):
        assert torch.equal(o.cpu(), r)


@pytest.mark.cuda
def test_torch_reducescatter_dtypes_on_card(cuda_device, monkeypatch):
    """Size 1 on the card, each reducescatter of bool, int8, uint8, int16
    and complex64 under every op the JAX engine takes equal to the CPU
    engine's, in value and dtype (bool ``Sum``/``Average`` raise on
    both)."""
    ops = ("Sum", "Average", "Min", "Max", "Product")
    xs = {dt: _fusion_inputs(dt, [(6, 3)], "cpu", 7)[0]
          for dt in (torch.bool, _I8, _U8, torch.int16, torch.complex64)}
    results = {}
    for dev in ("cpu", cuda_device):
        _init_on(dev, monkeypatch)
        try:
            got = {}
            for dt, x in xs.items():
                for op in ops:
                    try:
                        got[(dt, op)] = hvd.reducescatter(
                            x.to(dev), op=getattr(hvd, op)).cpu()
                    except TypeError:
                        got[(dt, op)] = None
            results[str(dev)] = got
        finally:
            hvd.shutdown()
    cpu, card = results["cpu"], results[str(cuda_device)]
    assert [k for k, v in cpu.items() if v is None] == [
        (torch.bool, "Sum"), (torch.bool, "Average")]
    for k, a in cpu.items():
        r = card[k]
        assert (a is None) == (r is None), k
        if a is not None:
            assert a.dtype == r.dtype and torch.equal(a, r), k


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32, torch.int32])
def test_torch_fusion_rank_major_layouts_match_plain(cuda_device, dt):
    """The reducescatter/alltoall pack (world × N source views, rank-major)
    and the allgather unpack (world × N destination views) at a world of
    two, each one launch, bitwise the plain version."""
    from horovod_tpu_torch.ops import engine, fusion
    xs = _fusion_inputs(dt, [(6, 5), (2, 3), (4, 1001)], cuda_device, 7)
    sizes = engine._rows(xs, 2)
    n0 = (fusion.pack.launches, fusion.unpack.launches)
    b = fusion.pack(engine._views(xs, sizes, 2), dt)
    # Two ranks' allgather buffers (here the same tensors twice).
    g = torch.cat([fusion.pack(xs, dt)] * 2)
    outs = [torch.empty((2 * x.shape[0],) + x.shape[1:], dtype=dt,
                        device=cuda_device) for x in xs]
    fusion.unpack(g, engine._views(outs, [x.numel() for x in xs], 2))
    torch.cuda.synchronize()
    assert (fusion.pack.launches - n0[0], fusion.unpack.launches - n0[1]) \
        == (2, 1)
    cpu = [x.cpu() for x in xs]
    ref = torch.cat([x.reshape(2, -1)[q] for q in range(2) for x in cpu])
    assert torch.equal(b.cpu(), ref)
    for o, x in zip(outs, cpu):
        assert torch.equal(o.cpu(), torch.cat([x, x]))


@pytest.mark.cuda
def test_torch_collectives_round_trip_on_card(cuda_device, monkeypatch):
    """Size 1 on the card, each result equal to the CPU engine's: an
    allgather, a grouped reducescatter (Sum, and an int32 Average that
    returns float32), an even and a ragged alltoall, allgather_object, a
    bool Sum and uint8 Product (int32 and uint32 results), a complex Sum
    and Product; one pack and one unpack launch a dtype group."""
    from horovod_tpu_torch.ops import fusion
    x = _fusion_inputs(torch.float32, [(4, 6)], "cpu", 1)[0]
    i = _fusion_inputs(torch.int32, [(6, 2)], "cpu", 2)[0]
    b = _fusion_inputs(torch.bool, [(9,)], "cpu", 3)[0]
    u = _fusion_inputs(_U8, [(9,)], "cpu", 4)[0]
    c = _fusion_inputs(torch.complex64, [(5,)], "cpu", 5)[0]
    results = {}
    for dev in ("cpu", cuda_device):
        eng = _init_on(dev, monkeypatch)
        try:
            n0 = (fusion.pack.launches, fusion.unpack.launches,
                  eng.fused_groups)
            out = [hvd.allgather(x.to(dev))]
            out += hvd.grouped_reducescatter([x.to(dev), i.to(dev)])
            out.append(hvd.reducescatter(i.to(dev), op=hvd.Average))
            out.append(hvd.alltoall(i.to(dev)))
            out += list(hvd.alltoall(x.to(dev), splits=[4]))
            out += [hvd.allreduce(b.to(dev), op=hvd.Sum),
                    hvd.allreduce(u.to(dev), op=hvd.Product),
                    hvd.allreduce(c.to(dev), op=hvd.Sum),
                    hvd.allreduce(c.to(dev), op=hvd.Product)]
            assert hvd.allgather_object({"d": str(dev)[:3]}) == [
                {"d": str(dev)[:3]}]
            results[str(dev)] = [t.cpu() for t in out]
            if dev != "cpu":
                torch.cuda.synchronize()
                groups = eng.fused_groups - n0[2]
                assert (fusion.pack.launches - n0[0],
                        fusion.unpack.launches - n0[1]) == (groups, groups)
        finally:
            hvd.shutdown()
    for a, r in zip(results["cpu"], results[str(cuda_device)]):
        assert a.dtype == r.dtype and torch.equal(a, r)
    assert [t.dtype for t in results["cpu"][-4:]] == [
        torch.int32, torch.uint32, torch.complex64, torch.complex64]


# ------------------------------------------------------------ model families
def _to_card(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_card(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_card(v, dev) for v in tree]
    return tree.detach().to(dev)


def _family_case(family):
    """``(params, run(params, device) -> output, flash forward launches a
    call)`` of one family in float32 at a small size; the transformers at
    head_dim 64, which the kernels take."""
    from horovod_tpu_torch.models import bert as tb, gpt2 as tg
    from horovod_tpu_torch.models import mnist as tm, resnet as tr
    from horovod_tpu_torch.models import vit as tv
    gen = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(1)
    if family.startswith("resnet"):
        depth, train = {"resnet18-train": (18, True),
                        "resnet50-eval": (50, False)}[family]
        cfg = tr.ResNetConfig(depth=depth, width=8, num_classes=10,
                              compute_dtype=torch.float32)
        params, stats = tr.init_params(cfg, gen)
        x = torch.from_numpy(rng.randn(4, 33, 33, 3).astype(np.float32))
        return (params, lambda p, d: tr.forward(
            p, _to_card(stats, d), x.to(d), cfg, train)[0], 0)
    if family == "mnist":
        x = torch.from_numpy(tm.synthetic_batch(8, seed=2)[0])
        return tm.init_params(gen), lambda p, d: tm.forward(p, x.to(d)), 0
    wide = dict(dtype=torch.float32, d_model=256, n_heads=4, d_ff=512)
    if family == "vit":
        cfg = tv.tiny(**wide)
        x = torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))
        return (tv.init_params(cfg, gen),
                lambda p, d: tv.logits(p, x.to(d), cfg), cfg.n_layers)
    mod = {"bert": tb, "gpt2": tg}[family]
    cfg = mod.tiny(**wide)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 40)))
    return (mod.init_params(cfg, gen),
            lambda p, d: mod.forward(p, toks.to(d), cfg), cfg.n_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["resnet18-train", "resnet50-eval",
                                    "mnist", "bert", "vit", "gpt2"])
def test_torch_model_forward_on_card_matches_cpu(cuda_device, family):
    """Each family's forward on the card against its CPU run, float32
    within 1e-4 (sums in another order; TF32 off), the transformers'
    attention through the flash forward kernel once a layer."""
    torch.backends.cudnn.allow_tf32 = False
    params, run, layers = _family_case(family)
    with torch.no_grad():
        ref = run(params, torch.device("cpu"))
        before = tfa.flash_attention_fwd.launches
        out = run(_to_card(params, cuda_device), cuda_device)
        torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches - before == layers
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------ Adasum
# Lengths: empty, under one 16-byte vector, a vector and a tail, many
# blocks; an odd base offset takes the scalar path.
ADASUM_LENGTHS = [0, 1, 3, 4, 17, 1000, 4097, 1 << 20]


def _adasum_pair(n, dev, seed, offset=0):
    g = torch.from_numpy(np.random.RandomState(seed).randn(
        2 * (n + offset)).astype(np.float32)).to(dev)
    return g[offset:offset + n], g[n + 2 * offset:2 * n + 2 * offset]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", ADASUM_LENGTHS)
def test_torch_adasum_dots_match_plain_on_card(cuda_device, n, offset):
    """``hvd_adasum_dots`` against a float64 sum: k·r within 1e-5 of
    |k|·|r|, k·k and r·r within 1e-5 relative (float32 sums in another
    order); bitwise on a second call; one launch a call."""
    from horovod_tpu_torch.ops import adasum as ak
    k, r = _adasum_pair(n, cuda_device, n, offset)
    before = ak.dots.launches
    d1, d2 = ak.dots(k, r), ak.dots(k, r)
    torch.cuda.synchronize()
    assert ak.dots.launches == before + 2
    assert torch.equal(d1, d2)
    kd, rd = k.double().cpu(), r.double().cpu()
    ref = [float(kd @ rd), float(kd @ kd), float(rd @ rd)]
    got = d1.double().cpu().tolist()
    assert abs(got[0] - ref[0]) <= 1e-5 * np.sqrt(ref[1] * ref[2]) + 1e-30
    for g, w in zip(got[1:], ref[1:]):
        assert abs(g - w) <= 1e-5 * w + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("is_low", [True, False])
@pytest.mark.parametrize("n", ADASUM_LENGTHS)
def test_torch_adasum_combine_matches_plain_on_card(cuda_device, n, is_low,
                                                    offset):
    """``hvd_adasum_combine`` bitwise its plain version given the same
    triple, on the card and on the CPU (each product and the sum rounded
    once, the coefficients by one IEEE division each), in place too."""
    from horovod_tpu_torch.ops import adasum as ak
    k, r = _adasum_pair(n, cuda_device, 100 + n, offset)
    tri = ak.dots(k, r)
    before = ak.combine.launches
    got = ak.combine(k, r, tri, is_low)
    plain = ak.combine_plain(k, r, tri, is_low, torch.empty_like(k))
    cpu = ak.combine(k.cpu(), r.cpu(), tri.cpu(), is_low)
    inplace = k.clone()
    ak.combine(inplace, r, tri, is_low, out=inplace)
    torch.cuda.synchronize()
    assert ak.combine.launches == before + (2 if n else 0)
    assert torch.equal(got, plain) and torch.equal(got, inplace)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 8])
def test_torch_adasum_vhd_on_card_matches_cpu(cuda_device, n):
    """The VHD core of n simulated ranks (threads in lock step) on the
    card: every rank the same bits, within 1e-5 of the CPU run (the dots
    sum in another order), bitwise the two-level schedule where n has two
    levels, and two kernel launches of each a round."""
    from horovod_tpu_torch.ops import adasum as ak
    from horovod_tpu_torch.parallel import adasum as pad
    vals = np.random.RandomState(n).randn(n, 333).astype(np.float32)

    def run(dev, local=None):
        barrier, box, outs = threading.Barrier(n, timeout=30), {}, [None] * n

        def swapper(rank, ranks):
            def swap(send, out, peer):
                box[(rank, ranks[peer])] = send.clone()
                barrier.wait()
                out.copy_(box.pop((ranks[peer], rank)))
                barrier.wait()
            return swap

        def body(r):
            with torch.cuda.device(cuda_device):
                x = torch.from_numpy(vals[r]).to(dev)
                if local is None:
                    outs[r] = pad.adasum_allreduce_hd(
                        x, swapper(r, list(range(n))), r, n)
                else:
                    s, i = divmod(r, local)
                    c = n // local
                    outs[r] = pad.adasum_allreduce_hier(
                        x, (swapper(r, [s * local + j
                                        for j in range(local)]), i, local),
                        (swapper(r, [q * local + i for q in range(c)]), s,
                         c))
                if dev != "cpu":
                    torch.cuda.synchronize()
        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        return [o.cpu() for o in outs]

    before = (ak.dots.launches, ak.combine.launches)
    card = run(cuda_device)
    rounds = n.bit_length() - 1
    assert (ak.dots.launches - before[0],
            ak.combine.launches - before[1]) == (n * rounds, n * rounds)
    cpu = run("cpu")
    for o in card:
        assert torch.equal(o, card[0])
        np.testing.assert_allclose(o.numpy(), cpu[0].numpy(), rtol=1e-5,
                                   atol=1e-6)
    if n >= 4:
        for a, b in zip(card, run(cuda_device, local=2)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_torch_engine_reduce_phase_from_cuda_events(cuda_device):
    """Armed, each batch's reduce phase is the card's time between the
    CUDA events around its pack, collective and unpack: the parts add up
    in the engine's counters and the spans' reduce phase is above zero,
    with the phases partitioning the lifecycle.  Disarmed, no batch is
    timed."""
    from horovod_tpu_torch.trace import TraceRecorder
    hvd.init(device=cuda_device)
    try:
        eng = hvd.common.basics._get_state().engine
        xs = [torch.full((1 << 20,), float(i), device=cuda_device,
                         dtype=torch.bfloat16) for i in range(8)]
        assert eng.tracer is None
        hvd.grouped_allreduce(xs, name="off", op=hvd.Sum)
        torch.cuda.synchronize()
        assert eng.timed_batches == 0
        eng.tracer = TraceRecorder(capacity=256)
        for i in range(3):
            out = hvd.grouped_allreduce(xs, name=f"on.{i}", op=hvd.Sum)
        torch.cuda.synchronize()
        hvd.allreduce(torch.zeros(1, device=cuda_device), name="read")
        assert eng.timed_batches >= 3
        assert eng.reduce_pack_us_total > 0
        assert eng.reduce_unpack_us_total > 0
        s = eng.tracer.phase_summary()
        assert s["spans"] >= 24 and s["phases_us"]["reduce"] > 0
        assert abs(s["phase_sum_us"] - s["cycle_us"]) <= \
            0.05 * s["cycle_us"]
        for a, x in zip(out, xs):
            assert torch.equal(a, x)
    finally:
        eng.tracer = None
        hvd.shutdown()


@pytest.mark.cuda
def test_torch_profile_step_traces_the_card(cuda_device, tmp_path):
    """``hvd.profile_step`` writes a Chrome trace in which the fusion
    pack's kernel appears by name."""
    import json
    import re
    hvd.init(device=cuda_device)
    try:
        xs = [torch.randn(1 << 16, device=cuda_device) for _ in range(4)]
        with hvd.profile_step(str(tmp_path)):
            hvd.grouped_allreduce(xs, name="prof", prescale_factor=0.5)
            torch.cuda.synchronize()
    finally:
        hvd.shutdown()
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    names = [e["name"] for e in json.loads(files[0].read_text())[
        "traceEvents"] if e.get("cat") == "kernel"]
    assert any(re.search(r"walk_kernel<.*, true>", n) for n in names), \
        names[:20]


def _zero_tree(device):
    """A bf16 tree with a non-divisible leaf, a scalar and an empty leaf,
    and its AdamW gradient stream, from a seed."""
    rng = np.random.RandomState(11)
    shapes = [(257,), (16, 8), (), (66,), (0, 3), (4096, 33)]
    params = [torch.from_numpy(np.asarray(rng.randn(*s), np.float32)).to(
        device, torch.bfloat16).requires_grad_() for s in shapes]
    grads = [[torch.from_numpy(np.asarray(rng.randn(*s), np.float32)).to(
        device, torch.bfloat16) for s in shapes] for _ in range(5)]
    return params, grads


@pytest.mark.cuda
@pytest.mark.parametrize("foreach,fused", [(None, None), (False, None),
                                           (None, True)])
@pytest.mark.parametrize("sharded", [True, "full"])
def test_torch_sharded_optimizer_on_card_is_plain_adamw(cuda_device,
                                                        monkeypatch, sharded,
                                                        foreach, fused):
    """Size 1 on the card: ``DistributedOptimizer(AdamW, sharded=...)``
    through the engine's reduce-scatter and allgather (the fusion kernels)
    gives parameters bitwise those of plain AdamW after 5 steps, and its
    inner optimizers keep the user's foreach/fused choice."""
    from horovod_tpu_torch.ops import fusion
    _init_on(cuda_device, monkeypatch)
    try:
        kw = dict(lr=1e-2, weight_decay=0.01, foreach=foreach, fused=fused)
        ref, grads = _zero_tree(cuda_device)
        plain = torch.optim.AdamW(ref, **kw)
        for gs in grads:
            for p, g in zip(ref, gs):
                p.grad = g
            plain.step()
        ps, _ = _zero_tree(cuda_device)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(ps, **kw),
                                       sharded=sharded)
        n0 = fusion.pack.launches
        for gs in grads:
            if sharded == "full":
                opt.gather_params()
            for p, g in zip(ps, gs):
                p.grad = g
            opt.step()
        if sharded == "full":
            opt.gather_params()
        torch.cuda.synchronize()
        assert fusion.pack.launches > n0
        for a, b in zip(ref, ps):
            assert a.shape == b.shape
            assert torch.equal(a.detach().view(torch.int16),
                               b.detach().view(torch.int16))
        for o in opt._inner:
            g = o.param_groups[0]
            assert (g["foreach"], g["fused"]) == (foreach, fused)
            assert o.defaults["foreach"] == foreach
            assert o.defaults["fused"] == fused
    finally:
        hvd.shutdown()


# ------------------------------------------------- the data plane's depth
@pytest.fixture()
def card_engine(cuda_device, monkeypatch):
    """The port at size 1 on the card."""
    eng = _init_on(cuda_device, monkeypatch)
    yield hvd, eng
    hvd.shutdown()


@pytest.mark.cuda
def test_torch_chunked_and_partitioned_bitwise_on_card(card_engine):
    """Size 1 on the card: a grouped allreduce chunked at 4 KB (float32
    with a bf16 wire and factors, bf16, int32) and a partitioned one
    against the plain path, bitwise; pack and unpack launch once a
    chunk."""
    from horovod_tpu_torch.ops import fusion
    hvd, eng = card_engine
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(5000, generator=g, device="cuda"),
          torch.randn(77, 33, generator=g, device="cuda"),
          torch.randn(4097, generator=g, device="cuda").to(torch.bfloat16),
          torch.randint(-9, 9, (999,), generator=g, device="cuda",
                        dtype=torch.int32)]
    kw = dict(op=hvd.Average, prescale_factor=0.5, postscale_factor=3.0)
    base = hvd.grouped_allreduce([x.clone() for x in xs], name="b", **kw)
    eng.pipeline_chunk_bytes = 4096
    p0, c0 = fusion.pack.launches, eng.pipeline_chunks_total
    out = hvd.grouped_allreduce([x.clone() for x in xs], name="c", **kw)
    torch.cuda.synchronize()
    chunks = eng.pipeline_chunks_total - c0
    assert chunks > 4 and fusion.pack.launches - p0 == chunks
    for a, b in zip(base, out):
        assert torch.equal(a, b)
    eng.pipeline_chunk_bytes = 0
    eng.partition_threshold = 8192
    s0 = eng.partition_splits
    part = hvd.allreduce(xs[0].clone(), name="p", **kw)
    assert eng.partition_splits == s0 + 1
    eng.partition_threshold = 0
    assert torch.equal(part, hvd.allreduce(xs[0].clone(), name="q", **kw))


@pytest.mark.cuda
def test_torch_pingpong_buffer_reused_only_after_done_event(card_engine):
    """Size 1 on the card with a controller that finds everything ready,
    so that the in-flight window and its ping-pong slots are live: six
    batches of one dtype, the window's watcher held before its first
    wait.  Two batches take the two slots; the third waits for a slot
    until the first has settled, and every batch releases its slot only
    once its done event has fired; two staging buffers of the dtype
    exist, reused."""
    from horovod_tpu_torch.ops import eager
    hvd, eng = card_engine

    class Ready:
        rounds = 0

        def negotiate(self, entries):
            return list(entries), []

        def forget(self, e):
            pass

    released = []
    settle = eng._settle_batch

    def checked(batch, results, error=None, inflight=False):
        if id(batch) in eng._staging_tokens:
            released.append(error is None and results[1].query())
        settle(batch, results, error, inflight)

    gate = threading.Event()
    wait_done = eng._wait_done

    def held(results):
        gate.wait(30)
        wait_done(results)

    eng._settle_batch = checked
    eng._wait_done = held                    # before the window is made
    eng.controller = Ready()
    eng.fusion_threshold = 1                 # a batch a tensor
    x = torch.arange(1 << 22, dtype=torch.float32, device="cuda")
    hs = [eager.allreduce_async(x, name=f"pp.{i}", op=hvd.Sum)
          for i in range(6)]
    t_end = time.time() + 30
    while (eng._pingpong is None or eng._pingpong.in_flight(
            "torch.float32") < 2) and time.time() < t_end:
        time.sleep(0.01)
    time.sleep(0.3)
    pp = eng._pingpong
    assert pp.in_flight("torch.float32") == 2 and pp.acquires == 2
    gate.set()
    outs = [eager.synchronize(h) for h in hs]
    eng._inflight.flush(30)
    assert all(torch.equal(o, x) for o in outs)
    assert len(released) == 6 and all(released), released
    assert pp.waits >= 1 and pp.acquires == 6
    assert sorted(eng._staging) == [("torch.float32", 0),
                                    ("torch.float32", 1)]
    eng.controller = None
