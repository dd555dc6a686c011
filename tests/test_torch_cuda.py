"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version on the same inputs, and the tiny model served on the card against
the CPU.  Marked ``cuda``; every test skips on a
machine without a card.  Run on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda`` (this file imports
no JAX, so it runs where JAX is not installed).

Tolerances: float32 1e-4 (same arithmetic, different summation order and
exp/log implementations); bfloat16 2e-2 on o (p is rounded to bfloat16
before p.v at a different running max in the kernel's online softmax than
in the dense plain version, so the rounding points differ), 1e-4 on lse
(float32 on both sides).
"""

import threading

import numpy as np
import pytest
import torch

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
])
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
