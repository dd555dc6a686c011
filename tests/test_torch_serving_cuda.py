"""The serving surface on the card: the flash forward with a sliding window
at a mid-size prefill shape against its plain version, the rolling KV cache
against the full one, speculative decoding against greedy decoding, and the
Hugging Face round trip on card tensors.  Marked ``cuda``; every test skips
on a machine without a card.  Run on the card with ``python -m pytest
tests/test_torch_serving_cuda.py -m cuda`` (this file imports no JAX).

Tolerances: the kernel's bf16 output within 2e-2 and its lse within 1e-4
of the plain version (``chip_smoke.py``'s, for the same reasons); float32
models at head_dim 64 (the kernels' float32 path), whose rolling and full
decode logits agree within 1e-4 relative to the largest logit and whose
tokens agree exactly.
"""

import pytest
import torch

TOL = 1e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2),
                                       ("float32", 1e-4)])
def test_torch_windowed_forward_matches_plain(card, dtype, tol):
    """B=1, T=2048, 16/4 heads, D=128, causal, window 512 (a mid-size
    Mistral prefill: three of four k tiles of a late row skipped)."""
    from horovod_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(1, 2048, h, 128, generator=gen,
                           device=card).to(dt) for h in (16, 4, 4))
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=512)
    assert fa.flash_attention_fwd.launches == before + 1
    o_p, lse_p = fa.flash_attention_plain(q, k, v, causal=True, window=512)
    assert (o.float() - o_p.float()).abs().max().item() <= tol
    assert (lse - lse_p).abs().max().item() <= 1e-4


def _model(card, **kw):
    from horovod_tpu_torch.models import llama as tl
    cfg = tl.tiny(dtype=torch.float32, d_model=256, n_heads=4, n_kv_heads=2,
                  d_ff=512, max_seq=512, sliding_window=64, **kw)
    return cfg, tl.init_params(cfg, torch.Generator(device=card)
                               .manual_seed(0))


@pytest.mark.cuda
def test_torch_rolling_decode_matches_full_on_card(card):
    """A prompt of 100 tokens (past the 72-slot ring), then 40 tokens:
    the ring's prefill and decode logits against the full cache's, the
    tokens equal, and one flash launch a layer in each prefill."""
    import dataclasses
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    cfg, params = _model(card)
    roll = dataclasses.replace(cfg, rolling_cache=True)
    prompt = torch.randint(0, cfg.vocab_size, (2, 100), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(1))
    caches, logits = {}, {}
    for name, c in (("full", cfg), ("roll", roll)):
        caches[name] = tl.init_cache(c, 2, 140, device=card)
        fa.flash_attention_fwd.launches = 0
        logits[name], _ = tl.prefill(params, caches[name], prompt, c)
        assert fa.flash_attention_fwd.launches == cfg.n_layers
    assert tuple(caches["roll"][0]["k"].shape) == (2, 72, 2, 64)
    tok = logits["full"].argmax(-1).to(torch.int32)
    for pos in range(100, 140):
        lf, _ = tl.decode_step(params, caches["full"], tok, pos, cfg)
        lr, _ = tl.decode_step(params, caches["roll"], tok, pos, roll)
        rel = (lf - lr).abs().max().item() / lf.abs().max().item()
        assert rel <= TOL, (pos, rel)
        tok = lf.argmax(-1).to(torch.int32)
    full = tl.generate(params, prompt, 40, cfg)
    assert torch.equal(tl.generate(params, prompt, 40, roll), full)


@pytest.mark.cuda
def test_torch_speculative_matches_greedy_on_card(card):
    """Self-speculation and a one-layer draft on a rolling target: the
    greedy tokens, in float32."""
    import dataclasses
    from horovod_tpu_torch.models import llama as tl
    cfg, params = _model(card, rolling_cache=True)
    prompt = torch.randint(0, cfg.vocab_size, (2, 80), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(2))
    want = tl.generate(params, prompt, 24, cfg)
    draft_cfg = dataclasses.replace(cfg, n_layers=1)
    draft = {**params, "layers": params["layers"][:1]}
    for d, dc in ((params, cfg), (draft, draft_cfg)):
        got = tl.speculative_generate(params, d, prompt, 24, cfg,
                                      draft_cfg=dc, n_draft=4)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_torch_hf_round_trip_stays_on_card(card):
    from horovod_tpu_torch.models import convert
    cfg, params = _model(card)
    sd = convert.to_hf_state_dict(params, cfg)
    assert all(t.is_cuda for t in sd.values())
    back = convert.from_hf_state_dict(sd, cfg)
    for a, b in zip(params["layers"], back["layers"]):
        for key in a:
            assert b[key].is_cuda and torch.equal(a[key], b[key]), key
    assert torch.equal(params["lm_head"], back["lm_head"])
