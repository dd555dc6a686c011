"""Port parity: the port's Llama serving surface against the JAX model.

The JAX package's ``llama.tiny`` parameters (float32, every mesh axis off)
are carried into the port with ``params_from_jax``; token ids are made with
numpy from a seed.  ``forward``, ``prefill`` (logits and cache),
``decode_step`` and greedy ``generate`` are compared with JAX run both with
``use_flash=True`` (the Pallas kernel in interpret mode) and with
``use_flash=False`` (its jnp reference).  Tolerance 1e-4 on logits and
caches: float32 on both sides, with matmuls summed in another order by
XLA's CPU backend than by PyTorch's, through two layers.  Greedy tokens
must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu_torch.models import llama as tl

TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_cfg(use_flash, window=None):
    return jl.tiny(dtype=jnp.float32, dp_axis=None, tp_axis=None,
                   sp_axis=None, use_flash=use_flash, sliding_window=window)


def _models(use_flash, window=None, seed=0):
    jcfg = _jax_cfg(use_flash, window)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = tl.tiny(dtype=torch.float32, sliding_window=window)
    tparams = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, B, T, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(
        np.int32)


def test_torch_params_from_jax_keeps_layout():
    _, jparams, tcfg, tparams = _models(False)
    D, Hd = tcfg.d_model, tcfg.head_dim
    assert tuple(tparams["layers"][0]["wq"].shape) == (D, tcfg.n_heads * Hd)
    assert tuple(tparams["layers"][0]["wk"].shape) == (
        D, tcfg.n_kv_heads * Hd)
    assert tuple(tparams["lm_head"].shape) == (D, tcfg.vocab_size)
    np.testing.assert_array_equal(tparams["layers"][1]["w2"].numpy(),
                                  np.asarray(jparams["layers"][1]["w2"]))


def test_torch_params_from_jax_bf16():
    """bfloat16 leaves (ml_dtypes arrays) carry over bit for bit."""
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)
                               .reshape(3, 4), jnp.bfloat16))
    t = tl.params_from_jax({"w": a})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("window", [None, 6])
def test_torch_llama_forward_matches_jax(use_flash, window):
    jcfg, jparams, tcfg, tparams = _models(use_flash, window)
    toks = _tokens(1, 2, 24)
    ref = np.asarray(jl.forward(jparams, jnp.asarray(toks), jcfg))
    with torch.no_grad():
        out = tl.forward(tparams, torch.from_numpy(toks), tcfg).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("use_flash", [True, False])
def test_torch_llama_prefill_and_decode_match_jax(use_flash):
    jcfg, jparams, tcfg, tparams = _models(use_flash)
    B, T0, S = 2, 20, 32
    toks = _tokens(2, B, T0)
    jlog, jcache = jl.prefill(jparams, jl.init_cache(jcfg, B, S),
                              jnp.asarray(toks), jcfg)
    tlog, tcache = tl.prefill(tparams, tl.init_cache(tcfg, B, S),
                              torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for jc, tc in zip(jcache, tcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **TOL)
    nxt = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    jlog2, _ = jl.decode_step(jparams, jcache, jnp.asarray(nxt), T0, jcfg)
    tlog2, _ = tl.decode_step(tparams, tcache, torch.from_numpy(nxt), T0,
                              tcfg)
    np.testing.assert_allclose(tlog2.numpy(), np.asarray(jlog2), **TOL)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("window", [None, 6])
def test_torch_llama_generate_matches_jax(use_flash, window):
    jcfg, jparams, tcfg, tparams = _models(use_flash, window, seed=3)
    toks = _tokens(4, 3, 16)
    ref = np.asarray(jl.generate(jparams, jnp.asarray(toks), 8, jcfg,
                                 max_seq=32))
    out = tl.generate(tparams, torch.from_numpy(toks), 8, tcfg, max_seq=32)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_torch_llama_generate_default_cache_and_budget():
    """The default cache holds exactly the prompt plus the new tokens; a
    cache too small is refused, not written past."""
    _, _, tcfg, tparams = _models(False)
    toks = torch.from_numpy(_tokens(5, 1, 10))
    a = tl.generate(tparams, toks, 5, tcfg)
    b = tl.generate(tparams, toks, 5, tcfg, max_seq=64)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="KV cache"):
        tl.generate(tparams, toks, 5, tcfg, max_seq=12)


def test_torch_llama_sample_logits():
    """Greedy is argmax; sampling with top_k=1 is argmax too; nucleus and
    temperature draw only from the kept set, reproducibly per generator."""
    rng = np.random.RandomState(6)
    logits = torch.from_numpy(rng.randn(4, 50).astype(np.float32))
    greedy = tl.sample_logits(logits)
    assert torch.equal(greedy, logits.argmax(-1).to(torch.int32))
    g = torch.Generator().manual_seed(0)
    assert torch.equal(tl.sample_logits(logits, g, 1.0, top_k=1), greedy)
    top3 = torch.topk(logits, 3, dim=-1).indices
    for _ in range(5):
        s = tl.sample_logits(logits, g, 0.7, top_k=3).long()
        assert bool((top3 == s[:, None]).any(-1).all())
    a = tl.sample_logits(logits, torch.Generator().manual_seed(1), 1.0,
                         top_p=0.5)
    b = tl.sample_logits(logits, torch.Generator().manual_seed(1), 1.0,
                         top_p=0.5)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        tl.generate({}, torch.zeros((1, 2), dtype=torch.int32), 2,
                    tl.tiny(), temperature=1.0)


def test_torch_llama_init_params_is_seeded():
    cfg = tl.tiny(dtype=torch.float32)
    a = tl.init_params(cfg, torch.Generator().manual_seed(7))
    b = tl.init_params(cfg, torch.Generator().manual_seed(7))
    assert torch.equal(a["layers"][1]["wv"], b["layers"][1]["wv"])
    assert a["embed"].shape == (cfg.vocab_size, cfg.d_model)
    assert 0.05 < float(a["embed"].std()) * cfg.d_model ** 0.5 < 20
