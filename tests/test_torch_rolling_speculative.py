"""Port parity: Llama's rolling KV cache, ``decode_chunk``, windowed
``prefill`` and ``speculative_generate`` against the JAX model (the
counterpart of ``tests/test_llama_parallel.py:466-630``).

The JAX package's ``llama.tiny`` parameters (float32, every mesh axis off)
are carried into the port with ``params_from_jax``; token ids are made with
numpy from a seed.  JAX runs its jnp attention (``use_flash=False``) for
the cached paths and its Pallas kernel in interpret mode for one windowed
prefill.  Tolerance 1e-4 on logits and caches (``tests/test_torch_llama.py``'s
``TOL``): float32 on both sides, matmuls summed in another order by XLA's CPU
backend than by PyTorch's, through two layers.  Tokens must agree exactly,
and in float32 speculative decoding must give greedy ``generate``'s tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu_torch.models import llama as tl

TOL = dict(atol=1e-4, rtol=1e-4)
W, SLACK = 8, 4          # the ring R = 12


def _cfgs(window=W, rolling=False, max_seq=64, use_flash=False, **kw):
    jcfg = jl.tiny(dtype=jnp.float32, dp_axis=None, tp_axis=None,
                   sp_axis=None, use_flash=use_flash, max_seq=max_seq,
                   sliding_window=window, rolling_cache=rolling,
                   rolling_slack=SLACK, **kw)
    tcfg = tl.tiny(dtype=torch.float32, max_seq=max_seq,
                   sliding_window=window, rolling_cache=rolling,
                   rolling_slack=SLACK, **kw)
    return jcfg, tcfg


def _params(jcfg, seed):
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _tokens(seed, B, T, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(
        np.int32)


def _caches_close(tcache, jcache):
    for tc, jc in zip(tcache, jcache):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tc[kv].numpy(), np.asarray(jc[kv]),
                                       **TOL)


def test_torch_mistral_7b_matches_jax_field_by_field():
    j, t = jl.mistral_7b(), tl.mistral_7b()
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "max_seq", "rope_theta", "sliding_window",
              "rolling_cache", "rolling_slack", "norm_eps", "n_experts"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.head_dim == j.head_dim == 128
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert tl.mistral_7b(n_layers=2, rolling_cache=True).n_layers == 2
    assert {f.name for f in dataclasses.fields(tl.LlamaConfig)} >= {
        "rolling_cache", "rolling_slack"}


@pytest.mark.parametrize("kw,match", [
    (dict(rolling_cache=True), "requires sliding_window"),
    (dict(rolling_cache=True, sliding_window=4, rolling_slack=0),
     "rolling_slack must be >= 1"),
])
def test_torch_rolling_config_refusals_match_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        jl.tiny(**kw)
    with pytest.raises(ValueError, match=match):
        tl.tiny(**kw)


@pytest.mark.parametrize("rolling", [False, True])
def test_torch_decode_chunk_matches_step_loop_and_jax(rolling):
    """decode_chunk over [B, Tq] against Tq decode_steps (the same logits
    and cache) and against the JAX decode_chunk, on the full cache and on
    the ring (the chunk's positions wrap past R)."""
    jcfg, tcfg = _cfgs(rolling=rolling)
    jparams, tparams = _params(jcfg, 41)
    B, T0, Tq = 2, 10, SLACK
    prompt, chunk = _tokens(42, B, T0), _tokens(43, B, Tq)

    _, jc = jl.prefill(jparams, jl.init_cache(jcfg, B, 32),
                       jnp.asarray(prompt), jcfg)
    jl_chunk, jc = jl.decode_chunk(jparams, jc, jnp.asarray(chunk), T0, jcfg)
    tc = tl.init_cache(tcfg, B, 32)
    tl.prefill(tparams, tc, torch.from_numpy(prompt), tcfg)
    ts = [{k: v.clone() for k, v in c.items()} for c in tc]
    tl_chunk, tc = tl.decode_chunk(tparams, tc, torch.from_numpy(chunk), T0,
                                   tcfg)
    np.testing.assert_allclose(tl_chunk.numpy(), np.asarray(jl_chunk), **TOL)
    _caches_close(tc, jc)
    steps = []
    for i in range(Tq):
        li, ts = tl.decode_step(tparams, ts, torch.from_numpy(chunk[:, i]),
                                T0 + i, tcfg)
        steps.append(li)
    np.testing.assert_allclose(tl_chunk.numpy(),
                               torch.stack(steps, 1).numpy(), **TOL)
    for a, b in zip(tc, ts):
        np.testing.assert_allclose(a["k"].numpy(), b["k"].numpy(), **TOL)


@pytest.mark.parametrize("T0", [5, 20])
def test_torch_rolling_prefill_matches_jax(T0):
    """Prefill on the ring, a prompt shorter than the window and one longer
    than the ring (only the last R positions written, at p mod R), through
    the flash forward's plain version against JAX's Pallas kernel in
    interpret mode: the last logits and the ring."""
    jcfg, tcfg = _cfgs(rolling=True, use_flash=True)
    jparams, tparams = _params(jcfg, 51)
    prompt = _tokens(52, 2, T0)
    jlog, jc = jl.prefill(jparams, jl.init_cache(jcfg, 2),
                          jnp.asarray(prompt), jcfg)
    tc = tl.init_cache(tcfg, 2)
    assert tuple(tc[0]["k"].shape) == (2, W + SLACK, tcfg.n_kv_heads,
                                       tcfg.head_dim)
    tlog, tc = tl.prefill(tparams, tc, torch.from_numpy(prompt), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _caches_close(tc, jc)


def test_torch_rolling_cache_matches_full_cache_and_jax():
    """Rolling against the full masked cache, and against JAX: twenty
    tokens (the ring wraps twice), a prompt longer than the ring, one
    shorter than the window (never-written slots masked by p_j >= 0), and
    generation past max_seq, where the full cache refuses."""
    jfull, tfull = _cfgs()
    jroll, troll = _cfgs(rolling=True)
    jparams, tparams = _params(jfull, 61)
    for seed, (B, T0), N in ((62, (2, 10), 20), (63, (1, 20), 6),
                             (64, (2, 3), 8)):
        prompt = _tokens(seed, B, T0)
        ref = tl.generate(tparams, torch.from_numpy(prompt), N, tfull)
        roll = tl.generate(tparams, torch.from_numpy(prompt), N, troll)
        jroll_out = np.asarray(jl.generate(jparams, jnp.asarray(prompt), N,
                                           jroll))
        np.testing.assert_array_equal(roll.numpy(), ref.numpy())
        np.testing.assert_array_equal(roll.numpy(), jroll_out)

    _, tsmall = _cfgs(max_seq=16)
    _, tsmall_roll = _cfgs(max_seq=16, rolling=True)
    prompt = torch.from_numpy(_tokens(62, 2, 10))
    with pytest.raises(ValueError, match="slots"):
        tl.generate(tparams, prompt, 30, tsmall, max_seq=16)
    long_out = tl.generate(tparams, prompt, 30, tsmall_roll)
    assert tuple(long_out.shape) == (2, 30)
    np.testing.assert_array_equal(
        long_out[:, :20].numpy(),
        tl.generate(tparams, prompt, 20, tfull).numpy())


def test_torch_rolling_chunk_longer_than_slack_is_refused():
    jcfg, tcfg = _cfgs(rolling=True)
    jparams, tparams = _params(jcfg, 71)
    big = np.zeros((1, SLACK + 1), np.int32)
    with pytest.raises(ValueError, match="rolling_slack"):
        jl.decode_chunk(jparams, jl.init_cache(jcfg, 1), jnp.asarray(big), 0,
                        jcfg)
    with pytest.raises(ValueError, match="rolling_slack"):
        tl.decode_chunk(tparams, tl.init_cache(tcfg, 1),
                        torch.from_numpy(big), 0, tcfg)


@pytest.mark.parametrize("n_draft", [1, 2, 3, 4])
@pytest.mark.parametrize("draft", ["self", "other", "shallow"])
def test_torch_speculative_generate_matches_jax_and_greedy(n_draft, draft):
    """Speculative decoding against the JAX function and the port's greedy
    ``generate``: with self-speculation (every draft accepted), an
    independently seeded draft (few accepted) and a draft config other than
    the target's (one layer, its own seed)."""
    jcfg, tcfg = _cfgs(window=None, max_seq=128)
    jparams, tparams = _params(jcfg, 43)
    jdcfg, tdcfg = jcfg, tcfg
    if draft == "self":
        jdraft, tdraft = jparams, tparams
    else:
        if draft == "shallow":
            jdcfg, tdcfg = _cfgs(window=None, max_seq=128, n_layers=1)
        jdraft, tdraft = _params(jdcfg, 44)
    prompt = _tokens(45, 2, 5)
    N = 10
    ref = tl.generate(tparams, torch.from_numpy(prompt), N, tcfg)
    tl.speculative_generate.rounds = tl.speculative_generate.accepted = 0
    spec = tl.speculative_generate(tparams, tdraft, torch.from_numpy(prompt),
                                   N, tcfg, draft_cfg=tdcfg, n_draft=n_draft)
    jspec = np.asarray(jl.speculative_generate(
        jparams, jdraft, jnp.asarray(prompt), N, jcfg, draft_cfg=jdcfg,
        n_draft=n_draft))
    np.testing.assert_array_equal(spec.numpy(), ref.numpy())
    np.testing.assert_array_equal(spec.numpy(), jspec)
    rounds = tl.speculative_generate.rounds
    # Every round emits its accepted drafts and one correction.
    assert 1 + tl.speculative_generate.accepted + rounds >= N
    if draft == "self":
        assert rounds == -(-(N - 1) // (n_draft + 1))


def test_torch_speculative_on_rolling_target_with_fixed_draft():
    """A rolling target and a fixed-cache draft: the output is the full
    cache's greedy decode and JAX's, and the draft's cache keeps its own
    budget (a max_seq too small for it is refused)."""
    jfull, tfull = _cfgs()
    jroll, troll = _cfgs(rolling=True)
    jparams, tparams = _params(jfull, 61)
    jdraft, tdraft = _params(jfull, 63)
    prompt = _tokens(62, 2, 10)
    N = 20
    ref = tl.generate(tparams, torch.from_numpy(prompt), N, tfull)
    spec = tl.speculative_generate(tparams, tdraft, torch.from_numpy(prompt),
                                   N, troll, draft_cfg=tfull, n_draft=2)
    jspec = np.asarray(jl.speculative_generate(
        jparams, jdraft, jnp.asarray(prompt), N, jroll, draft_cfg=jfull,
        n_draft=2))
    np.testing.assert_array_equal(spec.numpy(), ref.numpy())
    np.testing.assert_array_equal(spec.numpy(), jspec)
    for fn, p, d, cfg, dcfg in (
            (jl.speculative_generate, jparams, jdraft, jroll, jfull),
            (tl.speculative_generate, tparams, tdraft, troll, tfull)):
        x = jnp.asarray(prompt) if fn is jl.speculative_generate \
            else torch.from_numpy(prompt)
        with pytest.raises(ValueError, match="slots"):
            fn(p, d, x, N, cfg, draft_cfg=dcfg, n_draft=2, max_seq=16)


def test_torch_speculative_edges():
    _, tcfg = _cfgs(window=None)
    _, tparams = _params(_cfgs(window=None)[0], 1)
    prompt = torch.from_numpy(_tokens(2, 2, 4))
    assert tuple(tl.speculative_generate(tparams, tparams, prompt, 0,
                                         tcfg).shape) == (2, 0)
    with pytest.raises(ValueError, match="n_draft"):
        tl.speculative_generate(tparams, tparams, prompt, 4, tcfg, n_draft=0)
    one = tl.speculative_generate(tparams, tparams, prompt, 1, tcfg)
    np.testing.assert_array_equal(
        one.numpy(), tl.generate(tparams, prompt, 1, tcfg).numpy())
