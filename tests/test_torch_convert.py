"""Port parity: ``horovod_tpu_torch.models.convert`` against the JAX
package's converter and against ``transformers``.

One Hugging Face state dict goes through the JAX ``from_hf_state_dict`` and
the port's; the two trees must be equal in float32 (the port takes torch
tensors, so the comparison is in float32: a bfloat16 torch tensor does not
convert to numpy).  Then ``LlamaForCausalLM``, ``MistralForCausalLM`` (at
T above its sliding window) and ``MixtralForCausalLM`` are built here with
random weights from a seed, ``attn_implementation="eager"``, and the port's
forward from the converted weights must give their logits within 1e-4
(float32 on both sides; only the order of sums differs).  Then the lossless
round trip, tied embeddings, ``norm_eps`` and the refusals.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from horovod_tpu.models import convert as jconvert
from horovod_tpu.models import llama as jl
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import llama as tl

TOL = dict(atol=1e-4, rtol=1e-4)
GEOMETRY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64,
                rope_theta=10000.0, tie_word_embeddings=False)
WINDOW = 6


def _hf(kind, rms_eps=1e-5, seed=0):
    """A ``transformers`` model of ``kind`` with random weights, and the
    port's config of the same geometry."""
    import transformers as tf
    cls, conf, extra, kw = {
        "llama": ("LlamaForCausalLM", "LlamaConfig",
                  dict(attention_bias=False, mlp_bias=False), {}),
        "mistral": ("MistralForCausalLM", "MistralConfig",
                    dict(sliding_window=WINDOW),
                    dict(sliding_window=WINDOW)),
        "mixtral": ("MixtralForCausalLM", "MixtralConfig",
                    dict(num_local_experts=4, num_experts_per_tok=2),
                    dict(n_experts=4, router_top_k=2, moe_gated=True,
                         capacity_factor=4.0, ep_axis=None)),
    }[kind]
    hf_cfg = getattr(tf, conf)(rms_norm_eps=rms_eps, **GEOMETRY, **extra)
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(seed)
    model = getattr(tf, cls)(hf_cfg).eval()
    cfg = tl.LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128, max_seq=64,
                         rope_theta=10000.0, dtype=torch.float32,
                         norm_eps=rms_eps, **kw)
    return model, cfg


def _jax_cfg(cfg):
    kw = dict(n_experts=cfg.n_experts, router_top_k=cfg.router_top_k,
              moe_gated=cfg.moe_gated, capacity_factor=cfg.capacity_factor,
              ep_axis=None) if cfg.n_experts else {}
    return jl.LlamaConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, max_seq=cfg.max_seq,
        rope_theta=cfg.rope_theta, dtype=jnp.float32, norm_eps=cfg.norm_eps,
        sliding_window=cfg.sliding_window, dp_axis=None, tp_axis=None,
        sp_axis=None, use_flash=False, **kw)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _logits(model, tokens):
    with torch.no_grad():
        return model(torch.tensor(tokens)).logits.numpy()


@pytest.mark.parametrize("kind", ["llama", "mistral", "mixtral"])
def test_torch_convert_equals_jax_converter(kind):
    """The same state dict through both converters: the same tree, leaf
    for leaf, in float32."""
    model, cfg = _hf(kind)
    sd = model.state_dict()
    ours = convert.from_hf_state_dict(sd, cfg)
    theirs = jconvert.from_hf_state_dict(sd, _jax_cfg(cfg))
    a, b = list(_leaves(ours)), list(_leaves(theirs))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, t), (_, j) in zip(a, b):
        assert not t.requires_grad
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=str(path))


@pytest.mark.parametrize("kind", ["llama", "mistral", "mixtral"])
def test_torch_convert_matches_transformers(kind):
    """The port's forward from converted weights against ``transformers``'
    logits (Mistral at T = 16 > its window of 6), then a greedy
    continuation against the model's argmax, on a rolling cache for
    Mistral."""
    model, cfg = _hf(kind)
    params = convert.from_hf_state_dict(model.state_dict(), cfg)
    T = 16 if kind == "mistral" else 10
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, T))
    with torch.no_grad():
        ours = tl.forward(params, torch.from_numpy(tokens), cfg).numpy()
    np.testing.assert_allclose(ours, _logits(model, tokens), **TOL)
    if kind == "mistral":
        # The window matters at this length: full attention differs.
        full = dataclasses.replace(cfg, sliding_window=None)
        with torch.no_grad():
            wide = tl.forward(params, torch.from_numpy(tokens), full).numpy()
        assert np.abs(wide - ours).max() > 1e-2
        cfg = dataclasses.replace(cfg, rolling_cache=True, rolling_slack=4)
    gen = tl.generate(params, torch.from_numpy(tokens), 3, cfg)
    seq = torch.tensor(tokens)
    for i in range(3):
        with torch.no_grad():
            nxt = model(seq).logits[:, -1, :].argmax(-1)
        np.testing.assert_array_equal(gen[:, i].numpy(), nxt.numpy(),
                                      err_msg=f"token {i}")
        seq = torch.cat([seq, nxt[:, None]], dim=1)


def test_torch_convert_round_trip_lossless():
    """from_hf then to_hf gives back every tensor bit for bit, in its own
    dtype (float32 and bfloat16), as the JAX round trip does in float32."""
    model, cfg = _hf("mistral")
    sd = model.state_dict()
    for dt in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dt)
        params = convert.from_hf_state_dict(sd, c)
        back = convert.to_hf_state_dict(params, c)
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert back[k].dtype == dt, k
            assert torch.equal(back[k], v.to(dt)), k
        again = convert.from_hf_state_dict(back, c)
        for (p, a), (_, b) in zip(_leaves(params), _leaves(again)):
            assert torch.equal(a, b), p
    jback = jconvert.to_hf_state_dict(
        jconvert.from_hf_state_dict(sd, _jax_cfg(cfg)), _jax_cfg(cfg))
    back = convert.to_hf_state_dict(convert.from_hf_state_dict(sd, cfg), cfg)
    assert set(back) == set(jback)
    for k in back:
        np.testing.assert_array_equal(back[k].numpy(), jback[k], err_msg=k)


def test_torch_convert_takes_numpy_and_bf16():
    """numpy arrays (float32, and bfloat16 as ``ml_dtypes`` arrays) convert
    as the tensors do."""
    model, cfg = _hf("llama")
    sd = model.state_dict()
    ref = convert.from_hf_state_dict(sd, cfg)
    from_np = convert.from_hf_state_dict({k: v.numpy() for k, v in sd.items()},
                                         cfg)
    for (p, a), (_, b) in zip(_leaves(ref), _leaves(from_np)):
        assert torch.equal(a, b), p
    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    bf = {k: np.asarray(jnp.asarray(v.numpy(), jnp.bfloat16))
          for k, v in sd.items()}
    got = convert.from_hf_state_dict(bf, bcfg)
    want = convert.from_hf_state_dict(sd, bcfg)
    for (p, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), p


def test_torch_convert_tied_embeddings():
    model, cfg = _hf("llama")
    sd = {k: v for k, v in model.state_dict().items()
          if k != "lm_head.weight"}
    params = convert.from_hf_state_dict(sd, cfg)
    jparams = jconvert.from_hf_state_dict(sd, _jax_cfg(cfg))
    np.testing.assert_array_equal(params["lm_head"].numpy(),
                                  params["embed"].numpy().T)
    np.testing.assert_array_equal(params["lm_head"].numpy(),
                                  np.asarray(jparams["lm_head"]))
    back = convert.to_hf_state_dict(params, cfg, tied_embeddings=True)
    assert set(back) == set(sd)
    params["lm_head"] = params["lm_head"] + 1.0
    for mod, p, c in ((convert, params, cfg),
                      (jconvert, {k: (np.asarray(v) if k != "layers" else v)
                                  for k, v in jparams.items()}
                       | {"lm_head": np.asarray(jparams["lm_head"]) + 1.0},
                       _jax_cfg(cfg))):
        with pytest.raises(ValueError, match="tied_embeddings"):
            mod.to_hf_state_dict(p, c, tied_embeddings=True)


def test_torch_convert_norm_eps_matters():
    """A checkpoint with eps 1e-4 converts exactly when ``norm_eps``
    matches, and drifts when it does not."""
    model, cfg = _hf("llama", rms_eps=1e-4)
    params = convert.from_hf_state_dict(model.state_dict(), cfg)
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (1, 8))
    theirs = _logits(model, tokens)
    with torch.no_grad():
        ours = tl.forward(params, torch.from_numpy(tokens), cfg).numpy()
        wrong = tl.forward(params, torch.from_numpy(tokens),
                           dataclasses.replace(cfg, norm_eps=1e-5)).numpy()
    np.testing.assert_allclose(ours, theirs, **TOL)
    assert np.abs(wrong - theirs).max() > np.abs(ours - theirs).max()


def test_torch_convert_refusals_match_jax():
    """The missing-key and mismatched-checkpoint messages, and the export
    refusals for the pp and MoE layouts, as in the JAX package."""
    model, cfg = _hf("llama")
    sd = model.state_dict()
    jcfg = _jax_cfg(cfg)
    for mod, c in ((convert, cfg), (jconvert, jcfg)):
        with pytest.raises(KeyError, match="state dict is missing"):
            mod.from_hf_state_dict({}, c)
        with pytest.raises(ValueError, match="not consumed"):
            mod.from_hf_state_dict(sd, dataclasses.replace(c, n_layers=1))
        with pytest.raises(ValueError, match="Mixtral shape"):
            mod.from_hf_state_dict(sd, dataclasses.replace(c, n_experts=4))
        with pytest.raises(ValueError, match="pp layout"):
            mod.to_hf_state_dict({}, dataclasses.replace(c, pp_axis="pp"))
        with pytest.raises(ValueError, match="MoE/Mixtral"):
            mod.to_hf_state_dict({}, dataclasses.replace(
                c, n_experts=4, moe_gated=True, router_top_k=2))
    missing = dict(sd)
    del missing["model.layers.1.mlp.up_proj.weight"]
    for mod, c in ((convert, cfg), (jconvert, jcfg)):
        with pytest.raises(KeyError, match="model.layers.1.mlp.up_proj"):
            mod.from_hf_state_dict(missing, c)


def test_torch_convert_pp_layout_is_stacked():
    """A pp config imports into the stacked layout the port's pipeline
    reads, the JAX stacked tree leaf for leaf."""
    model, cfg = _hf("llama")
    pcfg = dataclasses.replace(cfg, pp_axis="pp")
    params = convert.from_hf_state_dict(model.state_dict(), pcfg)
    jparams = jconvert.from_hf_state_dict(
        model.state_dict(), dataclasses.replace(_jax_cfg(cfg), pp_axis="pp"))
    assert tuple(params["layers"]["wq"].shape) == (2, 64, 64)
    for (p, a), (_, b) in zip(_leaves(params), _leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=str(p))
