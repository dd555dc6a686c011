"""Port parity: GPT-2 against the JAX package.

The same seeded numpy inputs go through ``horovod_tpu.models.gpt2`` and
its port (``tiny``, float32 unless said otherwise):

- the logits, the training loss and every leaf gradient within 1e-4
  absolute and relative, with the JAX causal attention on its Pallas
  kernels in interpret mode (``use_flash=True``) and on its jnp reference
  (``use_flash=False``); the bfloat16 logits within 2e-2 of the
  reference's largest value; two ``make_train_step`` SGD steps against
  the JAX step with ``optax.sgd``;
- serving: ``decode_step`` logits position by position within 1e-4, and
  ``generate``'s greedy tokens equal to the JAX ones;
- the HuggingFace conversion on a ``GPT2LMHeadModel``-named state dict
  written here (no downloaded weights): ``from_hf_state_dict`` gives the
  JAX function's tree, leaf for leaf, ``to_hf_state_dict`` gives the JAX
  function's dict and round-trips to the input, with and without the
  ``transformer.`` prefix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import gpt2 as jg
from horovod_tpu_torch.models import gpt2 as tg

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 2e-2          # of the reference's largest |value|
LR = 0.5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcfg(use_flash=None, dtype=jnp.float32):
    return jg.tiny(dtype=dtype, dp_axis=None, tp_axis=None,
                   use_flash=use_flash)


def _tcfg(dtype=torch.float32):
    return tg.tiny(dtype=dtype)


def _tokens(seed, B=2, T=24):
    toks = np.random.RandomState(seed).randint(0, 256, (B, T + 1)).astype(
        np.int32)
    return toks[:, :-1], toks[:, 1:]


def _named(tree):
    return {n: t.numpy() for n, t in tg.named_parameters(
        tg.params_from_jax(_np(tree)))}


@pytest.mark.parametrize("use_flash", [True, False])
def test_torch_gpt2_logits_loss_and_grads_match_jax(use_flash):
    jcfg = _jcfg(use_flash)
    jp = jg.init_params(jcfg, jax.random.PRNGKey(0))
    x, y = _tokens(1)
    params = tg.params_from_jax(_np(jp))
    named = dict(tg.named_parameters(params))
    for t in named.values():
        t.requires_grad_(True)
    np.testing.assert_allclose(
        tg.forward(params, torch.from_numpy(x), _tcfg()).detach().numpy(),
        np.asarray(jg.forward(jp, jnp.asarray(x), jcfg)), **TOL)
    jloss, jgrads = jax.value_and_grad(jg.loss_fn)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    loss = tg.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y),
                      _tcfg())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    ref = _named(jgrads)
    # wte, wpe, the final LayerNorm, 16 leaves a layer; no head (tied).
    assert sorted(ref) == sorted(named) and len(named) == 4 + 16 * 2
    for n, t in named.items():
        np.testing.assert_allclose(t.grad.numpy(), ref[n], err_msg=n, **TOL)


def test_torch_gpt2_bf16_logits_match_jax():
    jcfg = _jcfg(dtype=jnp.bfloat16)
    jp = _np(jg.init_params(jcfg, jax.random.PRNGKey(2)))
    x, _ = _tokens(2)
    want = np.asarray(jg.forward(jp, jnp.asarray(x), jcfg))
    got = tg.forward(tg.params_from_jax(jp), torch.from_numpy(x),
                     _tcfg(torch.bfloat16)).numpy()
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def test_torch_gpt2_train_steps_match_jax():
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    jcfg = _jcfg()
    jp = jg.init_params(jcfg, jax.random.PRNGKey(3))
    params = tg.params_from_jax(_np(jp))
    named = list(tg.named_parameters(params))
    for _, t in named:
        t.requires_grad_(True)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=LR), named_parameters=named)
    step = tg.make_train_step(_tcfg(), opt)
    tx = optax.sgd(LR)
    jstep, jstate = jax.jit(jg.make_train_step(jcfg, tx)), tx.init(jp)
    for i in range(2):
        x, y = _tokens(10 + i)
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(x), jnp.asarray(y))
        loss = step(params, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
        np.testing.assert_allclose(tg.psum_loss(loss, _tcfg()).item(),
                                   float(jloss), **TOL)
    ref = _named(jp)
    for n, t in named:
        np.testing.assert_allclose(t.detach().numpy(), ref[n], err_msg=n,
                                   **TOL)


# ----------------------------------------------------------------- serving
def test_torch_gpt2_decode_step_matches_jax():
    jcfg = _jcfg()
    jp = jg.init_params(jcfg, jax.random.PRNGKey(4))
    params = tg.params_from_jax(_np(jp))
    toks, _ = _tokens(5, T=10)
    jcache = jg.init_cache(jcfg, 2, 12)
    tcache = tg.init_cache(_tcfg(), 2, 12)
    for pos in range(toks.shape[1]):
        jl, jcache = jg.decode_step(jp, jcache, jnp.asarray(toks[:, pos]),
                                    pos, jcfg)
        tl, tcache = tg.decode_step(params, tcache,
                                    torch.from_numpy(toks[:, pos]), pos,
                                    _tcfg())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"pos {pos}", **TOL)
    for c_t, c_j in zip(tcache, jcache):
        np.testing.assert_allclose(c_t["k"].numpy(), np.asarray(c_j["k"]),
                                   **TOL)
    # The cached logits at the last position are the full forward's.
    full = tg.forward(params, torch.from_numpy(toks), _tcfg())
    np.testing.assert_allclose(tl.numpy(), full[:, -1].detach().numpy(),
                               **TOL)
    with pytest.raises(ValueError, match="slots"):
        tg.decode_step(params, tcache, torch.from_numpy(toks[:, 0]), 12,
                       _tcfg())


@pytest.mark.parametrize("T0,n", [(1, 6), (7, 9)])
def test_torch_gpt2_generate_matches_jax(T0, n):
    jcfg = _jcfg()
    jp = jg.init_params(jcfg, jax.random.PRNGKey(6))
    prompt = np.random.RandomState(7).randint(0, 256, (3, T0)).astype(
        np.int32)
    want = np.asarray(jg.generate(jax.tree_util.tree_map(jnp.asarray, jp),
                                  jnp.asarray(prompt), n, jcfg))
    got = tg.generate(tg.params_from_jax(_np(jp)), torch.from_numpy(prompt),
                      n, _tcfg())
    assert got.dtype == torch.int32 and got.shape == (3, n)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- HF convert
def _hf_state_dict(cfg, prefix, seed=8):
    """A ``GPT2LMHeadModel``-named state dict of seeded float32 arrays,
    with a longer ``wpe`` than the config keeps, as checkpoints have."""
    rng = np.random.RandomState(seed)
    D, F_ = cfg.d_model, cfg.d_ff

    def a(*shape):
        return rng.randn(*shape).astype(np.float32)

    sd = {"wte.weight": a(cfg.vocab_size, D),
          "wpe.weight": a(cfg.max_seq + 16, D),
          "ln_f.weight": a(D), "ln_f.bias": a(D)}
    for i in range(cfg.n_layers):
        b = f"h.{i}."
        sd.update({
            b + "ln_1.weight": a(D), b + "ln_1.bias": a(D),
            b + "attn.c_attn.weight": a(D, 3 * D),
            b + "attn.c_attn.bias": a(3 * D),
            b + "attn.c_proj.weight": a(D, D), b + "attn.c_proj.bias": a(D),
            b + "ln_2.weight": a(D), b + "ln_2.bias": a(D),
            b + "mlp.c_fc.weight": a(D, F_), b + "mlp.c_fc.bias": a(F_),
            b + "mlp.c_proj.weight": a(F_, D), b + "mlp.c_proj.bias": a(D)})
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["transformer.", ""])
def test_torch_gpt2_hf_round_trip_matches_jax(prefix):
    jcfg = _jcfg()
    sd = _hf_state_dict(jcfg, prefix)
    want = _np(jg.from_hf_state_dict(sd, jcfg))
    got = tg.from_hf_state_dict(sd, _tcfg())
    got_np = jax.tree_util.tree_map(lambda t: t.numpy(), got)
    assert jax.tree_util.tree_structure(got_np) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got_np),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    back = tg.to_hf_state_dict(got, _tcfg())
    jback = jg.to_hf_state_dict(want, jcfg)
    assert sorted(back) == sorted(jback)
    for k, v in back.items():
        assert v.dtype == np.float32 and np.array_equal(v, jback[k]), k
    src = {"transformer." + k[len(prefix):]: v for k, v in sd.items()}
    src["transformer.wpe.weight"] = src["transformer.wpe.weight"][
        :jcfg.max_seq]
    src["lm_head.weight"] = src["transformer.wte.weight"]
    assert sorted(src) == sorted(back)
    assert all(np.array_equal(back[k], v) for k, v in src.items())
    # And the tensors' own dtype: bf16 parameters come back as float32.
    bf = tg.from_hf_state_dict(sd, _tcfg(torch.bfloat16))
    assert bf["wte"].dtype == torch.bfloat16
    assert tg.to_hf_state_dict(bf, _tcfg())["lm_head.weight"].dtype == \
        np.float32
    bad = dict(sd)
    bad[prefix + "wte.weight"] = bad[prefix + "wte.weight"][:-1]
    with pytest.raises(ValueError, match="wte"):
        tg.from_hf_state_dict(bad, _tcfg())
