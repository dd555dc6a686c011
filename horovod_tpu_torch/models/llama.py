"""Llama-family decoder: the dense, single-device serving surface.

Port of ``horovod_tpu/models/llama.py:37-230, 313-523, 626-921``.  The
parameters are a plain dictionary in the JAX package's own layout
(``{"embed", "layers": [...], "final_norm", "lm_head"}``), and every weight
keeps the JAX ``[in, out]`` layout: a projection is ``x @ w``, never
``nn.Linear``'s ``x @ w.T``.  :func:`params_from_jax` carries a JAX
parameter tree (as numpy arrays) over unchanged.

Prefill attends through the flash-attention forward (the Hopper kernel on
a card, its plain version on the CPU); decode attention over the cache is a
plain masked product, as in the JAX package, because at one query row there
is no score matrix to tile.  The KV cache is updated in place, where the
JAX functions return a new one; the functions still return it.

Mixture-of-experts, tensor/sequence/pipeline/expert parallelism, the
rolling cache and speculative decoding are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.flash_attention import NEG_INF, flash_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.bfloat16
    # Sliding-window (Mistral-style) causal attention over the last
    # ``sliding_window`` positions; the flash kernel skips whole tiles
    # outside the band.
    sliding_window: Optional[int] = None
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self):
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1 (or None to disable), got "
                f"{self.sliding_window!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} must be a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")


def tiny(vocab_size: int = 256, d_model: int = 64, n_layers: int = 2,
         n_heads: int = 4, n_kv_heads: int = 2, d_ff: int = 128,
         max_seq: int = 128, **kw) -> LlamaConfig:
    """Small config for tests / dryruns."""
    return LlamaConfig(vocab_size=vocab_size, d_model=d_model,
                       n_layers=n_layers, n_heads=n_heads,
                       n_kv_heads=n_kv_heads, d_ff=d_ff, max_seq=max_seq, **kw)


def llama3_8b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)  # defaults above are the 8B geometry


# ------------------------------------------------------------------- params
def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random dense parameters, ``N(0, 1/fan_in)``, drawn from
    ``generator`` on ``device`` (the generator's own device by default)."""
    device = torch.device(device) if device is not None else \
        generator.device
    D, H, K, Hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    dt = cfg.dtype

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * (1.0 / np.sqrt(fan_in))).to(dt)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": ones(D),
            "wq": dense(D, (D, H * Hd)),
            "wk": dense(D, (D, K * Hd)),
            "wv": dense(D, (D, K * Hd)),
            "wo": dense(H * Hd, (H * Hd, D)),
            "mlp_norm": ones(D),
            "w1": dense(D, (D, F)),
            "w3": dense(D, (D, F)),
            "w2": dense(F, (F, D)),
        })
    return {
        "embed": dense(D, (cfg.vocab_size, D)),
        "layers": layers,
        "final_norm": ones(D),
        "lm_head": dense(D, (D, cfg.vocab_size)),
    }


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(tree, device="cpu", dtype: Optional[torch.dtype] = None
                    ) -> Dict:
    """The JAX package's parameter tree (leaves as numpy arrays) as the
    port's parameters, layouts unchanged (``[in, out]`` weights)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    return _to_tensor(tree, device, dtype)


# ------------------------------------------------------------------ forward
def _rmsnorm(x, w, eps=1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope(x, positions, theta):
    """Rotary embeddings; x: [B, T, H, Hd], positions: [T]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[:, None].float() * freqs[None, :]     # [T, half]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def _qkv(x, p, cfg: LlamaConfig, positions):
    """Project + rope: the qkv contract shared by the forward, prefill and
    decode so the three paths cannot drift."""
    B, T, _ = x.shape
    H, K, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, T, H, Hd)
    k = (x @ p["wk"]).reshape(B, T, K, Hd)
    v = (x @ p["wv"]).reshape(B, T, K, Hd)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _wo_project(out, p, cfg: LlamaConfig):
    B, T = out.shape[:2]
    return out.reshape(B, T, -1) @ p["wo"]


def _local_attend(q, k, v, cfg: LlamaConfig):
    """Causal attention through the flash forward (sliding window when the
    config asks for it)."""
    return flash_attention(q, k, v, causal=True, window=cfg.sliding_window)


def _mlp(x, p, cfg: LlamaConfig):
    """Dense SwiGLU MLP."""
    h = torch.nn.functional.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


def _layer_apply(p, x, cfg: LlamaConfig, positions):
    h = _rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(h, p, cfg, positions)
    x = x + _wo_project(_local_attend(q, k, v, cfg), p, cfg)
    return x + _mlp(_rmsnorm(x, p["mlp_norm"], cfg.norm_eps), p, cfg)


def forward(params, tokens, cfg: LlamaConfig):
    """Logits ``[B, T, vocab]`` for ``tokens [B, T]``."""
    T = tokens.shape[1]
    positions = torch.arange(T, device=tokens.device)
    x = params["embed"][tokens.long()]
    for p in params["layers"]:
        x = _layer_apply(p, x, cfg, positions)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


# ---------------------------------------------------------------- inference
def init_cache(cfg: LlamaConfig, batch: int, max_seq: Optional[int] = None,
               device=None) -> List[Dict]:
    """Per-layer KV cache ``[B, max_seq, n_kv_heads, head_dim]`` (zeros)."""
    shape = (batch, max_seq or cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _check_cache_budget(t_final: int, cache_t: int):
    """Refuse to decode past the cache instead of writing out of range."""
    if t_final > cache_t:
        raise ValueError(
            f"decode would write position {t_final - 1} but the KV cache "
            f"has only {cache_t} slots; raise max_seq (init_cache) or "
            f"generate fewer tokens")


@torch.no_grad()
def decode_step(params, cache, tokens, pos: int, cfg: LlamaConfig):
    """One decode step: ``tokens [B]`` at position ``pos`` -> (logits
    [B, vocab] float32, cache).  The Tq=1 case of :func:`decode_chunk`."""
    logits, cache = decode_chunk(params, cache, tokens[:, None], pos, cfg)
    return logits[:, 0, :], cache


@torch.no_grad()
def decode_chunk(params, cache, tokens, pos: int, cfg: LlamaConfig):
    """Cached forward over a short chunk ``tokens [B, Tq]`` starting at
    position ``pos`` -> (logits [B, Tq, vocab] float32, cache).

    The chunk's kv is written into the cache at ``[pos, pos+Tq)`` and row i
    attends the cache prefix ``<= pos + i`` (the last ``sliding_window`` of
    it with a window).  Attention is a plain masked product in float32 over
    the written prefix: the slots past it are masked in the JAX version and
    contribute exactly zero there."""
    B, Tq = tokens.shape
    _check_cache_budget(pos + Tq, cache[0]["k"].shape[1])
    dev = tokens.device
    x = params["embed"][tokens.long()]                # [B, Tq, D]
    positions = pos + torch.arange(Tq, device=dev)
    T = pos + Tq
    t = torch.arange(T, device=dev)[None, :]
    valid = t <= positions[:, None]                   # [Tq, T]
    if cfg.sliding_window:
        valid = valid & (t > positions[:, None] - cfg.sliding_window)
    H, K, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for p, c in zip(params["layers"], cache):
        h = _rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = _qkv(h, p, cfg, positions)
        c["k"][:, pos:pos + Tq] = k_new.to(c["k"].dtype)
        c["v"][:, pos:pos + Tq] = v_new.to(c["v"].dtype)
        ck, cv = c["k"][:, :T], c["v"][:, :T]
        # GQA groups against the shared kv, one extra chunk axis q.
        qg = q.reshape(B, Tq, K, H // K, Hd)
        s = torch.einsum("bqkrd,btkd->bkrqt", qg.float(), ck.float())
        s = s / np.sqrt(Hd)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkrqt,btkd->bqkrd", w.to(cv.dtype).float(),
                         cv.float())
        x = x + _wo_project(o.reshape(B, Tq, H, Hd).to(x.dtype), p, cfg)
        x = x + _mlp(_rmsnorm(x, p["mlp_norm"], cfg.norm_eps), p, cfg)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float(), cache


@torch.no_grad()
def prefill(params, cache, tokens, cfg: LlamaConfig):
    """Batched prefill: fill the cache from a prompt ``[B, T0]`` in one pass
    over the layers; returns (last-position logits float32, cache).  Each
    layer projects q/k/v for the whole prompt, writes its kv into the cache
    at ``[0, T0)`` and attends causally through the flash forward."""
    B, T0 = tokens.shape
    _check_cache_budget(T0, cache[0]["k"].shape[1])
    positions = torch.arange(T0, device=tokens.device)
    x = params["embed"][tokens.long()]                # [B, T0, D]
    for p, c in zip(params["layers"], cache):
        h = _rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(h, p, cfg, positions)
        c["k"][:, :T0] = k.to(c["k"].dtype)
        c["v"][:, :T0] = v.to(c["v"].dtype)
        x = x + _wo_project(_local_attend(q, k, v, cfg), p, cfg)
        x = x + _mlp(_rmsnorm(x, p["mlp_norm"], cfg.norm_eps), p, cfg)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x[:, -1, :] @ params["lm_head"]).float(), cache


def sample_logits(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_p: float = 1.0,
                  top_k: int = 0):
    """Pick next tokens ``[B]`` (int32) from ``logits [B, vocab]``.

    temperature == 0 → greedy argmax (generator unused).  Otherwise scale
    by 1/temperature, keep the ``top_k`` largest logits and/or the nucleus
    of mass ``top_p``, then draw from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF),
                             logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # The smallest set reaching top_p: every token strictly inside the
        # nucleus plus the first one past the boundary.
        keep_sorted = cum - probs < top_p
        cutoff = torch.where(keep_sorted, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, NEG_INF), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def generate(params, prompt, n_tokens: int, cfg: LlamaConfig,
             max_seq: Optional[int] = None, temperature: float = 0.0,
             top_p: float = 1.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None):
    """Generation: ``prompt [B, T0]`` -> ``[B, n_tokens]`` int32.

    Greedy by default; ``temperature > 0`` samples from ``generator``.
    The cache holds ``max_seq`` slots, by default just the prompt and the
    new tokens (the JAX function defaults to ``cfg.max_seq``; the extra
    slots are masked there and change nothing but memory)."""
    B, T0 = prompt.shape
    if n_tokens < 1:
        return torch.zeros((B, 0), dtype=torch.int32, device=prompt.device)
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires generator=")
    cache = init_cache(cfg, B, max_seq or T0 + n_tokens,
                       device=prompt.device)
    # The last generated token's own kv is never written back, hence -1.
    _check_cache_budget(T0 + n_tokens - 1, cache[0]["k"].shape[1])
    logits, cache = prefill(params, cache, prompt, cfg)
    tok = sample_logits(logits, generator, temperature, top_p, top_k)
    out = [tok]
    for t in range(T0, T0 + n_tokens - 1):
        logits, cache = decode_step(params, cache, tok, t, cfg)
        tok = sample_logits(logits, generator, temperature, top_p, top_k)
        out.append(tok)
    return torch.stack(out, dim=1)
