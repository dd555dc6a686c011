"""GPT-2 decoder (124M by default): learned positions, pre-LN, biased
projections, tanh GELU and a head tied to the token embedding.

Port of ``horovod_tpu/models/gpt2.py:38-408``: data and tensor
parallelism.
The parameters are a plain dictionary in the JAX package's own layout
(``[in, out]`` weights); :func:`params_from_jax` carries a JAX tree (as
numpy arrays) over unchanged, and :func:`from_hf_state_dict` /
:func:`to_hf_state_dict` map HuggingFace ``GPT2LMHeadModel`` names (whose
``Conv1D`` weights are ``[in, out]`` too: a split of the fused ``c_attn``
and renames, no transposes) on numpy mappings.

Training attends through ``flash_attention(..., causal=True)`` and
differentiates through the flash backward.  The loss divides this rank's
NLL sum by the GLOBAL token count (summed over the data ranks), times
their number for ``hvd.DistributedOptimizer``'s average, as
``bert.mlm_loss_fn`` does.  Tensor parallelism (JAX :106-123, :132-160)
splits the heads with ``bq``/``bk``/``bv`` and the MLP's hidden units
with ``b_in`` by columns, ``wo``/``w_out`` by rows, with Megatron's
``f``/``g`` pair; ``bo``/``b_out`` are added after ``g``, and the tied
``wte`` stays replicated (:func:`param_specs`).

Decode is the JAX package's: a plain masked product over the cache in
float32 with ``-1e30`` for the slots past the position (at one query row
there is no score tile to stream), and :func:`generate` feeds the prompt
one token at a time.  The cache is
updated in place; the functions still return it.  Decode is
single-rank, as the JAX one: given a ``mesh`` with an axis of a size
above 1, it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import bert as _bert
from ..ops.flash_attention import NEG_INF, flash_attention
from ..parallel.expert import Split
from .llama import _copy_in, _reduce_out, _tp
from .llama import _to_tensor, named_parameters  # noqa: F401
from .llama import params_from_jax  # noqa: F401

__all__ = ["GPT2Config", "gpt2", "tiny", "init_params", "params_from_jax",
           "named_parameters", "param_specs", "forward", "loss_fn",
           "psum_loss",
           "make_train_step", "init_cache", "decode_step", "generate",
           "from_hf_state_dict", "to_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    d_model: int = 768           # gpt2 (124M)
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 1024
    dtype: torch.dtype = torch.bfloat16
    dp_axis: Optional[str] = "dp"
    tp_axis: Optional[str] = "tp"
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")


def gpt2(**kw) -> GPT2Config:
    return GPT2Config(**kw)


def tiny(**kw) -> GPT2Config:
    defaults = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    d_ff=128, max_seq=64)
    defaults.update(kw)
    return GPT2Config(**defaults)


def init_params(cfg: GPT2Config, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters from ``generator`` on ``device`` (the generator's
    by default), leaves that require grad."""
    device = torch.device(device) if device is not None else \
        generator.device
    D, HD, F_ = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    dense, zeros, ones = _bert.initializers(generator, device, cfg.dtype)
    layers = [{
        "ln1_scale": ones(D), "ln1_bias": zeros(D),
        "wq": dense(D, (D, HD)), "bq": zeros(HD),
        "wk": dense(D, (D, HD)), "bk": zeros(HD),
        "wv": dense(D, (D, HD)), "bv": zeros(HD),
        "wo": dense(HD, (HD, D)), "bo": zeros(D),
        "ln2_scale": ones(D), "ln2_bias": zeros(D),
        "w_in": dense(D, (D, F_)), "b_in": zeros(F_),
        "w_out": dense(F_, (F_, D)), "b_out": zeros(D),
    } for _ in range(cfg.n_layers)]
    return {
        "wte": dense(D, (cfg.vocab_size, D)),
        "wpe": dense(D, (cfg.max_seq, D)),
        "layers": layers,
        "lnf_scale": ones(D),
        "lnf_bias": zeros(D),
        # The LM head is tied to wte (logits = x @ wte.T).
    }


def param_specs(cfg: GPT2Config) -> Dict:
    """The mesh axis and dimension each leaf is split over (JAX
    :106-123): q/k/v and the MLP's input by columns over ``cfg.tp_axis``
    with their biases, ``wo``/``w_out`` by rows; the rest (the tied
    ``wte`` too) replicated."""
    tp = cfg.tp_axis
    cols, rows, bias = ((Split(tp, 1), Split(tp, 0), Split(tp, 0)) if tp
                        else (None, None, None))
    layer = {"ln1_scale": None, "ln1_bias": None, "wq": cols, "bq": bias,
             "wk": cols, "bk": bias, "wv": cols, "bv": bias, "wo": rows,
             "bo": None, "ln2_scale": None, "ln2_bias": None, "w_in": cols,
             "b_in": bias, "w_out": rows, "b_out": None}
    return {"wte": None, "wpe": None,
            "layers": [dict(layer) for _ in range(cfg.n_layers)],
            "lnf_scale": None, "lnf_bias": None}


# ------------------------------------------------------------------ forward
def _ln(x, scale, bias, cfg: GPT2Config):
    return _bert._layernorm(x, scale, bias, cfg.ln_eps)


def _attention(x, p, cfg: GPT2Config, mesh=None):
    """This rank's heads, summed over tp, then ``bo``."""
    B, T, _ = x.shape
    H, Hd = cfg.n_heads // _tp(cfg, mesh), cfg.head_dim
    x = _copy_in(x, cfg, mesh)
    q = (x @ p["wq"] + p["bq"]).reshape(B, T, H, Hd)
    k = (x @ p["wk"] + p["bk"]).reshape(B, T, H, Hd)
    v = (x @ p["wv"] + p["bv"]).reshape(B, T, H, Hd)
    out = flash_attention(q, k, v, causal=True)
    return _reduce_out(out.reshape(B, T, H * Hd) @ p["wo"], cfg, mesh) \
        + p["bo"]


def _mlp(x, p, cfg: Optional[GPT2Config] = None, mesh=None):
    """This rank's hidden units, summed over tp, then ``b_out``."""
    x = _copy_in(x, cfg, mesh)
    # GPT-2's activation is the tanh-approximate GELU ("gelu_new").
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    return _reduce_out(h @ p["w_out"], cfg, mesh) + p["b_out"]


def forward(params, tokens, cfg: GPT2Config, mesh=None):
    """Logits ``[B, T, vocab]`` float32 for ``tokens [B, T]`` (tied
    head)."""
    _bert.check_axes(cfg, mesh)
    T = tokens.shape[1]
    x = params["wte"][tokens.long()] + params["wpe"][:T][None]
    x = x.to(cfg.dtype)
    for p in params["layers"]:
        x = x + _attention(_ln(x, p["ln1_scale"], p["ln1_bias"], cfg), p,
                           cfg, mesh)
        x = x + _mlp(_ln(x, p["ln2_scale"], p["ln2_bias"], cfg), p, cfg,
                     mesh)
    x = _ln(x, params["lnf_scale"], params["lnf_bias"], cfg)
    return (x @ params["wte"].T).float()


# ----------------------------------------------------------------- training
def loss_fn(params, tokens, targets, cfg: GPT2Config, mesh=None):
    """This rank's NLL sum over the global token count, times the number
    of data ranks."""
    logits = forward(params, tokens, cfg, mesh)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1).long(), reduction="sum")
    count = torch.tensor(float(tokens.numel()), device=nll.device)
    count, n = _bert.dp_total(count, cfg, "gpt2.count", mesh)
    return nll / count * n


def psum_loss(loss, cfg: GPT2Config, mesh=None):
    """The global loss for logging (see ``bert.psum_loss``)."""
    return _bert.psum_loss(loss, cfg, "gpt2.loss", mesh)


def make_train_step(cfg: GPT2Config, optimizer, mesh=None, shards=None):
    """Returns ``step(params, tokens, targets) -> loss``
    (``bert.train_step`` of :func:`loss_fn`)."""
    return _bert.train_step(
        lambda params, tokens, targets: loss_fn(params, tokens, targets,
                                                cfg, mesh),
        param_specs(cfg), optimizer, mesh, shards)


# ------------------------------------------------------------------ serving
def init_cache(cfg: GPT2Config, batch: int, max_seq: Optional[int] = None,
               device=None):
    """Per-layer KV cache ``[B, T_max, H, Hd]`` (zeros)."""
    shape = (batch, max_seq or cfg.max_seq, cfg.n_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _single_rank(mesh, what: str) -> None:
    """GPT-2's decode is single-rank (JAX :305-307): refuse a mesh with
    an axis of a size above 1."""
    if mesh is not None and any(n > 1 for n in mesh.shape.values()):
        raise ValueError(f"gpt2 {what} is single-rank; the mesh "
                         f"{mesh.shape} splits it (decode with mesh=None)")


@torch.no_grad()
def decode_step(params, cache, tokens, pos: int, cfg: GPT2Config,
                mesh=None):
    """One cached step: ``tokens [B]`` at position ``pos`` -> (logits
    ``[B, vocab]`` float32, cache).  Attention over the whole cache is a
    masked product in float32; slots past ``pos`` get ``-1e30``."""
    _single_rank(mesh, "decode_step")
    B, H, Hd = tokens.shape[0], cfg.n_heads, cfg.head_dim
    T = cache[0]["k"].shape[1]
    if pos >= T:
        raise ValueError(f"decode would write position {pos} but the KV "
                         f"cache has only {T} slots")
    x = (params["wte"][tokens.long()] + params["wpe"][pos][None]).to(
        cfg.dtype)
    valid = (torch.arange(T, device=tokens.device) <= pos)[None, None, :]
    for p, c in zip(params["layers"], cache):
        h = _ln(x, p["ln1_scale"], p["ln1_bias"], cfg)
        q = (h @ p["wq"] + p["bq"]).reshape(B, H, Hd)
        c["k"][:, pos] = (h @ p["wk"] + p["bk"]).reshape(B, H, Hd).to(
            c["k"].dtype)
        c["v"][:, pos] = (h @ p["wv"] + p["bv"]).reshape(B, H, Hd).to(
            c["v"].dtype)
        s = torch.einsum("bhd,bthd->bht", q.float(), c["k"].float()) \
            / np.sqrt(Hd)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bht,bthd->bhd", w, c["v"].float())
        x = x + (o.reshape(B, H * Hd).to(cfg.dtype) @ p["wo"] + p["bo"])
        x = x + _mlp(_ln(x, p["ln2_scale"], p["ln2_bias"], cfg), p)
    x = _ln(x, params["lnf_scale"], params["lnf_bias"], cfg)
    return (x @ params["wte"].T).float(), cache


@torch.no_grad()
def generate(params, prompt, n_tokens: int, cfg: GPT2Config,
             max_seq: Optional[int] = None, mesh=None):
    """Greedy generation: ``prompt [B, T0]`` -> ``[B, n_tokens]`` int32.
    The prompt goes through the cache one token at a time, as in the JAX
    function."""
    _single_rank(mesh, "generate")
    B, T0 = prompt.shape
    if n_tokens < 1:
        return torch.zeros((B, 0), dtype=torch.int32, device=prompt.device)
    cache = init_cache(cfg, B, max_seq or T0 + n_tokens,
                       device=prompt.device)
    for i in range(T0):
        logits, cache = decode_step(params, cache, prompt[:, i], i, cfg)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for i in range(T0, T0 + n_tokens - 1):
        logits, cache = decode_step(params, cache, tok, i, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)


# --------------------------------------------------------------- HF convert
def _np_arr(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


def from_hf_state_dict(sd: Mapping[str, Any], cfg: GPT2Config,
                       device="cpu") -> Dict:
    """HuggingFace ``GPT2LMHeadModel`` state dict (numpy arrays or
    tensors) -> the port's parameters in ``cfg.dtype`` on ``device``.  The
    fused ``attn.c_attn`` ``[D, 3D]`` splits into wq/wk/wv and their
    biases; keys may carry the ``transformer.`` prefix (GPT2LMHeadModel)
    or not (GPT2Model).  The leaves do not require grad."""
    pref = "transformer." if any(k.startswith("transformer.") for k in sd) \
        else ""

    def get(name):
        return _np_arr(sd[pref + name])

    def t(a):
        return _to_tensor(a, device, cfg.dtype)

    layers = []
    for i in range(cfg.n_layers):
        b = f"h.{i}."
        wq, wk, wv = np.split(get(b + "attn.c_attn.weight"), 3, axis=1)
        bq, bk, bv = np.split(get(b + "attn.c_attn.bias"), 3, axis=0)
        layers.append({
            "ln1_scale": t(get(b + "ln_1.weight")),
            "ln1_bias": t(get(b + "ln_1.bias")),
            "wq": t(wq), "bq": t(bq), "wk": t(wk), "bk": t(bk),
            "wv": t(wv), "bv": t(bv),
            "wo": t(get(b + "attn.c_proj.weight")),
            "bo": t(get(b + "attn.c_proj.bias")),
            "ln2_scale": t(get(b + "ln_2.weight")),
            "ln2_bias": t(get(b + "ln_2.bias")),
            "w_in": t(get(b + "mlp.c_fc.weight")),
            "b_in": t(get(b + "mlp.c_fc.bias")),
            "w_out": t(get(b + "mlp.c_proj.weight")),
            "b_out": t(get(b + "mlp.c_proj.bias")),
        })
    wte = get("wte.weight")
    if wte.shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"wte {wte.shape} != config "
                         f"({cfg.vocab_size}, {cfg.d_model})")
    return {
        "wte": t(wte),
        "wpe": t(get("wpe.weight")[:cfg.max_seq]),
        "layers": layers,
        "lnf_scale": t(get("ln_f.weight")),
        "lnf_bias": t(get("ln_f.bias")),
    }


def to_hf_state_dict(params: Dict, cfg: GPT2Config,
                     prefix: str = "transformer.") -> Dict[str, np.ndarray]:
    """The port's parameters -> HuggingFace ``GPT2LMHeadModel`` naming
    (numpy float32): the inverse of :func:`from_hf_state_dict` (the fused
    c_attn concatenated again), with the tied ``lm_head.weight``."""
    sd: Dict[str, np.ndarray] = {}

    def f32(x):
        return _np_arr(x).astype(np.float32)

    def put(name, x):
        sd[prefix + name] = f32(x)

    put("wte.weight", params["wte"])
    put("wpe.weight", params["wpe"])
    for i, p in enumerate(params["layers"]):
        b = f"h.{i}."
        put(b + "ln_1.weight", p["ln1_scale"])
        put(b + "ln_1.bias", p["ln1_bias"])
        put(b + "attn.c_attn.weight", np.concatenate(
            [f32(p["wq"]), f32(p["wk"]), f32(p["wv"])], axis=1))
        put(b + "attn.c_attn.bias", np.concatenate(
            [f32(p["bq"]), f32(p["bk"]), f32(p["bv"])], axis=0))
        put(b + "attn.c_proj.weight", p["wo"])
        put(b + "attn.c_proj.bias", p["bo"])
        put(b + "ln_2.weight", p["ln2_scale"])
        put(b + "ln_2.bias", p["ln2_bias"])
        put(b + "mlp.c_fc.weight", p["w_in"])
        put(b + "mlp.c_fc.bias", p["b_in"])
        put(b + "mlp.c_proj.weight", p["w_out"])
        put(b + "mlp.c_proj.bias", p["b_out"])
    put("ln_f.weight", params["lnf_scale"])
    put("ln_f.bias", params["lnf_bias"])
    sd["lm_head.weight"] = f32(params["wte"])        # tied
    return sd
