"""Llama-family decoder: the dense serving and training surface, with
tensor, sequence and expert parallelism in training and tensor
parallelism in decode.

Port of ``horovod_tpu/models/llama.py:37-230, 275-577, 586-1044``, with
the mixture-of-experts MLP (:100-108, 177-189, 204-218, 252-254, 413-433,
562-575).  The parameters are a plain dictionary in the JAX package's
own layout (``{"embed", "layers": [...], "final_norm", "lm_head"}``), and
every weight keeps the JAX ``[in, out]`` layout: a projection is ``x @
w``, never ``nn.Linear``'s ``x @ w.T``.  :func:`params_from_jax` carries a JAX
parameter tree (as numpy arrays) over unchanged.

Training and prefill attend through flash attention (the Hopper kernels on
a card, their plain versions on the CPU); the training step differentiates
through the flash backward.  Parameters are leaves that require grad;
:func:`make_train_step` runs one step of a torch optimizer, such as
``hvd.DistributedOptimizer``, which averages gradients across processes
(the JAX ``sync_grads`` is the identity with every mesh axis off, and the
optimizer does that job here).  Decode attention over the cache is a
plain masked product, as in the JAX package, because at one query row there
is no score matrix to tile.  The KV cache is updated in place, where the
JAX functions return a new one; the functions still return it.

Sequence parallelism: ``forward``, ``loss_fn`` and ``make_train_step``
take a :class:`~horovod_tpu_torch.parallel.ProcessMesh` (``mesh=``), the
counterpart of ``shard_map`` binding the axis names.  Where the mesh's
``cfg.sp_axis`` has a size above 1, each rank holds ``[B, T/sp]`` tokens
in rank order along it, attention is ``ring_attention`` or
``ulysses_attention`` (``cfg.sp_impl``) and positions start at
``sp_rank · T/sp``.  With no mesh, no such axis or an axis of size 1 the
path is the single-rank one.

Tensor parallelism (Megatron): where the mesh's ``cfg.tp_axis`` has a size
above 1, each rank holds its block of columns of ``wq``/``wk``/``wv``/
``w1``/``w3`` and of rows of ``wo``/``w2`` (:func:`param_specs`,
:func:`shard_params`): q heads ``[r·H/tp, (r+1)·H/tp)`` and kv heads
``[r·K/tp, (r+1)·K/tp)``, so that GQA groups stay within a rank.  Each
column-split block takes its input through the mesh's ``CopyInput``
(``f``) and each row-split product's output goes through ``ReduceOutput``
(``g``); every tp rank then holds the same activations, logits and loss.
The tp shards train through ``parallel.ShardedParallel`` (averaged over
the ranks holding the same block, never over tp), the replicated leaves
through ``DistributedOptimizer`` as before.  ``init_cache``,
``prefill``, ``decode_step``, ``decode_chunk`` and ``generate`` take the
mesh too: the cache holds ``K/tp`` kv heads a rank, every tp rank ends
with the whole logits and so picks the same tokens, and a mesh with a dp,
sp, pp or ep axis above size 1 is refused there, as the JAX
``_decode_axes_check`` refuses those axes.

Mixture-of-experts: with ``n_experts > 0`` each layer's MLP is
``models/moe.py``'s routed experts (``"moe"`` in place of w1/w3/w2), and
:func:`mixtral_8x7b` is Mixtral's geometry.  Where the mesh has
``cfg.ep_axis``, each rank holds its slab of every layer's experts
(:func:`shard_experts`), tokens are a data split over dp × ep, and the
buffer travels by all-to-all; :func:`param_specs` names the sharded leaves
for ``parallel.ExpertParallel`` (the gradient rule and the broadcast) and
:func:`make_train_step` steps both optimizers.  ``forward``/``loss_fn``
add the router losses as the JAX ``loss_fn`` does.  Prefill and decode run
the MoE MLP with every expert local (ep off).  The MoE MLP is not
tp-split: the tp ranks compute the same routing and experts redundantly.

Pipeline parallelism (GPipe): with ``cfg.pp_axis`` set, the layers are
stacked as in the JAX package (``params["layers"]`` a dict of ``[n_layers,
...]`` leaves; :func:`stack_layers` and :func:`unstack_layers` convert), so
that a JAX pp tree carries over through :func:`params_from_jax` unchanged
and :func:`param_specs` names each slab's split as the JAX ``P(pp, ...)``
does (``Splits``).  Stacking keeps one leaf a weight for any pp, the JAX
layout and the names ``layers.wq``; a stage unbinds its slab once a tick.
:func:`shard_params` keeps this stage's contiguous slab ``[s·L/pp,
(s+1)·L/pp)``.  Where the mesh's pp axis has a size above 1, the forward
runs ``parallel.pipeline_apply`` over ``cfg.n_microbatches``: stage 0
embeds, each stage runs its slab, and the MoE router losses ride the
pipeline's aux as per-stage partials, averaged over the microbatches and
summed over pp.  ``cfg.pp_loss`` places the loss: ``"broadcast"`` sums the
pipeline's output over pp and every stage computes the head and the loss;
``"last_stage"`` computes them on the last stage only and hands the loss's
value to the other stages by a scalar sum over pp, which carries no
gradient.  The slabs train through ``parallel.ShardedParallel`` (pp is not
a data axis).  The replicated leaves stay in ``DistributedOptimizer``,
whose world average would divide a gradient that only one stage holds by
pp: ``embed``'s (stage 0's) and, under ``"last_stage"``, ``lm_head``'s and
``final_norm``'s (the last stage's).  So those gradients are scaled by pp
where they arise (:func:`_pp_grad_scale`), and the average lands on the
JAX ``sync_grads`` sum over pp.  ``remat_stages`` checkpoints each stage,
``remat_layers`` each layer of the forward without a pipeline.  Decode
refuses pp.

Serving surface (JAX :117-130, 153-159, 221-227, 626-676, 710-851,
923-1020): :func:`mistral_7b` is Mistral-7B's geometry (Llama with a
4,096-token sliding window).  With ``rolling_cache`` the KV cache is a
ring of ``sliding_window + rolling_slack`` slots (position p at slot p mod
R): :func:`init_cache` allocates the ring, :func:`prefill` writes the last
``min(T0, R)`` prompt positions at their slots while the whole prompt
attends through the windowed flash forward, :func:`decode_chunk` maps each
slot back to the position it holds, and :func:`generate` has no length
budget.  :func:`speculative_generate` is greedy speculative decoding: a
draft model proposes ``n_draft`` tokens a round, the target verifies them
in one :func:`decode_chunk`, and the output is greedy :func:`generate`'s
up to near-ties of the two products.  ``models/convert.py`` maps Hugging
Face state dicts onto these parameters and back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..functions import _leaves
from ..ops.flash_attention import NEG_INF, flash_attention
from ..parallel.expert import (Split, Splits, refuse_world_averaged,
                               shard_on_mesh, splits_of)
from ..parallel.mesh import CopyInput, ReduceOutput
from ..parallel.ring_attention import ring_attention
from ..parallel.ulysses import ulysses_attention


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
    # The mesh axis the sequence is split over (None: never split), and
    # its engine: "ring" (k/v rotate; any head count, O(T/sp) memory) or
    # "ulysses" (two all-to-alls to a head-split layout; needs the q AND
    # kv heads divisible by sp).
    sp_axis: Optional[str] = "sp"
    sp_impl: str = "ring"
    # The mesh axis the heads and the MLP's hidden units are split over
    # (Megatron; None: never split).
    tp_axis: Optional[str] = "tp"
    # Sliding-window (Mistral-style) causal attention over the last
    # ``sliding_window`` positions; the flash kernel skips whole tiles
    # outside the band.  Not with sequence parallelism.
    sliding_window: Optional[int] = None
    # Rolling KV cache for windowed decode: a ring of ``sliding_window +
    # rolling_slack`` slots (position p at slot p mod R) in place of
    # max_seq, so serving memory is O(W) and generation unbounded.  The
    # slack keeps a chunk's writes (decode_chunk, the speculative verify)
    # off slots its own earlier rows still attend: any chunk of up to
    # ``rolling_slack`` tokens is safe.
    rolling_cache: bool = False
    rolling_slack: int = 8
    norm_eps: float = 1e-5
    # Mixture-of-experts MLP (models/moe.py): n_experts > 0 replaces the
    # dense w1/w3/w2 MLP with routed experts; ``ep_axis`` shards them (a
    # DATA axis for everything else: tokens split over dp × ep).
    n_experts: int = 0
    ep_axis: Optional[str] = None
    capacity_factor: float = 1.25
    aux_weight: float = 0.01           # router load-balance loss weight
    router_mode: str = "tokens"        # "tokens" | "expert_choice"
    router_top_k: int = 1              # 1 = Switch, >=2 = GShard top-k
    router_z_weight: float = 0.0       # ST-MoE z-loss weight (0 = off)
    router_noise: float = 0.0          # router jitter std (needs generator=)
    moe_gated: bool = False            # SwiGLU experts (Mixtral shape)
    # The data axis of the mesh (its coordinate folds the router noise).
    dp_axis: Optional[str] = "dp"
    # Pipeline parallelism: the mesh axis the stacked layers are split over
    # in contiguous slabs (None: per-layer list, no pipeline), the
    # microbatches of its GPipe schedule (the batch must divide by it),
    # each stage checkpointed (its forward recomputed in the backward),
    # and where the loss is computed: "broadcast" (every stage, from the
    # output summed over pp) or "last_stage" (the last stage; a scalar sum
    # hands its value to the others).
    pp_axis: Optional[str] = None
    n_microbatches: int = 2
    remat_stages: bool = False
    # Checkpoint each layer of the forward without a pipeline.
    remat_layers: bool = False
    pp_loss: str = "broadcast"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self):
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"sp_impl must be 'ring' or 'ulysses', got "
                f"{self.sp_impl!r}")
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1 (or None to disable), got "
                f"{self.sliding_window!r}")
        if self.rolling_cache:
            if not self.sliding_window:
                raise ValueError("rolling_cache requires sliding_window "
                                 "(a full-attention model needs every "
                                 "past position)")
            if self.rolling_slack < 1:
                raise ValueError("rolling_slack must be >= 1")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} must be a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")
        if self.pp_loss not in ("broadcast", "last_stage"):
            raise ValueError(
                f"pp_loss must be 'broadcast' or 'last_stage', got "
                f"{self.pp_loss!r}")

    def moe_cfg(self):
        """The ``models.moe`` config of this model's MoE MLP (init, specs
        and forward all derive from it)."""
        from . import moe as _moe
        return _moe.MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff,
            n_experts=self.n_experts, capacity_factor=self.capacity_factor,
            ep_axis=self.ep_axis, router_mode=self.router_mode,
            router_top_k=self.router_top_k,
            router_z_weight=self.router_z_weight,
            router_noise=self.router_noise, gated=self.moe_gated,
            dtype=self.dtype)


def tiny(vocab_size: int = 256, d_model: int = 64, n_layers: int = 2,
         n_heads: int = 4, n_kv_heads: int = 2, d_ff: int = 128,
         max_seq: int = 128, **kw) -> LlamaConfig:
    """Small config for tests / dryruns."""
    return LlamaConfig(vocab_size=vocab_size, d_model=d_model,
                       n_layers=n_layers, n_heads=n_heads,
                       n_kv_heads=n_kv_heads, d_ff=d_ff, max_seq=max_seq, **kw)


def llama3_8b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)  # defaults above are the 8B geometry


def mixtral_8x7b(**kw) -> LlamaConfig:
    """Mixtral-8x7B geometry: Mistral attention + 8 SwiGLU experts with
    normalized top-2 routing.  ``capacity_factor=4.0`` (= n_experts /
    top_k) gives every expert worst-case capacity, so no token is ever
    dropped (Mixtral has no capacity drops); training at scale usually
    wants 1.25-2.0, and drops then take the residual path."""
    return LlamaConfig(**{**dict(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq=32768, rope_theta=1e6,
        n_experts=8, router_top_k=2, moe_gated=True, capacity_factor=4.0,
        ep_axis="ep"), **kw})


def mistral_7b(**kw) -> LlamaConfig:
    """Mistral-7B geometry (JAX :221-227): the Llama architecture with
    sliding-window attention over 4,096 positions (the flash kernel skips
    whole tiles outside the band)."""
    return LlamaConfig(**{**dict(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq=32768, rope_theta=10000.0,
        sliding_window=4096), **kw})


# ------------------------------------------------------------------- params
def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters, ``N(0, 1/fan_in)``, drawn from ``generator`` on
    ``device`` (the generator's own device by default), as leaves that
    require grad.  Every leaf is whole: :func:`shard_params` cuts a rank's
    tp blocks and expert slab."""
    device = torch.device(device) if device is not None else \
        generator.device
    D, H, K, Hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    dt = cfg.dtype

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * (1.0 / np.sqrt(fan_in))).to(dt).requires_grad_(True)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device,
                          requires_grad=True)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(D),
            "wq": dense(D, (D, H * Hd)),
            "wk": dense(D, (D, K * Hd)),
            "wv": dense(D, (D, K * Hd)),
            "wo": dense(H * Hd, (H * Hd, D)),
            "mlp_norm": ones(D),
        }
        if cfg.n_experts:
            from . import moe as _moe
            layer["moe"] = _moe.init_params(cfg.moe_cfg(), generator, device)
        else:
            layer |= {
                "w1": dense(D, (D, F)),
                "w3": dense(D, (D, F)),
                "w2": dense(F, (F, D)),
            }
        layers.append(layer)
    params = {
        "embed": dense(D, (cfg.vocab_size, D)),
        "layers": layers,
        "final_norm": ones(D),
        "lm_head": dense(D, (D, cfg.vocab_size)),
    }
    return stack_layers(params) if cfg.pp_axis else params


def _stacked(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stacked([lay[k] for lay in layers]) for k in first}
    out = torch.stack([t.detach() for t in layers])
    return out.requires_grad_(first.requires_grad)


def stack_layers(params) -> Dict:
    """``params`` with its per-layer list as one dict of ``[n_layers,
    ...]`` leaves (the layout of a ``pp_axis`` config, JAX :262-266); new
    leaves that require grad where the layers' did."""
    return {**params, "layers": _stacked(params["layers"])}


def _n_stacked(slab) -> int:
    return next(iter(_leaves(slab)))[1].shape[0]


def unstack_layers(params) -> Dict:
    """The inverse of :func:`stack_layers`: the per-layer list, each leaf
    a fresh contiguous copy (requiring grad where the stack did)."""
    slab = params["layers"]

    def copy(t):
        return t.detach().clone().requires_grad_(t.requires_grad)
    layers = [_tree_map(copy, lay)
              for lay in _unbound(slab, _n_stacked(slab))]
    return {**params, "layers": layers}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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
    port's parameters, layouts unchanged (``[in, out]`` weights).  The
    leaves do not require grad; ``requires_grad_()`` them to train."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    return _to_tensor(tree, device, dtype)


def param_specs(cfg: LlamaConfig) -> Dict:
    """The mesh axis and dimension each leaf is split over, shaped like the
    parameters (JAX :275-311): ``wq``/``wk``/``wv``/``w1``/``w3`` by
    columns over ``cfg.tp_axis`` (``Split(tp, 1)``, the JAX ``P(None,
    tp)``), ``wo``/``w2`` by rows (``Split(tp, 0)``), the experts' slabs
    over ``cfg.ep_axis`` along dim 0, everything else None (replicated).
    With ``cfg.pp_axis`` every stacked layer leaf is split over pp along
    dim 0 as well (a ``Splits``, JAX :297-300).
    ``parallel.ShardedParallel`` and :func:`shard_params` read it."""
    tp = cfg.tp_axis
    cols, rows = (Split(tp, 1), Split(tp, 0)) if tp else (None, None)
    layer = {"attn_norm": None, "wq": cols, "wk": cols, "wv": cols,
             "wo": rows, "mlp_norm": None}
    if cfg.n_experts:
        from . import moe as _moe
        layer["moe"] = _moe.param_specs(cfg.moe_cfg())
    else:
        layer |= {"w1": cols, "w3": cols, "w2": rows}
    if cfg.pp_axis:
        # The stacked slabs, the JAX P(pp, *spec): pp along dim 0, every
        # other split one dimension further.
        def slab(spec):
            if isinstance(spec, dict):
                return {k: slab(v) for k, v in spec.items()}
            return Splits((Split(cfg.pp_axis, 0),) + tuple(
                Split(p.axis, p.dim + 1) for p in splits_of(spec)))
        layers = slab(layer)
    else:
        layers = [dict(layer) for _ in range(cfg.n_layers)]
    return {"embed": None, "layers": layers, "final_norm": None,
            "lm_head": None}


def shard_params(params, cfg: LlamaConfig, mesh, axes=None):
    """``params`` (whole: :func:`init_params`, or a JAX tree through
    :func:`params_from_jax`) cut to this rank's blocks along every axis of
    ``mesh`` of a size above 1 that :func:`param_specs` splits a leaf over
    (those among ``axes`` only, when given): its tp columns and rows, its
    expert slab and its pipeline stage's layers.  A cut leaf is a fresh
    copy; the tree itself where no axis cuts."""
    return shard_on_mesh(params, param_specs(cfg), mesh, axes)


def shard_experts(params, cfg: LlamaConfig, mesh):
    """:func:`shard_params` along ``cfg.ep_axis`` alone: each layer's
    experts cut to this rank's slab."""
    return shard_params(params, cfg, mesh, (cfg.ep_axis,))


def named_parameters(params) -> Iterator[Tuple[str, torch.Tensor]]:
    """``("layers.0.wq", tensor)`` pairs in the sorted path order that
    ``broadcast_parameters`` walks, for ``DistributedOptimizer``'s
    ``named_parameters``."""
    for path, t in sorted(_leaves(params), key=lambda kv: kv[0]):
        if isinstance(t, torch.Tensor):
            yield ".".join(map(str, path)), t


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


def _tp(cfg: LlamaConfig, mesh) -> int:
    """The tensor-parallel degree: the size of ``cfg.tp_axis`` in
    ``mesh``, 1 without a mesh or without that axis."""
    if mesh is None or cfg.tp_axis is None \
            or cfg.tp_axis not in mesh.axis_names:
        return 1
    return mesh.size(cfg.tp_axis)


def _copy_in(x, cfg, mesh):
    """Megatron's ``f`` on the input of a column-split block (the identity
    without tensor parallelism).  Shared with BERT and GPT-2, whose
    configs carry ``tp_axis`` too."""
    if _tp(cfg, mesh) == 1:
        return x
    return CopyInput.apply(x, mesh, cfg.tp_axis)


def _reduce_out(x, cfg, mesh):
    """Megatron's ``g`` after a row-split product: the sum over the tp
    ranks (JAX ``lax.psum(.., tp)``)."""
    if _tp(cfg, mesh) == 1:
        return x
    return ReduceOutput.apply(x, mesh, cfg.tp_axis)


def _qkv(x, p, cfg: LlamaConfig, positions, mesh=None):
    """Project + rope this rank's head shard: the qkv contract shared by
    the forward, prefill and decode so the three paths cannot drift."""
    B, T, _ = x.shape
    tp = _tp(cfg, mesh)
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads}/n_kv_heads={cfg.n_kv_heads} "
                         f"must be divisible by tp={tp}")
    H, K, Hd = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim
    x = _copy_in(x, cfg, mesh)
    q = (x @ p["wq"]).reshape(B, T, H, Hd)
    k = (x @ p["wk"]).reshape(B, T, K, Hd)
    v = (x @ p["wv"]).reshape(B, T, K, Hd)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _wo_project(out, p, cfg: LlamaConfig, mesh=None):
    """The row-split output projection and its sum over tp: the shared
    epilogue of every attention path."""
    B, T = out.shape[:2]
    return _reduce_out(out.reshape(B, T, -1) @ p["wo"], cfg, mesh)


def _local_attend(q, k, v, cfg: LlamaConfig):
    """Causal attention through the flash forward (sliding window when the
    config asks for it)."""
    return flash_attention(q, k, v, causal=True, window=cfg.sliding_window)


def _sp(cfg: LlamaConfig, mesh) -> int:
    """The sequence-parallel degree: the size of ``cfg.sp_axis`` in
    ``mesh``, 1 without a mesh or without that axis."""
    if mesh is None or cfg.sp_axis is None \
            or cfg.sp_axis not in mesh.axis_names:
        return 1
    return mesh.size(cfg.sp_axis)


def _attend(q, k, v, cfg: LlamaConfig, mesh):
    """Causal self-attention of this rank's shard: over the sp ring or by
    head exchange when the sequence is split, else local.  GQA kv passes
    un-repeated either way."""
    sp = _sp(cfg, mesh)
    if sp > 1 and cfg.sliding_window:
        raise ValueError(
            "sliding_window composes with dp/tp/pp/ep but not (yet) with "
            "sequence parallelism — disable sp_axis or the window")
    if sp > 1 and cfg.sp_impl == "ulysses":
        return ulysses_attention(q, k, v, mesh, axis_name=cfg.sp_axis,
                                 causal=True)
    if sp > 1:
        return ring_attention(q, k, v, mesh, axis_name=cfg.sp_axis,
                              causal=True)
    return _local_attend(q, k, v, cfg)


def _mlp(x, p, cfg: LlamaConfig, mesh=None):
    """Dense SwiGLU MLP: this rank's hidden units, summed over tp."""
    x = _copy_in(x, cfg, mesh)
    h = torch.nn.functional.silu(x @ p["w1"]) * (x @ p["w3"])
    return _reduce_out(h @ p["w2"], cfg, mesh)


def _moe_mlp(x, p, cfg: LlamaConfig, mesh=None, generator=None):
    """The routed experts of ``models/moe.py`` in place of :func:`_mlp`:
    ``(y, [aux, z_loss])``.  The experts' all-to-alls run where ``mesh``
    has ``cfg.ep_axis``."""
    from . import moe as _moe
    B, T, D = x.shape
    y, aux, zl = _moe.moe_ffn(x.reshape(B * T, D), p["moe"], cfg.moe_cfg(),
                              mesh, generator)
    return y.reshape(B, T, D), torch.stack([aux, zl])


def _layer_apply(p, x, cfg: LlamaConfig, positions, mesh=None,
                 generator=None):
    """``(x, router_losses)``: the router losses None for a dense layer."""
    h = _rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(h, p, cfg, positions, mesh)
    x = x + _wo_project(_attend(q, k, v, cfg, mesh), p, cfg, mesh)
    h = _rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    if not cfg.n_experts:
        return x + _mlp(h, p, cfg, mesh), None
    y, router = _moe_mlp(h, p, cfg, mesh, generator)
    return x + y, router


def forward(params, tokens, cfg: LlamaConfig, mesh=None, generator=None):
    """Logits ``[B, T, vocab]`` for this rank's ``tokens [B, T]``: with
    the sequence split over ``mesh``, its ``T`` positions start at
    ``sp_rank · T``.  ``generator`` threads router jitter.  Under a
    pipeline with ``pp_loss="last_stage"`` only the last stage's are
    real."""
    return _forward(params, tokens, cfg, mesh, generator)[0]


def _pp(cfg: LlamaConfig, mesh) -> int:
    """The pipeline degree: the size of ``cfg.pp_axis`` in ``mesh``, 1
    without a mesh or without that axis."""
    if mesh is None or cfg.pp_axis is None \
            or cfg.pp_axis not in mesh.axis_names:
        return 1
    return mesh.size(cfg.pp_axis)


class _ScaleGrad(torch.autograd.Function):
    """The identity whose backward multiplies the cotangent by a
    factor."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _pp_grad_scale(x, cfg: LlamaConfig, mesh):
    """``x`` with its gradient times pp: the gradient rule of a replicated
    leaf that one stage alone uses (``embed`` on stage 0; ``lm_head`` and
    ``final_norm`` on the last stage under ``"last_stage"``).  The other
    stages hold none, so ``DistributedOptimizer``'s world average divides
    it by pp; this factor lands the average on the JAX ``sync_grads`` sum
    over pp (exact for a power of two).  ``optimizer.op=Adasum`` does not
    average and is refused with pp (:func:`make_train_step`)."""
    pp = _pp(cfg, mesh)
    return x if pp == 1 else _ScaleGrad.apply(x, float(pp))


def _unbound(slab, n: int) -> List:
    """A stacked slab as ``n`` per-layer trees (``torch.unbind`` views:
    one stack of the layers' gradients in the backward)."""
    if isinstance(slab, dict):
        parts = {k: _unbound(v, n) for k, v in slab.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(slab))


def _pipelined(params, tokens, cfg: LlamaConfig, mesh, positions,
               generator):
    """The layers as a GPipe pipeline over ``cfg.pp_axis`` (JAX
    :479-510): ``(h [B, T, D], router)``, ``h`` real on the last stage
    (every stage under ``"broadcast"``), the router losses this stage's
    partial averaged over the microbatches."""
    from ..parallel.pipeline import microbatch, pipeline_apply
    from .moe import fold_in
    B, T = tokens.shape
    pp = _pp(cfg, mesh)
    stage = mesh.index(cfg.pp_axis) if pp > 1 else 0
    if stage == 0:
        x = _pp_grad_scale(params["embed"][tokens.long()], cfg, mesh)
    else:
        # Only stage 0 reads the input: a zero-stride placeholder of its
        # shape.
        x = params["embed"].detach().new_zeros(()).expand(
            B, T, cfg.d_model)
    slab = params["layers"]
    per_stage = _n_stacked(slab)
    if per_stage * pp != cfg.n_layers:
        raise ValueError(
            f"this stage holds {per_stage} of {cfg.n_layers} layers over "
            f"pp={pp}; cut its slab with shard_params(params, cfg, mesh)")

    def stage_fn(slab, h):
        router = torch.zeros(2, dtype=torch.float32, device=h.device)
        for j, p in enumerate(_unbound(slab, per_stage)):
            # The generator is made here, from its seed, so that a
            # recomputation (remat_stages) draws the same noise.
            h, r = _layer_apply(
                p, h, cfg, positions, mesh,
                fold_in(generator, stage * per_stage + j)
                if cfg.n_experts else None)
            if r is not None:
                router = router + r
        return h, router

    outs, router = pipeline_apply(
        stage_fn, slab, microbatch(x, cfg.n_microbatches), mesh,
        cfg.pp_axis, broadcast_out=(cfg.pp_loss == "broadcast"),
        remat=cfg.remat_stages, with_aux=True,
        aux_init=torch.zeros(2, dtype=torch.float32, device=x.device))
    # The router losses are per-token means: one a microbatch, averaged
    # (else n_microbatches would scale the objective).
    return (outs.reshape(B, T, -1),
            router / cfg.n_microbatches if cfg.n_experts else None)


def _trunk(params, tokens, cfg: LlamaConfig, mesh=None, generator=None):
    """``(h, router)``: the activations after the last layer (before the
    final norm) and the router losses ``[2]`` summed over the layers (None
    for a dense model).  ``generator`` is folded with every data axis's
    coordinate (dp, ep, sp) and then per layer, as the JAX ``rng`` is."""
    from .moe import data_generator, fold_in
    T = tokens.shape[1]
    start = mesh.index(cfg.sp_axis) * T if _sp(cfg, mesh) > 1 else 0
    positions = start + torch.arange(T, device=tokens.device)
    if cfg.n_experts:
        generator = data_generator(generator, mesh,
                                   (cfg.dp_axis, cfg.ep_axis, cfg.sp_axis))
    if cfg.pp_axis:
        return _pipelined(params, tokens, cfg, mesh, positions, generator)
    x = params["embed"][tokens.long()]
    router = None
    for i, p in enumerate(params["layers"]):
        def layer(p, x, i=i):
            # The generator is made inside, so that a recomputation
            # (remat_layers) draws the same noise.
            return _layer_apply(p, x, cfg, positions, mesh,
                                fold_in(generator, i)
                                if cfg.n_experts else None)
        if cfg.remat_layers:
            from torch.utils.checkpoint import checkpoint
            x, r = checkpoint(layer, p, x, use_reentrant=False)
        else:
            x, r = layer(p, x)
        if r is not None:
            router = r if router is None else router + r
    return x, router


def _forward(params, tokens, cfg: LlamaConfig, mesh=None, generator=None):
    """``(logits, router_losses [2])``: see :func:`_trunk`."""
    h, router = _trunk(params, tokens, cfg, mesh, generator)
    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return h @ params["lm_head"], router


# ----------------------------------------------------------------- training
def loss_fn(params, tokens, targets, cfg: LlamaConfig, mesh=None,
            generator=None):
    """Mean next-token cross-entropy over this rank's tokens, logits in
    float32, plus with ``n_experts`` the router losses (``aux_weight`` ×
    aux + ``router_z_weight`` × z, each the mean over the layers), as the
    JAX ``loss_fn`` adds them.

    The JAX ``loss_fn`` returns a partial loss scaled by 1/(global token
    count), which ``sync_grads`` sums over the ranks.  Here
    ``hvd.DistributedOptimizer`` averages the gradients over the dp × sp
    ranks instead, so each rank's loss is the mean over its own tokens;
    that average is the gradient of the global mean because the ring's
    backward returns every dk/dv contribution to the rank that owns the
    k/v (Ulysses' exchange is its own inverse) and every rank holds the
    same number of tokens.  With experts split over ep (a data axis),
    the experts' slabs follow ``parallel.ExpertParallel``'s rule.  Under
    tensor parallelism every tp rank computes this same loss (the JAX
    loss divides it by tp instead), and the tp shards' gradients are
    exact for it (``parallel.ShardedParallel``).

    Under a pipeline every stage returns the same value: with
    ``"broadcast"`` each computes it from the summed output, with
    ``"last_stage"`` the last stage computes it and a scalar sum over pp
    (no gradient) hands it to the others, whose own term is a zero that
    still reaches the pipeline's backward (JAX :553-575).  The router
    losses, each stage's partial over its own layers, are summed over pp
    the same way (the backward hands each stage its own cotangent)."""
    h, router = _trunk(params, tokens, cfg, mesh, generator)
    pp = _pp(cfg, mesh)
    last_only = pp > 1 and cfg.pp_loss == "last_stage"
    if last_only and mesh.index(cfg.pp_axis) != pp - 1:
        loss = h.sum().float() * 0.0
    else:
        norm, head = params["final_norm"], params["lm_head"]
        if last_only:
            norm = _pp_grad_scale(norm, cfg, mesh)
            head = _pp_grad_scale(head, cfg, mesh)
        logits = (_rmsnorm(h, norm, cfg.norm_eps) @ head).float()
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())
    if last_only:
        loss = ReduceOutput.apply(loss, mesh, cfg.pp_axis)
    if cfg.n_experts:
        r = (cfg.aux_weight * router[0]
             + cfg.router_z_weight * router[1]) / cfg.n_layers
        if pp > 1:
            r = ReduceOutput.apply(r, mesh, cfg.pp_axis)
        loss = loss + r
    return loss


def psum_loss(loss, cfg: LlamaConfig, mesh=None):
    """The global mean loss, for logging: the mean of every rank's
    :func:`loss_fn` over the world (the mesh spans it) through the engine,
    as the JAX ``psum_loss`` sums the partial losses; this rank's loss
    without a mesh or in a world of one.  The tp ranks hold equal losses,
    and so do the pp stages under both placements (:func:`loss_fn`), so
    the world's mean is the data ranks'."""
    from .. import mpi_ops
    loss = loss.detach()
    if mesh is None or all(n == 1 for n in mesh.shape.values()):
        return loss
    return mpi_ops.allreduce(loss, op=mpi_ops.Average, name="llama.loss")


def make_train_step(cfg: LlamaConfig, optimizer, mesh=None, experts=None):
    """Returns ``step(params, tokens, targets, generator=None) -> loss``:
    zero the grads, forward, backward, ``optimizer.step()`` and, with
    ``experts`` (a ``parallel.ShardedParallel`` over the split leaves: the
    tp shards and the experts' slabs; ``ExpertParallel`` for slabs alone),
    ``experts.step()``.  The first step raises ``ValueError`` if
    ``optimizer`` is a ``DistributedOptimizer`` that steps a leaf split
    over an axis of ``mesh`` of a size above 1.  The loss is this rank's (of
    its tokens) for the parameters before the update; :func:`psum_loss`
    gives the global mean.  ``params`` must be the leaves ``optimizer``
    updates; with ``hvd.DistributedOptimizer`` the step averages the
    gradients across processes, and with ``sharded="full"`` it first
    rematerializes the parameters (``optimizer.gather_params()``), which
    only the shards hold between steps.  ``mesh``: as in
    :func:`forward`.  Under a pipeline, ``experts`` holds the stages'
    slabs too, and an ``optimizer`` with ``op=Adasum`` is refused (the pp
    factor of :func:`_pp_grad_scale` assumes an average).  ``step.audit(
    params, tokens, targets)`` is the per-rank loss and gradients without
    the update, which the collective audit traces."""
    full = getattr(optimizer, "sharded", False) == "full"
    checked = []

    def step(params, tokens, targets, generator=None):
        if not checked:
            refuse_world_averaged(optimizer, params, param_specs(cfg), mesh)
            from .. import mpi_ops
            if _pp(cfg, mesh) > 1 and \
                    getattr(optimizer, "op", None) == mpi_ops.Adasum:
                raise ValueError("pipeline parallelism scales the gradients "
                                 "of the replicated leaves for an average; "
                                 "op=Adasum does not average")
            checked.append(True)
        if full:
            optimizer.gather_params()
        optimizer.zero_grad()
        if experts is not None:
            experts.zero_grad()
        loss = loss_fn(params, tokens, targets, cfg, mesh, generator)
        loss.backward()
        optimizer.step()
        if experts is not None:
            experts.step()
        return loss.detach()

    def audit(params, tokens, targets, generator=None):
        """``(loss, grads)`` of the step without its update: what the
        collective audit traces (``parallel/spmd.py`` ``check=``)."""
        leaves = [t for _, t in named_parameters(params)
                  if t.requires_grad]
        loss = loss_fn(params, tokens, targets, cfg, mesh, generator)
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True)

    step.audit = audit
    return step


# ---------------------------------------------------------------- inference
def _decode_tp(cfg: LlamaConfig, mesh, what: str) -> int:
    """The tp degree of a decode call (JAX :679-690): tp heads split with
    the sum at ``wo``, the training contract; the training-only axes (dp is
    batching, sp and pp restructure the sequence and the depth, ep would
    need the all-to-all per token) are refused at a size above 1."""
    if cfg.pp_axis:
        raise ValueError(f"{what} runs on the per-layer list; a config "
                         f"with pp_axis={cfg.pp_axis!r} stacks the layers "
                         f"for the pipeline (decode on pp_axis=None and "
                         f"unstack_layers(params))")
    if mesh is not None:
        bad = [a for a in mesh.axis_names
               if a != cfg.tp_axis and mesh.size(a) > 1]
        if bad:
            raise ValueError(f"{what} supports tp only; the mesh's {bad} "
                             f"axes have sizes above 1 (decode on a mesh "
                             f"of the tp axis alone)")
    return _tp(cfg, mesh)


def init_cache(cfg: LlamaConfig, batch: int, max_seq: Optional[int] = None,
               device=None, mesh=None) -> List[Dict]:
    """Per-layer KV cache ``[B, max_seq, n_kv_heads / tp, head_dim]``
    (zeros): this rank's kv heads on a tp ``mesh``.  With
    ``cfg.rolling_cache`` the cache is a ring of ``sliding_window +
    rolling_slack`` slots and ``max_seq`` is ignored (JAX :635-638)."""
    tp = _decode_tp(cfg, mesh, "init_cache")
    if cfg.n_kv_heads % tp:
        raise ValueError(f"n_kv_heads={cfg.n_kv_heads} must divide by "
                         f"tp={tp} for the sharded cache")
    T = (cfg.sliding_window + cfg.rolling_slack if cfg.rolling_cache
         else max_seq or cfg.max_seq)
    shape = (batch, T, cfg.n_kv_heads // tp, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def cache_specs(cfg: LlamaConfig) -> List[Dict]:
    """The split of :func:`init_cache`'s tree under tp decode (JAX
    :799-804): the kv-head axis over ``cfg.tp_axis``, matching the
    column-split ``wk``/``wv``; ``parallel.shard_tree`` cuts a whole cache
    with it."""
    spec = Split(cfg.tp_axis, 2) if cfg.tp_axis else None
    return [{"k": spec, "v": spec} for _ in range(cfg.n_layers)]


def _check_cache_budget(t_final: int, cache_t: int,
                        cfg: Optional[LlamaConfig] = None):
    """Refuse to decode past the cache instead of writing out of range.  A
    rolling cache has no length budget: positions wrap (JAX :664-676)."""
    if cfg is not None and cfg.rolling_cache:
        return
    if t_final > cache_t:
        raise ValueError(
            f"decode would write position {t_final - 1} but the KV cache "
            f"has only {cache_t} slots; raise max_seq (init_cache) or "
            f"generate fewer tokens")


@torch.no_grad()
def decode_step(params, cache, tokens, pos: int, cfg: LlamaConfig,
                mesh=None):
    """One decode step: ``tokens [B]`` at position ``pos`` -> (logits
    [B, vocab] float32, cache).  The Tq=1 case of :func:`decode_chunk`."""
    logits, cache = decode_chunk(params, cache, tokens[:, None], pos, cfg,
                                 mesh)
    return logits[:, 0, :], cache


@torch.no_grad()
def decode_chunk(params, cache, tokens, pos: int, cfg: LlamaConfig,
                 mesh=None):
    """Cached forward over a short chunk ``tokens [B, Tq]`` starting at
    position ``pos`` -> (logits [B, Tq, vocab] float32, cache).  On a tp
    ``mesh`` this rank's heads and hidden units, and its kv heads in the
    cache; the logits are whole on every rank.

    The chunk's kv is written into the cache at ``[pos, pos+Tq)`` and row i
    attends the cache prefix ``<= pos + i`` (the last ``sliding_window`` of
    it with a window).  Attention is a plain masked product in float32 over
    the written prefix: the slots past it are masked in the JAX version and
    contribute exactly zero there.

    On a rolling cache (JAX :726-745, 760-775) position p lives at slot p
    mod R, and slot j holds ``p_j = end - ((end - j) mod R)``, the last
    position up to the chunk's end that maps there; row i attends the
    slots with ``p_j`` in ``(pos + i - W, pos + i]`` and ``p_j >= 0`` (a
    slot never written derives a negative position, which a context
    shorter than the window would otherwise reach).  A chunk longer than
    ``rolling_slack`` is refused: its later writes would overwrite slots
    its earlier rows still attend."""
    _decode_tp(cfg, mesh, "decode_chunk")
    B, Tq = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens.long()]                # [B, Tq, D]
    positions = pos + torch.arange(Tq, device=dev)
    R = cache[0]["k"].shape[1]
    if cfg.rolling_cache:
        if Tq > cfg.rolling_slack:
            raise ValueError(
                f"decode_chunk of {Tq} tokens exceeds rolling_slack="
                f"{cfg.rolling_slack}: earlier chunk rows would attend "
                f"slots the later writes just overwrote; raise "
                f"rolling_slack")
        end = pos + Tq - 1
        p_j = end - torch.remainder(
            end - torch.arange(R, device=dev)[None, :], R)    # [1, R]
        qpos = positions[:, None]                             # [Tq, 1]
        valid = (p_j >= 0) & (p_j <= qpos) \
            & (p_j > qpos - cfg.sliding_window)               # [Tq, R]
        slots = torch.remainder(positions, R)
        T = R
    else:
        _check_cache_budget(pos + Tq, R)
        T = pos + Tq
        t = torch.arange(T, device=dev)[None, :]
        valid = t <= positions[:, None]                   # [Tq, T]
        if cfg.sliding_window:
            valid = valid & (t > positions[:, None] - cfg.sliding_window)
    for p, c in zip(params["layers"], cache):
        h = _rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = _qkv(h, p, cfg, positions, mesh)
        H, K, Hd = q.shape[2], k_new.shape[2], q.shape[3]
        if not cfg.rolling_cache:
            c["k"][:, pos:pos + Tq] = k_new.to(c["k"].dtype)
            c["v"][:, pos:pos + Tq] = v_new.to(c["v"].dtype)
        elif Tq == 1:
            # The hot decode loop: one position is a contiguous write.
            c["k"][:, pos % R] = k_new[:, 0].to(c["k"].dtype)
            c["v"][:, pos % R] = v_new[:, 0].to(c["v"].dtype)
        else:
            c["k"][:, slots] = k_new.to(c["k"].dtype)
            c["v"][:, slots] = v_new.to(c["v"].dtype)
        ck, cv = c["k"][:, :T], c["v"][:, :T]
        # GQA groups against the shared kv, one extra chunk axis q.
        qg = q.reshape(B, Tq, K, H // K, Hd)
        s = torch.einsum("bqkrd,btkd->bkrqt", qg.float(), ck.float())
        s = s / np.sqrt(Hd)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkrqt,btkd->bqkrd", w.to(cv.dtype).float(),
                         cv.float())
        x = x + _wo_project(o.reshape(B, Tq, H, Hd).to(x.dtype), p, cfg,
                            mesh)
        h = _rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + (_moe_mlp(h, p, cfg)[0] if cfg.n_experts
                 else _mlp(h, p, cfg, mesh))
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float(), cache


@torch.no_grad()
def prefill(params, cache, tokens, cfg: LlamaConfig, mesh=None):
    """Batched prefill: fill the cache from a prompt ``[B, T0]`` in one pass
    over the layers; returns (last-position logits float32, cache).  Each
    layer projects q/k/v for the whole prompt, writes its kv into the cache
    at ``[0, T0)`` and attends causally through the flash forward (this
    rank's heads on a tp ``mesh``).  On a rolling cache only the last
    ``min(T0, R)`` positions, the only ones attended again, are written, at
    their ring slots (JAX :829-839); the whole prompt still attends
    through the windowed flash forward."""
    _decode_tp(cfg, mesh, "prefill")
    B, T0 = tokens.shape
    R = cache[0]["k"].shape[1]
    _check_cache_budget(T0, R, cfg)
    positions = torch.arange(T0, device=tokens.device)
    if cfg.rolling_cache:
        keep = min(T0, R)
        slots = positions[T0 - keep:] % R
    x = params["embed"][tokens.long()]                # [B, T0, D]
    for p, c in zip(params["layers"], cache):
        h = _rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(h, p, cfg, positions, mesh)
        if cfg.rolling_cache:
            c["k"][:, slots] = k[:, T0 - keep:].to(c["k"].dtype)
            c["v"][:, slots] = v[:, T0 - keep:].to(c["v"].dtype)
        else:
            c["k"][:, :T0] = k.to(c["k"].dtype)
            c["v"][:, :T0] = v.to(c["v"].dtype)
        x = x + _wo_project(_local_attend(q, k, v, cfg), p, cfg, mesh)
        h = _rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + (_moe_mlp(h, p, cfg)[0] if cfg.n_experts
                 else _mlp(h, p, cfg, mesh))
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
             generator: Optional[torch.Generator] = None, mesh=None):
    """Generation: ``prompt [B, T0]`` -> ``[B, n_tokens]`` int32.

    Greedy by default; ``temperature > 0`` samples from ``generator``.
    The cache holds ``max_seq`` slots, by default just the prompt and the
    new tokens (the JAX function defaults to ``cfg.max_seq``; the extra
    slots are masked there and change nothing but memory); a rolling cache
    holds its ring and has no length budget.  On a tp
    ``mesh`` every rank holds the whole logits, so greedy and seeded
    sampling agree across the group as long as every rank passes the same
    prompt and an equally seeded ``generator``."""
    B, T0 = prompt.shape
    if n_tokens < 1:
        return torch.zeros((B, 0), dtype=torch.int32, device=prompt.device)
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires generator=")
    cache = init_cache(cfg, B, max_seq or T0 + n_tokens,
                       device=prompt.device, mesh=mesh)
    # The last generated token's own kv is never written back, hence -1.
    _check_cache_budget(T0 + n_tokens - 1, cache[0]["k"].shape[1], cfg)
    logits, cache = prefill(params, cache, prompt, cfg, mesh)
    tok = sample_logits(logits, generator, temperature, top_p, top_k)
    out = [tok]
    for t in range(T0, T0 + n_tokens - 1):
        logits, cache = decode_step(params, cache, tok, t, cfg, mesh)
        tok = sample_logits(logits, generator, temperature, top_p, top_k)
        out.append(tok)
    return torch.stack(out, dim=1)


@torch.no_grad()
def speculative_generate(params, draft_params, prompt, n_tokens: int,
                         cfg: LlamaConfig,
                         draft_cfg: Optional[LlamaConfig] = None,
                         n_draft: int = 4, max_seq: Optional[int] = None):
    """Greedy speculative decoding (JAX :923-1020): ``prompt [B, T0]`` ->
    ``[B, n_tokens]`` int32.  A draft model proposes ``n_draft`` tokens a
    round; the target verifies them in one :func:`decode_chunk` over
    ``[last, d_1..d_k]`` and emits every leading match plus its own
    correction token.  The output is greedy :func:`generate`'s: the draft
    changes only how many target forwards it takes (1 + the accepted
    tokens a forward).  In bfloat16 that holds up to near-ties, since the
    chunk's products and a step's have other GEMM shapes.  Batched:
    acceptance is the least leading-match length over the rows.

    ``draft_cfg`` defaults to ``cfg`` and must share the vocabulary.  Each
    cache holds ``max_seq`` slots (by default ``T0 + n_tokens + n_draft``,
    so the last round's chunk fits) and keeps its own budget: a rolling
    target does not exempt a fixed draft.  Eager: a Python loop over
    rounds, with one read of the accepted count to the host a round.
    ``speculative_generate.rounds`` and ``.accepted`` count the rounds and
    the accepted draft tokens (reset them to 0 to read one call)."""
    draft_cfg = draft_cfg or cfg
    _decode_tp(cfg, None, "speculative_generate")
    _decode_tp(draft_cfg, None, "speculative_generate (draft)")
    B, T0 = prompt.shape
    if n_tokens < 1:
        return torch.zeros((B, 0), dtype=torch.int32, device=prompt.device)
    k = int(n_draft)
    if k < 1:
        raise ValueError("n_draft must be >= 1")
    budget = max_seq or (T0 + n_tokens + k)
    cache_t = init_cache(cfg, B, budget, device=prompt.device)
    cache_d = init_cache(draft_cfg, B, budget, device=prompt.device)
    _check_cache_budget(T0 + n_tokens + k, cache_t[0]["k"].shape[1], cfg)
    _check_cache_budget(T0 + n_tokens + k, cache_d[0]["k"].shape[1],
                        draft_cfg)

    logits_t, cache_t = prefill(params, cache_t, prompt, cfg)
    _, cache_d = prefill(draft_params, cache_d, prompt, draft_cfg)
    last = torch.argmax(logits_t, dim=-1).to(torch.int32)      # [B]
    out, n_done = [last[:, None]], 1
    while n_done < n_tokens:
        p0 = T0 + n_done - 1      # the position of `last`'s unwritten kv
        # k + 1 draft steps: the last one only writes d_k's own kv, so that
        # a fully accepted round leaves no hole in the draft cache.
        tok, drafts = last, []
        for i in range(k + 1):
            logits, cache_d = decode_step(draft_params, cache_d, tok,
                                          p0 + i, draft_cfg)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(tok)
        drafts = torch.stack(drafts[:k], dim=1)                 # [B, k]
        # Row i of the verify is the target's next token after p0 + i, so
        # t_i lines up with d_{i+1}.
        chunk = torch.cat([last[:, None], drafts], dim=1)
        logits, cache_t = decode_chunk(params, cache_t, chunk, p0, cfg)
        targets = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, k+1]
        match = (drafts == targets[:, :k]).to(torch.int32)
        a = int(torch.cumprod(match, dim=1).sum(dim=1).min())
        last = targets[:, a]
        out.append(torch.cat([drafts[:, :a], last[:, None]], dim=1))
        n_done += a + 1
        speculative_generate.rounds += 1
        speculative_generate.accepted += a
    return torch.cat(out, dim=1)[:, :n_tokens]


speculative_generate.rounds = 0
speculative_generate.accepted = 0
