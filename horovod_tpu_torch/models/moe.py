# Ported from horovod_tpu/models/moe.py: MoEConfig :41-77, init_params :80-95,
# param_specs :98-103, _route :106-199, moe_ffn :202-246, MoELMConfig
# :250-259, lm_init :262-274, lm_param_specs :277-279, lm_loss :282-319 and
# make_train_step :340-363 (lm_sync_grads :322-337 is parallel/expert.py).
"""Mixture-of-experts with expert parallelism over the mesh's ``ep`` axis.

Switch-style capacity routing, as in the JAX package: every expert takes
exactly ``capacity`` token slots from each source rank, over-capacity
tokens are dropped (their output is zero: the caller's residual passes
them through) and free slots are zero padding.  Token choice picks each
token's top-k experts (k = 1: the raw router probability as the gate,
Switch; k >= 2: the chosen probabilities normalised to sum to one,
GShard), later choices slotted after every earlier choice's tokens;
expert choice lets each expert take its top-``capacity`` tokens.  The
Switch load-balancing loss, the ST-MoE router z-loss and router noise come
with it.

The JAX package dispatches and combines with one-hot einsums over a dense
``[S, E, C]`` mask, O(S·E·C·D) work the MXU does well.  The port computes
the same function with index operations: the kept tokens' rows are copied
to their (expert, slot) rows of the ``[E, C, D]`` buffer, and the output is
the gate-weighted sum of the rows each token's slots hold.  :func:`_route`
returns the routing as indices (a :class:`Routing`); :func:`dense_masks`
materialises the JAX package's masks from it, for the tests.  The dispatch,
the expert products (``torch.bmm``) and the combine are plain torch ops:
the JAX package runs them as XLA einsums, outside any Pallas kernel.

Expert parallelism: with ``cfg.ep_axis`` an axis of the ``mesh`` given,
``params["w1"]``/``["w2"]``/``["w3"]`` are this rank's slab ``[E/ep, ...]``
of the stacked experts, and the ``[E, C, D]`` buffer goes to the experts'
ranks by one all-to-all (split 0, concat 1: ``[E/ep, ep·C, D]``) and comes
back by another (split 1, concat 0), both :class:`~horovod_tpu_torch.
parallel.mesh.AllToAll` (their backward is the inverse exchange).  Tokens
are a data split over dp × ep.  The gradient rule for the slabs (never
averaged over ep, scaled by 1/ep) is ``parallel/expert.py``'s, fed by
:func:`param_specs`.

Router noise draws from a ``torch.Generator`` folded, as the JAX fold-ins
are, per data coordinate (dp, ep) and per layer (:func:`fold_in`): the
port's draws are not the JAX ones, so noise is held to its contract, not
to the JAX values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import AllToAll


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 128
    n_experts: int = 8
    capacity_factor: float = 1.25
    ep_axis: Optional[str] = "ep"      # None = all experts local
    router_noise: float = 0.0          # jitter std during training
    # "tokens": each token picks its top-k experts (Switch/GShard);
    # "expert_choice": each expert picks its top-C tokens (Zhou et al.
    # 2022), every expert exactly full, no aux loss.
    router_mode: str = "tokens"
    router_top_k: int = 1
    router_z_weight: float = 0.0       # ST-MoE z-loss weight (0 = off)
    gated: bool = False                # SwiGLU experts (Mixtral shape)
    dtype: torch.dtype = torch.float32

    def capacity(self, tokens_per_rank: int) -> int:
        """Per-(source-rank, expert) token slots: static by construction.
        Top-k routing makes k assignments per token, so the slot budget
        scales with k (GShard's capacity definition)."""
        return max(1, int(np.ceil(tokens_per_rank * self.router_top_k
                                  / self.n_experts
                                  * self.capacity_factor)))


def _randn(generator, shape, scale, dtype, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype).requires_grad_(True)


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Router ``[D, E]`` and the stacked experts ``w1 [E, D, F]``, ``w2
    [E, F, D]`` (and ``w3 [E, D, F]`` when gated), ``N(0, 1/fan_in)``, drawn
    from ``generator`` on ``device`` (the generator's by default), as
    leaves that require grad.  All ``E`` experts: cut a rank's slab with
    ``parallel.expert.shard_tree``."""
    device = torch.device(device) if device is not None else \
        generator.device
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    s1, s2 = 1.0 / np.sqrt(D), 1.0 / np.sqrt(F)
    p = {"router": _randn(generator, (D, E), s1, cfg.dtype, device),
         "w1": _randn(generator, (E, D, F), s1, cfg.dtype, device),
         "w2": _randn(generator, (E, F, D), s2, cfg.dtype, device)}
    if cfg.gated:
        p["w3"] = _randn(generator, (E, D, F), s1, cfg.dtype, device)
    return p


def param_specs(cfg: MoEConfig) -> Dict:
    """The axis each leaf is split over along dim 0 (the expert slabs:
    ``cfg.ep_axis``), or None (the router, replicated)."""
    ep = cfg.ep_axis
    specs = {"router": None, "w1": ep, "w2": ep}
    if cfg.gated:
        specs["w3"] = ep
    return specs


def fold_in(generator: Optional[torch.Generator], data: int
            ) -> Optional[torch.Generator]:
    """A new generator on ``generator``'s device, seeded by a mix of its
    ``initial_seed()`` and ``data`` (``jax.random.fold_in``'s role: one
    independent stream per data coordinate or layer).  It reads the seed,
    not the state: a caller wanting fresh noise each step passes a
    generator seeded for that step, as a JAX caller passes a new key."""
    if generator is None:
        return None
    z = (generator.initial_seed() * 0x9E3779B97F4A7C15
         + (int(data) + 1) * 0xBF58476D1CE4E5B9) % (1 << 64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    z ^= z >> 31
    return torch.Generator(device=generator.device).manual_seed(z)


class Routing(NamedTuple):
    """A routing decision.  Token choice: ``expert``, ``slot``, ``keep``
    and ``gate`` are ``[K, S]`` (choice k of token s goes to expert
    ``expert[k, s]``, slot ``slot[k, s]``, kept when ``keep[k, s]``, with
    weight ``gate[k, s]``).  Expert choice: ``expert`` is None and
    ``slot`` ``[E, C]`` holds the token each expert slot takes, ``gate``
    its weight."""
    mode: str
    capacity: int
    expert: Optional[torch.Tensor]
    slot: torch.Tensor
    keep: Optional[torch.Tensor]
    gate: torch.Tensor
    aux: torch.Tensor
    z_loss: torch.Tensor


def _route(x, router_w, cfg: MoEConfig,
           generator: Optional[torch.Generator] = None) -> Routing:
    """Top-k routing with static capacity (Switch for k=1, GShard for
    k>=2), or expert choice; the JAX ``_route`` as indices.

    A token's position in its expert's buffer is the count of that
    expert's earlier picks: the tokens before it in this choice, after
    every token of the earlier choices (choice priority: a token's second
    expert never evicts another token's first)."""
    S = x.shape[0]
    E = cfg.n_experts
    K = cfg.router_top_k
    if cfg.router_mode not in ("tokens", "expert_choice"):
        raise ValueError(f"router_mode must be 'tokens' or "
                         f"'expert_choice', got {cfg.router_mode!r}")
    if cfg.router_mode == "expert_choice" and K != 1:
        raise ValueError("expert_choice routing fixes per-expert fan-in "
                         "via capacity; router_top_k must stay 1")
    if not 1 <= K <= E:
        raise ValueError(f"router_top_k={K} must be in [1, {E}]")
    C = cfg.capacity(S)
    logits = x.float() @ router_w.float()                 # [S, E]
    if cfg.router_noise > 0.0:
        if generator is None:
            raise ValueError(
                "MoEConfig.router_noise > 0 requires threading generator= "
                "through moe_ffn / lm_loss / llama loss_fn")
        logits = logits + cfg.router_noise * torch.randn(
            logits.shape, generator=generator, dtype=torch.float32,
            device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()

    if cfg.router_mode == "expert_choice":
        if C > S:
            raise ValueError(f"expert_choice capacity {C} exceeds tokens "
                             f"{S}; lower capacity_factor")
        g, idx = torch.topk(probs.t(), C, dim=-1)         # [E, C]
        return Routing("expert_choice", C, None, idx, None, g,
                       torch.zeros((), device=x.device), z_loss)

    masked = probs
    counts = torch.zeros((E,), dtype=torch.long, device=x.device)
    experts, slots, keeps, gates = [], [], [], []
    for k in range(K):
        e = torch.argmax(masked, dim=-1)                  # [S]
        onehot = torch.nn.functional.one_hot(e, E)        # [S, E] long
        pos = (torch.cumsum(onehot, dim=0).gather(1, e[:, None])[:, 0]
               + counts[e] - 1)
        experts.append(e)
        slots.append(pos)
        keeps.append(pos < C)
        gates.append(probs.gather(1, e[:, None])[:, 0])   # raw prob
        if k == 0:
            first = onehot
        counts = counts + onehot.sum(dim=0)
        masked = masked * (1.0 - onehot.to(masked.dtype))
    if K > 1:
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]
    # Load balance (Switch/GShard): the share of tokens whose FIRST
    # choice is expert e against the router mass on e.
    token_frac = first.float().mean(dim=0)
    prob_frac = probs.mean(dim=0)
    aux = (token_frac * prob_frac).sum() * E
    return Routing("tokens", C, torch.stack(experts), torch.stack(slots),
                   torch.stack(keeps), torch.stack(gates), aux, z_loss)


def dense_masks(r: Routing, S: int, E: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``_route``'s ``(dispatch [S, E, C] one-hot, combine
    [S, E, C] gate-weighted)`` masks, float32, from a :class:`Routing`."""
    C = r.capacity
    dev = r.gate.device
    dispatch = torch.zeros((S, E, C), dtype=torch.float32, device=dev)
    combine = torch.zeros_like(dispatch)
    if r.mode == "expert_choice":
        e = torch.arange(E, device=dev)[:, None].expand(E, C)
        c = torch.arange(C, device=dev)[None, :].expand(E, C)
        dispatch[r.slot, e, c] = 1.0
        combine[r.slot, e, c] = r.gate.detach().float()
        return dispatch, combine
    s = torch.arange(S, device=dev)
    for k in range(r.expert.shape[0]):
        kept = r.keep[k]
        idx = (s[kept], r.expert[k][kept], r.slot[k][kept])
        dispatch[idx] = dispatch[idx] + 1.0
        combine[idx] = combine[idx] + r.gate[k].detach().float()[kept]
    return dispatch, combine


def _ep(cfg: MoEConfig, mesh) -> int:
    if mesh is None or cfg.ep_axis is None \
            or cfg.ep_axis not in mesh.axis_names:
        return 1
    return mesh.size(cfg.ep_axis)


def _experts(buf, params, cfg: MoEConfig):
    """``[e, c, D]`` rows through their experts' FFNs (``bmm`` a
    product, as the JAX einsums ``ecd,edf->ecf``)."""
    h = torch.nn.functional.silu(torch.bmm(buf, params["w1"]))
    if cfg.gated:
        h = h * torch.bmm(buf, params["w3"])
    return torch.bmm(h, params["w2"])


def moe_ffn(x, params, cfg: MoEConfig, mesh=None,
            generator: Optional[torch.Generator] = None):
    """The MoE FFN on this rank's tokens ``x [S, D]``: ``(y [S, D],
    aux_loss, z_loss)``.  Dropped tokens yield zeros (callers add the
    residual).  With ``cfg.ep_axis`` in ``mesh`` (size above 1) the expert
    leaves are this rank's slab and the buffer travels by two
    all-to-alls; otherwise every expert is local.  ``generator`` is
    required iff ``cfg.router_noise > 0``.

    ``moe_ffn.routed`` and ``moe_ffn.dropped`` count token choices routed
    and dropped for capacity (token choice only; ``dropped`` stays on
    ``x``'s device until read: ``int(moe_ffn.dropped)``); reset them to 0
    to start a count."""
    S, D = x.shape
    E = cfg.n_experts
    ep = _ep(cfg, mesh)
    if E % ep:
        raise ValueError(f"n_experts={E} must divide by ep={ep}")
    if params["w1"].shape[0] != E // ep:
        raise ValueError(
            f"expert slab of {params['w1'].shape[0]} experts on a mesh "
            f"with ep={ep} of {E} experts (cut it with shard_tree)")
    r = _route(x, params["router"], cfg, generator)
    C = r.capacity
    if r.mode == "expert_choice":
        buf = x.index_select(0, r.slot.reshape(-1))
    else:
        kept = r.keep.reshape(-1)
        rows = (r.expert * C + r.slot).reshape(-1)[kept]
        tokens = torch.arange(S, device=x.device).repeat(
            r.expert.shape[0])[kept]
        buf = x.new_zeros((E * C, D)).index_copy(
            0, rows, x.index_select(0, tokens))
        moe_ffn.routed += kept.numel()
        moe_ffn.dropped = moe_ffn.dropped + (kept.numel() - kept.sum())
    buf = buf.view(E, C, D)
    if ep > 1:
        # Each expert's rows to its rank: [E, C, D] -> [E/ep, ep*C, D].
        buf = AllToAll.apply(buf, mesh, cfg.ep_axis, 0, 1)
    out = _experts(buf, params, cfg)
    if ep > 1:
        # The return trip: chunk j of the capacity axis back to rank j.
        out = AllToAll.apply(out, mesh, cfg.ep_axis, 1, 0)
    out = out.reshape(E * C, D)
    # The combine: gates rounded to x's dtype, as the JAX einsum takes
    # them, summed in at least float32.
    acc = torch.promote_types(x.dtype, torch.float32)
    if r.mode == "expert_choice":
        w = r.gate.reshape(-1).to(x.dtype).to(acc)[:, None]
        y = torch.zeros((S, D), dtype=acc, device=x.device).index_add(
            0, r.slot.reshape(-1), w * out.to(acc))
    else:
        flat = torch.where(r.keep, r.expert * C + r.slot,
                           torch.zeros_like(r.slot))
        w = (r.gate * r.keep).to(x.dtype).to(acc)
        y = sum(w[k][:, None] * out.index_select(0, flat[k]).to(acc)
                for k in range(flat.shape[0]))
    return y.to(x.dtype), r.aux, r.z_loss


moe_ffn.routed = 0
moe_ffn.dropped = 0


# ----------------------------------------------------------- tiny LM model
@dataclasses.dataclass(frozen=True)
class MoELMConfig:
    """Minimal MoE language model (embed → N × [MoE FFN] → head): the
    test vehicle for expert parallelism."""
    vocab_size: int = 256
    d_model: int = 64
    n_layers: int = 2
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    aux_weight: float = 0.01
    dp_axis: Optional[str] = "dp"


def lm_init(cfg: MoELMConfig, generator: torch.Generator,
            device=None) -> Dict:
    device = torch.device(device) if device is not None else \
        generator.device
    D = cfg.d_model
    dt = cfg.moe.dtype
    embed = _randn(generator, (cfg.vocab_size, D), 1.0 / np.sqrt(D), dt,
                   device)
    layers = [init_params(cfg.moe, generator, device)
              for _ in range(cfg.n_layers)]
    head = _randn(generator, (D, cfg.vocab_size), 1.0 / np.sqrt(D), dt,
                  device)
    return {"embed": embed, "layers": layers, "head": head}


def lm_param_specs(cfg: MoELMConfig) -> Dict:
    return {"embed": None, "head": None,
            "layers": [param_specs(cfg.moe) for _ in range(cfg.n_layers)]}


def data_generator(generator, mesh, axes):
    """``generator`` folded with this rank's coordinate along each of
    ``axes`` that ``mesh`` has (the JAX ``fold_in(rng, axis_index(ax))``
    per data axis): every data shard draws its own noise."""
    if generator is None or mesh is None:
        return generator
    for ax in axes:
        if ax and ax in mesh.axis_names:
            generator = fold_in(generator, mesh.index(ax))
    return generator


def lm_loss(params, tokens, targets, cfg: MoELMConfig, mesh=None,
            generator: Optional[torch.Generator] = None):
    """This rank's mean next-token loss over its own tokens plus the
    router losses (``aux_weight`` × the summed load-balance losses,
    ``router_z_weight`` × the summed z-losses).  The JAX ``lm_loss`` is
    this scaled by 1/(dp × ep), for its gradient sums; here
    ``DistributedOptimizer`` averages the replicated leaves, and
    ``parallel.ExpertParallel`` scales the slabs (module docstring of
    ``parallel/expert.py``).  ``generator`` threads router jitter, folded
    per data coordinate and per layer."""
    B, T = tokens.shape
    x = params["embed"][tokens.long()].reshape(B * T, -1)
    generator = data_generator(generator, mesh,
                               (cfg.dp_axis, cfg.moe.ep_axis))
    aux_total = torch.zeros((), device=x.device)
    z_total = torch.zeros((), device=x.device)
    for i, lp in enumerate(params["layers"]):
        y, aux, zl = moe_ffn(x, lp, cfg.moe, mesh, fold_in(generator, i))
        x = x + y
        aux_total = aux_total + aux
        z_total = z_total + zl
    logits = (x @ params["head"]).float()
    nll = torch.nn.functional.cross_entropy(logits,
                                            targets.reshape(-1).long())
    return nll + cfg.aux_weight * aux_total \
        + cfg.moe.router_z_weight * z_total


def psum_loss(loss, mesh=None):
    """The global mean loss for logging: the world's mean of every rank's
    loss through the engine (the JAX ``psum`` of the partial losses)."""
    from .. import mpi_ops
    loss = loss.detach()
    if mesh is None or all(n == 1 for n in mesh.shape.values()):
        return loss
    return mpi_ops.allreduce(loss, op=mpi_ops.Average, name="moe.loss")


def make_train_step(cfg: MoELMConfig, optimizer, mesh=None, experts=None):
    """``step(params, tokens, targets, generator=None) -> loss``: zero the
    grads, :func:`lm_loss`, backward, then ``optimizer.step()`` (the
    replicated leaves, a ``DistributedOptimizer``) and ``experts.step()``
    (a ``parallel.ExpertParallel`` over the slabs: the 1/ep rule, then
    their optimizer).  The loss is this rank's, before the update."""

    def step(params, tokens, targets, generator=None):
        optimizer.zero_grad()
        if experts is not None:
            experts.zero_grad()
        loss = lm_loss(params, tokens, targets, cfg, mesh, generator)
        loss.backward()
        optimizer.step()
        if experts is not None:
            experts.step()
        return loss.detach()

    return step
