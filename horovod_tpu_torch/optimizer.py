# Ported from horovod_tpu/torch/optimizer.py:1-266 (without its branch for
# a torch that lacks post-accumulate-grad hooks, which the port does not
# support); the ZeRO-sharded optimizer from horovod_tpu/jax/optimizer.py:
# _ShardPlan 136-148, the states' byte counts and saveables 151-246 and
# 307-379, _make_shard_plan 382-420, the eager sharded init/update
# 451-645, gather_params 248-305 and DistributedOptimizer's sharded=
# 787-812.
"""``hvd.DistributedOptimizer`` for PyTorch.

Port of ``horovod_tpu/torch/optimizer.py:29-266`` (reference:
``horovod/torch/optimizer.py`` ``_DistributedOptimizer``): per-parameter
gradient hooks fire async allreduces during ``backward()``; ``step()``
calls ``synchronize()`` to wait for and apply the averaged gradients, then
runs the wrapped optimizer.  Supports ``backward_passes_per_step`` local
aggregation, compression, ``Sum`` / ``Average`` ops, pre/post-scale
factors, process sets, and ``skip_synchronize()``.  In a world of one
process no hook is registered and ``synchronize()`` returns at once.

The allreduces go through ``mpi_ops`` and the collective engine: each
gradient is submitted under its parameter's name (``allreduce.<name>``)
with its reverse-registration priority, negotiated across ranks by name,
and fused with the others of its cycle.  ``op=Adasum`` combines the
ranks' gradients by adaptive summation (``parallel/adasum.py``, over each
fused dtype buffer, as the JAX engine does): a raw Adasum with no divisor,
and ``gradient_predivide_factor`` is refused with it.  ``check=`` lints
the calling script at wrap time (``analysis/hooks.py``, as the JAX
package's torch binding does, ``horovod_tpu/torch/optimizer.py:254-255``).

``sharded=True`` (ZeRO-1) and ``sharded="full"`` (ZeRO-3/FSDP) take the
JAX package's eager ZeRO path (``horovod_tpu/jax/optimizer.py``): no hook;
``step()`` reduce-scatters the gradients bucket by bucket through the
engine, runs the user's optimizer class on this rank's 1/N flat shards,
and allgathers the updated shards (ZeRO-1), or keeps only the shards
between steps and rematerializes the parameters with ``gather_params()``
through prefetch allgathers (FSDP).
"""

from __future__ import annotations

import inspect
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import mpi_ops
from .common import basics
from .common.process_sets import ProcessSet, global_process_set
from .compression import Compression
from .ops import collectives as C
from .ops import eager
from .parallel.zero import shard_info


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step=1,
                 op=mpi_ops.Average,
                 gradient_predivide_factor=1.0,
                 process_set: Optional[ProcessSet] = None):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.op = op
        self.gradient_predivide_factor = gradient_predivide_factor
        self.process_set = process_set
        self.backward_passes_per_step = backward_passes_per_step

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [(f"allreduce.noname.{i}.{j}", v)
                                for i, group in enumerate(self.param_groups)
                                for j, v in enumerate(group["params"])]
        if len(named_parameters) > 0 and not isinstance(
                named_parameters[0][1], torch.Tensor):
            raise ValueError("named_parameters should be a sequence of "
                             "(name, torch.Tensor) pairs")
        all_params = {p for group in self.param_groups
                      for p in group["params"]}
        named = {p for _, p in named_parameters}
        unnamed = all_params - named
        if unnamed:
            raise ValueError(
                f"named_parameters was specified but {len(unnamed)} "
                f"optimizer parameters were not named")
        dups = _find_duplicates([k for k, _ in named_parameters])
        if dups:
            raise ValueError(f"Parameter names are not unique: {dups}")

        self._parameter_names = {v: k for k, v in named_parameters}
        # Reverse-registration drain priority: the first-registered
        # parameter (first layer touched by the next forward pass) gets the
        # highest priority, so its gradient — produced LAST by backprop —
        # still leads the next coordinator cycle (ByteScheduler-style
        # scheduling).  Registration order matches across ranks, so the
        # stamps agree.
        self._priorities = {p: len(named_parameters) - i
                            for i, (_, p) in enumerate(named_parameters)}
        self._handles = {}
        self._requires_update = set()
        self._synchronized = False
        self._should_synchronize = True
        self._allreduce_delay = {}

        # In an elastic job the hooks are registered at any size (the
        # reference's rule): a world of one may grow, and the optimizer
        # outlives the generation that made it.
        if basics.size() > 1 or _elastic():
            self._register_hooks()

    def _reset_handles(self):
        """Forget the gradient handles of a dead generation (an elastic
        reset): their engine is gone, and the next step starts afresh."""
        self._handles.clear()
        for p in self._allreduce_delay:
            self._allreduce_delay[p] = self.backward_passes_per_step
        self._synchronized = False

    # ----------------------------------------------------------- hooks
    def _register_hooks(self):
        for param_group in self.param_groups:
            for p in param_group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._allreduce_delay[p] = self.backward_passes_per_step
                    p.register_post_accumulate_grad_hook(
                        self._make_post_hook(p))

    def _make_post_hook(self, p):
        # Each parameter holds its hook: a hook that held the optimizer
        # (or the parameter) would be a cycle through the tensor's hook
        # dict, which the cycle collector does not see, and would keep the
        # optimizer, its state and its parameters alive for ever.
        ref = weakref.ref(self)

        def hook(param):
            opt = ref()
            if opt is not None:
                opt._hook_body(param)
        return hook

    def _hook_body(self, p):
        if p in self._handles and self._handles[p][0] is not None:
            if self._allreduce_delay[p] <= 0:
                raise AssertionError(
                    "Gradients were computed more than "
                    "backward_passes_per_step times before call to step(). "
                    "Increase backward_passes_per_step to accumulate "
                    "gradients locally.")
        assert not p.grad.requires_grad
        assert self._allreduce_delay[p] > 0
        handle, ctx = None, None
        self._allreduce_delay[p] -= 1
        if self._allreduce_delay[p] == 0:
            handle, ctx = self._allreduce_grad_async(p)
        self._handles[p] = (handle, ctx)

    def _allreduce_grad_async(self, p):
        name = self._parameter_names.get(p)
        tensor = p.grad
        # Average semantics with local aggregation: divide by the number of
        # locally accumulated passes so the wire value is the per-pass mean.
        prescale = None
        postscale = None
        if self.op == mpi_ops.Average:
            if self.gradient_predivide_factor != 1.0:
                prescale = 1.0 / self.gradient_predivide_factor
                postscale = self.gradient_predivide_factor / basics.size()
                wire_op = mpi_ops.Sum
            else:
                wire_op = mpi_ops.Average
            # Average semantics only: locally accumulated N passes are
            # divided back to the per-pass mean; Sum/Adasum keep the raw sum.
            if self.backward_passes_per_step > 1:
                prescale = (prescale or 1.0) / self.backward_passes_per_step
        else:
            wire_op = self.op
        # Cast-style compressors (wire_mode attr) ride mpi_ops' wire cast:
        # the result comes back in the gradient's dtype (ctx None →
        # decompress is the identity).  Custom compressors keep the
        # explicit compress/decompress hooks.
        prio = self._priorities.get(p, 0)
        wire = getattr(self._compression, "wire_mode", None)
        if wire is not None:
            handle = mpi_ops.allreduce_async(
                tensor, name=f"allreduce.{name}", op=wire_op,
                prescale_factor=prescale, postscale_factor=postscale,
                process_set=self.process_set, compression=wire,
                priority=prio)
            return handle, None
        tensor_compressed, ctx = self._compression.compress(tensor)
        handle = mpi_ops.allreduce_async(
            tensor_compressed, name=f"allreduce.{name}", op=wire_op,
            prescale_factor=prescale, postscale_factor=postscale,
            process_set=self.process_set, priority=prio)
        return handle, ctx

    # ----------------------------------------------------------- step
    def synchronize(self):
        """Wait for all outstanding gradient allreduces and write the
        averaged gradients back (reference: ``synchronize()``)."""
        if not self._requires_update:
            # No hook registered: a world of one outside an elastic job.
            self._synchronized = True
            return
        # Params whose hook never fired this step (e.g. unused branch):
        # submit now so all ranks stay consistent, in parameter order.
        for p in (p for group in self.param_groups for p in group["params"]
                  if p in self._requires_update):
            if p not in self._handles:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                handle, ctx = self._allreduce_grad_async(p)
                self._handles[p] = (handle, ctx)
        for p, (handle, ctx) in list(self._handles.items()):
            if handle is None:
                handle, ctx = self._allreduce_grad_async(p)
                self._handles[p] = (handle, ctx)
        for p, (handle, ctx) in self._handles.items():
            output = mpi_ops.synchronize(handle)
            self._allreduce_delay[p] = self.backward_passes_per_step
            p.grad.data.copy_(
                self._compression.decompress(output, ctx).reshape(p.grad.shape))
        self._handles.clear()
        self._synchronized = True

    @contextmanager
    def skip_synchronize(self):
        """With this context, ``step()`` will not re-synchronize — used when
        the user called ``synchronize()`` manually (e.g. before gradient
        clipping), matching the reference's API."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                import warnings
                warnings.warn(
                    "optimizer.step() called without a prior backward pass "
                    "re-synchronizing; call optimizer.skip_synchronize() "
                    "around step() if you synchronized manually")
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize(). This is "
                "prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


# --------------------------------------------------------------------------
# The ZeRO-sharded optimizer: DistributedOptimizer(sharded=True / "full")
# --------------------------------------------------------------------------

class _ShardPlan(NamedTuple):
    """Static sharding plan, fixed at construction: a pure function of
    the leaves' shapes and dtypes, the world, the bucket size and the
    param groups, so every rank derives the same buckets (their members
    name the wire entries, which negotiation checks for consistency)."""
    world: int
    rank: int
    shapes: Tuple[Tuple[int, ...], ...]     # logical per-leaf shapes
    dtypes: Tuple[str, ...]
    sizes: Tuple[int, ...]                  # logical element counts
    pads: Tuple[int, ...]                   # pad+slice convention pads
    pers: Tuple[int, ...]                   # shard length per leaf
    buckets: Tuple[Tuple[int, ...], ...]    # leaf indices per bucket


def _dtype_name(dt: torch.dtype) -> str:
    """The dtype's name as numpy and JAX spell it (``bfloat16``)."""
    return str(dt).replace("torch.", "")


def _make_shard_plan(leaves, world: int, rank: int, chunk_bytes: int,
                     groups: Optional[Sequence[int]] = None) -> _ShardPlan:
    """The JAX plan (``horovod_tpu/jax/optimizer.py:382-420``): greedy
    packing in registration order up to ``chunk_bytes`` of padded payload
    a bucket (``HOROVOD_PIPELINE_CHUNK``; 0 = one bucket).  ``groups[i]``,
    leaf i's param group, also ends a bucket where it changes, so that a
    bucket's leaves share their hyperparameters; one group gives exactly
    the JAX plan."""
    shapes, dtypes, sizes, pads, pers, isizes = [], [], [], [], [], []
    for t in leaves:
        shape = tuple(t.shape)
        n = 1
        for d in shape:
            n *= int(d)
        pad, per = shard_info(n, world)
        shapes.append(shape)
        dtypes.append(_dtype_name(t.dtype))
        isizes.append(t.element_size())
        sizes.append(n)
        pads.append(pad)
        pers.append(per)
    if groups is None:
        groups = [0] * len(leaves)
    buckets: List[Tuple[int, ...]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in range(len(leaves)):
        b = (sizes[i] + pads[i]) * isizes[i]
        if cur and (groups[i] != groups[cur[-1]] or (
                chunk_bytes and chunk_bytes > 0
                and cur_bytes + b > chunk_bytes)):
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
    if cur:
        buckets.append(tuple(cur))
    return _ShardPlan(world=world, rank=rank, shapes=tuple(shapes),
                      dtypes=tuple(dtypes), sizes=tuple(sizes),
                      pads=tuple(pads), pers=tuple(pers),
                      buckets=tuple(buckets))


def _ctor_kwargs(cls, defaults: Dict[str, Any]) -> Dict[str, Any]:
    """The user's defaults that ``cls``'s constructor takes (AdamW's
    defaults carry ``decoupled_weight_decay``, which it does not)."""
    sig = inspect.signature(cls.__init__).parameters
    if any(p.kind == p.VAR_KEYWORD for p in sig.values()):
        return dict(defaults)
    return {k: v for k, v in defaults.items() if k in sig}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _state_tensors(sd: Dict) -> List[Tuple[Any, str]]:
    """``(param index, key)`` of a state dict's tensors of at least one
    dimension and one element, in a rank-invariant order."""
    return [(idx, k) for idx in sorted(sd["state"])
            for k in sorted(sd["state"][idx])
            if isinstance(sd["state"][idx][k], torch.Tensor)
            and sd["state"][idx][k].dim() >= 1
            and sd["state"][idx][k].numel() > 0]


def _copy_state_dict(sd: Dict) -> Dict:
    """A state dict whose tensors are copies on the CPU."""
    def conv(v):
        return v.detach().to("cpu", copy=True) \
            if isinstance(v, torch.Tensor) else v
    return {"state": {idx: {k: conv(v) for k, v in st.items()}
                      for idx, st in sd["state"].items()},
            "param_groups": [dict(g) for g in sd["param_groups"]]}


class _ShardedDistributedOptimizer(torch.optim.Optimizer):
    """The eager ZeRO optimizer: see :func:`DistributedOptimizer`'s
    ``sharded=``.  Built, as the replicated one, as a subclass of the
    wrapped optimizer's class over its ``param_groups`` (so LR schedulers
    drive it); the update itself runs in one inner optimizer of that class
    a bucket, over this rank's 1/N flat shards."""

    def __init__(self, params, user_cls, user_defaults, op, process_set,
                 sharded):
        super(self.__class__, self).__init__(params)
        self.sharded = sharded
        self._label = 'sharded="full"' if sharded == "full" \
            else "sharded=True"
        self.op = op
        self.process_set = process_set
        ps = process_set if process_set is not None else global_process_set
        me = basics.rank()
        if not ps.included(me):
            raise ValueError(f"DistributedOptimizer({self._label}): rank "
                             f"{me} is not in the process set {ps.ranks}")
        world, rank = ps.size(), ps.rank_in_set(me)
        self._params: List[torch.Tensor] = []
        self._groups: List[int] = []
        for g, group in enumerate(self.param_groups):
            for p in group["params"]:
                if p.requires_grad:
                    self._params.append(p)
                    self._groups.append(g)
        self._plan = plan = _make_shard_plan(
            self._params, world, rank, _chunk_bytes(), self._groups)
        self._shards = [torch.zeros(plan.pers[i], dtype=p.dtype,
                                    device=p.device)
                        for i, p in enumerate(self._params)]
        self._slice_params()
        kwargs = _ctor_kwargs(user_cls, user_defaults)
        self._bucket_group = [self._groups[idxs[0]] for idxs in plan.buckets]
        self._inner = [user_cls([dict(
            self._hyper(self._bucket_group[b]),
            params=[self._shards[i] for i in idxs])], **kwargs)
            for b, idxs in enumerate(plan.buckets)]
        # FSDP: whether the full parameters are in memory.  They are until
        # the first step frees them; gather_params() before that adopts
        # them (a broadcast after construction lands in the shards).
        self._resident = True

    # ------------------------------------------------------------ shards
    def _hyper(self, g: int) -> Dict[str, Any]:
        return {k: v for k, v in self.param_groups[g].items()
                if k != "params"}

    def _slice_params(self):
        """Each shard from its parameter's resident data (the pad+slice
        convention; the padding zeros)."""
        plan = self._plan
        for i, p in enumerate(self._params):
            shard, per, n = self._shards[i], plan.pers[i], plan.sizes[i]
            lo = plan.rank * per
            hi = min(lo + per, n)
            with torch.no_grad():
                if hi > lo:
                    shard[:hi - lo].copy_(p.detach().reshape(-1)[lo:hi])
                shard[max(hi - lo, 0):].zero_()

    def _padded_grad(self, i: int) -> torch.Tensor:
        """Leaf i's gradient, flat and padded (zeros where it has none)."""
        plan, p = self._plan, self._params[i]
        g = p.grad
        if g is None:
            return torch.zeros(plan.sizes[i] + plan.pads[i], dtype=p.dtype,
                               device=p.device)
        if tuple(g.shape) != plan.shapes[i]:
            raise ValueError(
                f"gradient shapes changed since DistributedOptimizer"
                f"({self._label}) was built: leaf {i} is "
                f"{tuple(g.shape)}, the plan's {plan.shapes[i]}; build a "
                f"new optimizer for the new parameters")
        flat = g.detach().reshape(-1)
        if plan.pads[i]:
            flat = torch.cat([flat, flat.new_zeros(plan.pads[i])])
        return flat

    def _free_params(self):
        """FSDP between steps: no full parameter and no full gradient."""
        for i, p in enumerate(self._params):
            p.grad = None
            if self._plan.sizes[i]:
                p.data = p.data.new_empty(0)
        self._resident = False

    # -------------------------------------------------------------- step
    def step(self, closure=None):
        """``horovod_tpu/jax/optimizer.py:491-556`` (ZeRO-1) and
        ``:580-645`` (FSDP): every bucket's reduce-scatter goes out before
        any update runs (reverse-registration priorities); then, bucket by
        bucket, the gradient shard becomes the inner shard's ``.grad``,
        the outer group's hyperparameters are copied in (LR schedulers
        keep working) and the inner step runs; ZeRO-1 then allgathers the
        bucket's updated shards and finally writes the full parameters in
        place (``p.data.copy_``: each Parameter keeps its identity), FSDP
        frees the full parameters and gradients instead."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        plan = self._plan
        full = self.sharded == "full"
        nl = len(plan.shapes)
        if not full:
            self._slice_params()
        tag = "fsdp" if full else "sharded"
        rs: List[Dict[int, int]] = []
        for b, idxs in enumerate(plan.buckets):
            live = [i for i in idxs if plan.pers[i] > 0]
            hs = eager.grouped_reducescatter_async(
                [self._padded_grad(i) for i in live], name=f"{tag}_rs.b{b}",
                op=self.op, process_set=self.process_set,
                priorities=[nl - i for i in live],
                sharded=self.sharded) if live else []
            rs.append(dict(zip(live, hs)))
        ag: List[Dict[int, int]] = []
        for b, idxs in enumerate(plan.buckets):
            for i in idxs:
                shard = self._shards[i]
                shard.grad = eager.synchronize(rs[b][i]) \
                    if plan.pers[i] > 0 else torch.zeros_like(shard)
            inner = self._inner[b]
            inner.param_groups[0].update(self._hyper(self._bucket_group[b]))
            inner.step()
            for i in idxs:
                self._shards[i].grad = None
            if full:
                continue
            live = [i for i in idxs if plan.pers[i] > 0]
            hs = eager.grouped_allgather_async(
                [self._shards[i] for i in live], name=f"sharded_ag.b{b}",
                process_set=self.process_set,
                priorities=[nl - i for i in live],
                sharded=True) if live else []
            ag.append(dict(zip(live, hs)))
        if full:
            self._free_params()
            return loss
        with torch.no_grad():
            for handles in ag:
                for i, h in handles.items():
                    out = eager.synchronize(h)
                    self._params[i].data.copy_(
                        out[:plan.sizes[i]].view(plan.shapes[i]))
        return loss

    def gather_params(self, depth: Optional[int] = None):
        """FSDP: rematerialize the full parameters, in place in the
        module's Parameters, through the prefetch pipeline
        (``horovod_tpu/jax/optimizer.py:248-305``).  Buckets
        ``0..depth-1`` dispatch their allgathers up front; then, for each
        bucket k in order, bucket ``k+depth``'s gather is dispatched
        before bucket k is synchronized, so the dispatch order is the same
        on every rank.  Each gather is marked ``prefetch=True`` (the
        engine's prefetch lane) and ``sharded="full"``; a dispatch while
        an earlier bucket's gather is outstanding counts in the engine's
        ``prefetch_overlapped``.  ``depth`` defaults to
        ``HOROVOD_PREFETCH_DEPTH`` (2).  Where the parameters are still in
        memory (before the first step) the shards are sliced from them
        instead, and nothing is gathered.  Returns the parameters."""
        if self.sharded != "full":
            raise RuntimeError(
                f"gather_params() belongs to DistributedOptimizer("
                f'sharded="full"), not {self._label}: its parameters stay '
                f"in memory")
        if self._resident:
            self._slice_params()
            return list(self._params)
        plan = self._plan
        nb, nl = len(plan.buckets), len(plan.shapes)
        depth = max(1, int(_prefetch_depth() if depth is None else depth))
        eng = eager._engine()
        handles: List[Optional[Dict[int, int]]] = [None] * nb

        def dispatch(b: int):
            live = [i for i in plan.buckets[b] if plan.pers[i] > 0]
            hs = eager.grouped_allgather_async(
                [self._shards[i] for i in live], name=f"fsdp_prefetch.b{b}",
                process_set=self.process_set,
                priorities=[nl - i for i in live], sharded="full",
                prefetch=True) if live else []
            handles[b] = dict(zip(live, hs))
            if b > 0:
                # Dispatched while an earlier bucket's gather is still
                # outstanding: the overlap, counted deterministically.
                eng.prefetch_overlapped += 1

        for b in range(min(depth, nb)):
            dispatch(b)
        for b in range(nb):
            if b + depth < nb:
                dispatch(b + depth)          # before bucket b synchronizes
            for i, h in handles[b].items():
                out = eager.synchronize(h)
                self._params[i].data = out[:plan.sizes[i]].view(
                    plan.shapes[i])
        self._resident = True
        return list(self._params)

    # ------------------------------------------------------------- bytes
    def opt_state_bytes(self) -> int:
        """Bytes of optimizer state held on this rank: the inner
        optimizers' state over the shards (≈ 1/world of the replicated
        state, plus the padding and the per-leaf step counts)."""
        return sum(_nbytes(v) for o in self._inner for st in o.state.values()
                   for v in st.values() if isinstance(v, torch.Tensor))

    def params_bytes(self) -> int:
        """Bytes of parameters on this rank: the shards, and the full
        parameters while they are in memory (always for ZeRO-1; for FSDP
        between ``gather_params()`` and ``step()``)."""
        return sum(_nbytes(s) for s in self._shards) + \
            sum(_nbytes(p) for p in self._params)

    def resident_bytes(self) -> int:
        """Parameters and optimizer state on this rank: ≈ 1/world of the
        replicated bytes for FSDP between steps."""
        return self.params_bytes() + self.opt_state_bytes()

    # ------------------------------------------------------------- state
    def state_dict(self):
        """The shards' state, not the replicated state: this rank's inner
        optimizer's ``state_dict()`` a bucket, with the plan's world and
        rank.  :meth:`hvd_sharded_saveable` gives the rank-invariant
        form."""
        return {"sharded": self.sharded, "world": self._plan.world,
                "rank": self._plan.rank,
                "buckets": [o.state_dict() for o in self._inner]}

    def load_state_dict(self, state_dict):
        """Loads what :meth:`state_dict` gave on the same rank and world."""
        if (state_dict.get("world"), state_dict.get("rank"),
                len(state_dict.get("buckets", ()))) != (
                self._plan.world, self._plan.rank, len(self._inner)):
            raise ValueError(
                f"a {self._label} state_dict loads only on the rank and "
                f"world it came from; use hvd_sharded_saveable() and "
                f"load_sharded_saveable() across worlds and ranks")
        for o, sd in zip(self._inner, state_dict["buckets"]):
            o.load_state_dict(sd)

    def hvd_sharded_saveable(self, process_set: Optional[ProcessSet] = None):
        """Rank-invariant host representation
        (``horovod_tpu/jax/optimizer.py:178-214, 307-333``): every state
        tensor of at least one dimension is allgathered to its full padded
        flat form, so all ranks hold the same dict, and a rank re-slices
        its own 1/N with :func:`load_sharded_saveable`.  FSDP adds the
        gathered parameter shards under ``__hvd_full_sharded__``.  The
        tensors are on the CPU.  ``process_set=None`` gathers over the
        optimizer's set."""
        plan = self._plan
        if process_set is None:
            process_set = self.process_set
        st = basics._get_state()
        if plan.world > 1 and not (st.initialized and st.engine is not None):
            raise RuntimeError(
                "cannot save a DistributedOptimizer(sharded=True) state "
                f"sharded over {plan.world} ranks without the live "
                "collective engine (commit before shutdown, not after)")
        gathered = []
        for b, o in enumerate(self._inner):
            sd = o.state_dict()
            slots = _state_tensors(sd)
            out = _copy_state_dict(sd)
            if slots and plan.world > 1:
                full = eager.grouped_allgather(
                    [sd["state"][i][k] for i, k in slots],
                    name=f"sharded_state_gather.b{b}",
                    process_set=process_set, sharded=True)
                for (i, k), f in zip(slots, full):
                    out["state"][i][k] = f.detach().to("cpu", copy=True)
            gathered.append(out)
        saved = {"__hvd_sharded_opt__": 1, "world": plan.world,
                 "plan": plan._replace(rank=-1)._asdict(),
                 "inner_states": gathered}
        if self.sharded != "full":
            return saved
        shards = []
        for b, idxs in enumerate(plan.buckets):
            live = [j for j, i in enumerate(idxs) if plan.pers[i] > 0]
            outs = [self._shards[i].detach().to("cpu", copy=True)
                    for i in idxs]
            if live and plan.world > 1:
                full = eager.grouped_allgather(
                    [self._shards[idxs[j]] for j in live],
                    name=f"fsdp_param_gather.b{b}", process_set=process_set,
                    sharded="full")
                for j, f in zip(live, full):
                    outs[j] = f.detach().to("cpu", copy=True)
            shards.append(outs)
        saved["__hvd_full_sharded__"] = 1
        saved["param_shards"] = shards
        return saved

    def load_sharded_saveable(self, saved) -> bool:
        """Load this rank's 1/N of a saveable that
        :meth:`hvd_sharded_saveable` made in a world of the same size over
        the same parameters; False (nothing loaded) for another world
        size, as :func:`load_sharded_saveable` returns None for it."""
        plan = self._plan
        got = load_sharded_saveable(saved, plan.rank, plan.world)
        if got is None:
            return False
        if got.plan != plan:
            raise ValueError(f"the saveable's plan {got.plan} is not this "
                             f"optimizer's {plan}")
        for o, sd in zip(self._inner, got.inner_states):
            o.load_state_dict(sd)
        if self.sharded == "full":
            if got.param_shards is None:
                raise ValueError('a DistributedOptimizer(sharded="full") '
                                 "loads only an FSDP saveable")
            with torch.no_grad():
                for idxs, shards in zip(plan.buckets, got.param_shards):
                    for i, s in zip(idxs, shards):
                        self._shards[i].copy_(s)
            self._free_params()
        return True


class ShardedState(NamedTuple):
    """This rank's part of a saveable (:func:`load_sharded_saveable`): the
    plan with this rank, one state dict a bucket over its shards, and the
    FSDP parameter shards a bucket (None for ZeRO-1)."""
    plan: _ShardPlan
    inner_states: List[Dict]
    param_shards: Optional[List[List[torch.Tensor]]]


def is_sharded_saveable(value) -> bool:
    """True for the marker dict ``hvd_sharded_saveable`` produces."""
    return isinstance(value, dict) and value.get("__hvd_sharded_opt__") == 1


def load_sharded_saveable(saved, rank: int, world: int):
    """This rank's :class:`ShardedState` from a recovered rank-invariant
    saveable (``horovod_tpu/jax/optimizer.py:346-379``): each gathered
    flat tensor ``[world*per]`` is re-sliced to the rank's own
    ``[rank*per, (rank+1)*per)``.  None when the saveable's world size
    differs (a resized world re-initializes its optimizer state)."""
    if not is_sharded_saveable(saved) or int(saved["world"]) != int(world) \
            or world < 1:
        return None
    plan = _ShardPlan(**dict(saved["plan"], rank=int(rank)))
    plan = plan._replace(**{k: tuple(tuple(x) if isinstance(x, list) else x
                                     for x in v)
                            for k, v in plan._asdict().items()
                            if isinstance(v, list)})

    def reslice(t):
        if not isinstance(t, torch.Tensor) or t.dim() < 1 \
                or t.numel() % world:
            return t
        per = t.numel() // world
        return t.reshape(-1)[rank * per:(rank + 1) * per].clone()

    inner = [{"state": {i: {k: reslice(v) for k, v in st.items()}
                        for i, st in sd["state"].items()},
              "param_groups": [dict(g) for g in sd["param_groups"]]}
             for sd in saved["inner_states"]]
    shards = None
    if saved.get("__hvd_full_sharded__") == 1:
        shards = [[reslice(s) for s in b] for b in saved["param_shards"]]
    return ShardedState(plan, inner, shards)


def _elastic() -> bool:
    """Whether this process is an elastic job's worker, as ``init()``
    read it."""
    cfg = basics._get_state().config
    return cfg is not None and cfg.elastic


def _chunk_bytes() -> int:
    """The sharded optimizer's bucket bytes: the engine's live chunk knob
    (``HOROVOD_PIPELINE_CHUNK`` at ``init()``, then wherever the
    autotuner moves it), as ``horovod_tpu/jax/optimizer.py:663-668``
    reads it; the config's value without an engine."""
    st = basics._get_state()
    if st.engine is not None:
        return int(st.engine.pipeline_chunk_bytes)
    return int(st.config.pipeline_chunk_bytes) if st.config is not None \
        else 0


def _prefetch_depth() -> int:
    """``HOROVOD_PREFETCH_DEPTH`` (default 2): buckets of gathered
    parameters in flight ahead of use."""
    cfg = basics._get_state().config
    if cfg is None:
        return 2
    return max(1, int(getattr(cfg, "prefetch_depth", 2) or 2))


def _find_duplicates(lst):
    seen, dups = set(), set()
    for x in lst:
        if x in seen:
            dups.add(x)
        seen.add(x)
    return dups


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1,
                         op=mpi_ops.Average,
                         gradient_predivide_factor=1.0,
                         process_set: Optional[ProcessSet] = None,
                         check=False, sharded=None):
    """Wrap a torch optimizer so ``step()`` applies globally averaged
    gradients (reference: ``hvd.DistributedOptimizer``).

    Built dynamically as a subclass of the wrapped optimizer's class (the
    reference's pattern), so ``isinstance(opt, torch.optim.SGD)`` holds.

    ``check=True`` lints the calling script for deadlock-prone collective
    patterns at wrap time (``check="strict"`` raises on errors) — see
    ``horovod_tpu_torch.analysis``.

    ``sharded=True`` (ZeRO-1; ``horovod_tpu/jax/optimizer.py:787-812``):
    optimizer state lives 1/world a rank.  No hook: ``step()``
    reduce-scatters each bucket's flat padded gradients through the engine
    (each rank receives its 1/N shard), runs the wrapped optimizer's class
    (its ``defaults``, ``foreach``/``fused`` included) on this rank's
    shards, and allgathers the updated shards into the parameters in
    place.  Buckets hold ``HOROVOD_PIPELINE_CHUNK`` bytes (0: one a param
    group).  Unlike the JAX path, which gathers optax *updates*, the port
    gathers the updated *parameter shards*: the same wire bytes, and the
    only way to parameters bitwise equal to the replicated in-place
    ``step()``, because ``p + (p' - p)`` is not ``p'``.  After K steps the
    parameters are bitwise those of ``sharded=False`` at two ranks, for an
    elementwise optimizer (SGD, Adam, AdamW, ...): one addition an element
    in either path, divided in the same dtype (on the CPU, torch's bf16
    ``add_(alpha=)`` rounds the elements of its scalar tail loop otherwise
    than its vector loop, so SGD on a bf16 leaf can differ there by an
    ulp).  At more ranks NCCL's allreduce and reduce-scatter may add in
    different orders.

    ``sharded="full"`` (ZeRO-3/FSDP): the parameters too live 1/world a
    rank between steps.  ``step()`` reduce-scatters the gradients into the
    shards, steps them, and frees the full parameters and gradients (each
    Parameter then holds an empty tensor); ``opt.gather_params()``
    rematerializes them before the next forward, through allgathers on the
    engine's prefetch lane ``HOROVOD_PREFETCH_DEPTH`` buckets ahead
    (``models/llama.py``'s ``make_train_step`` calls it).  Until the first
    step the full parameters stay in memory, and ``gather_params()`` then
    takes the shards from them.

    Default ``sharded=None`` reads ``HOROVOD_SHARDED_PARAMS`` (-> "full"),
    then ``HOROVOD_SHARDED_OPTIMIZER`` (-> True).  A sharded optimizer
    refuses ``backward_passes_per_step != 1``, compression, an op other
    than ``Sum``/``Average``, and ``gradient_predivide_factor != 1``; its
    ``state_dict()`` is this rank's shards' state; ``opt_state_bytes()``,
    ``params_bytes()`` and ``resident_bytes()`` count what this rank
    holds; ``hvd_sharded_saveable()`` and :func:`load_sharded_saveable`
    carry it across ranks.
    """
    if check:
        from .analysis.hooks import run_check_hook
        run_check_hook(check)
    if sharded is None:
        cfg = basics._get_state().config
        if cfg is not None and getattr(cfg, "sharded_params", False):
            sharded = "full"
        else:
            sharded = bool(cfg is not None
                           and getattr(cfg, "sharded_optimizer", False))
    if sharded not in (False, True, "full"):
        raise ValueError(
            f"sharded= must be False, True, or 'full'; got {sharded!r}")
    if sharded:
        label = 'sharded="full"' if sharded == "full" else "sharded=True"
        if backward_passes_per_step != 1:
            raise NotImplementedError(
                f"DistributedOptimizer({label}) does not compose with "
                "backward_passes_per_step > 1 yet: accumulate locally and "
                "call update every k-th step instead")
        if compression is not Compression.none:
            raise NotImplementedError(
                f"DistributedOptimizer({label}) does not support wire "
                "compression yet: the gather leg carries parameter deltas "
                "whose precision is the training result, not a gradient")
        if op not in (C.ReduceOp.AVERAGE, C.ReduceOp.SUM):
            raise ValueError(f"{label} supports SUM/AVERAGE, not {op!r}")
        if gradient_predivide_factor != 1.0:
            raise ValueError(f"gradient_predivide_factor not supported "
                             f"with DistributedOptimizer({label})")
        cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
                   dict(_ShardedDistributedOptimizer.__dict__))
        return cls(optimizer.param_groups, optimizer.__class__,
                   dict(optimizer.defaults), op, process_set,
                   "full" if sharded == "full" else True)
    if gradient_predivide_factor != 1.0 and op != mpi_ops.Average:
        raise ValueError(
            "gradient_predivide_factor not supported with op != Average")
    if op == mpi_ops.Adasum and gradient_predivide_factor != 1.0:
        raise ValueError(
            "gradient_predivide_factor not supported with Adasum")
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, gradient_predivide_factor,
               process_set)
