# Copied from horovod_tpu/analysis/collective_lint.py:1-778 (jax-free; the port keeps its own copy).
"""AST linter for deadlock-prone collective patterns (rules HVD101–HVD107).

The static half of what the reference's controller + stall inspector catch
at runtime (SURVEY.md §L2): ranks disagreeing on the sequence, signature or
process set of a collective.  Works on source text only — no jax import, no
initialization — so it can gate CI and be run over user training scripts
before a job ever touches a TPU.

Suppression: a ``# hvd-lint: disable=HVD101`` comment on the flagged line
(or comma-separated IDs, or ``disable=all``) silences that line.

The port's spellings of the same rules (name tables below):
``torch.distributed``'s ``all_reduce``, ``all_gather`` /
``all_gather_into_tensor``, ``all_to_all_single``,
``reduce_scatter_tensor``, ``broadcast``, ``barrier`` and
``batch_isend_irecv`` count as collectives (a ``group=`` argument scopes
them as ``process_set=`` does); the mesh's ``psum``, ``ppermute``,
``send_recv``, ``all_to_all`` and ``all_gather`` (``fn(x, mesh, axis,
...)``) and the ``.apply`` of ``PPermute``, ``AllToAll``, ``ReduceOutput``
and ``CopyInput`` count as in-graph collectives over a named axis of that
mesh, which HVD112 holds against the ``make_mesh({...})`` that built it;
``dist.get_rank()`` and a mesh's ``.index(axis)`` read rank identity.
``lax.psum(x, "dp")``-style calls keep the JAX reading, so a JAX script
lints the same under both packages.  HVD106 and HVD107 (jit context) and
HVD202 (``axis_index_groups``, in ``trace_check``) have no spelling in the
port: their detectors stay as they are, AST only, and fire on JAX code.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding, Severity

# ---------------------------------------------------------------------------
# Name tables
# ---------------------------------------------------------------------------

# Every public spelling of a collective submission across the bindings
# (ops/eager.py, torch/mpi_ops.py, tensorflow/mpi_ops.py, jax/optimizer.py).
_BASE_COLLECTIVES = {
    "allreduce", "allgather", "broadcast", "alltoall", "reducescatter",
    "barrier",
}
COLLECTIVE_NAMES: Set[str] = set()
for _b in _BASE_COLLECTIVES:
    for _v in (_b, f"{_b}_", f"{_b}_async", f"{_b}_async_",
               f"grouped_{_b}", f"grouped_{_b}_async",
               f"grouped_{_b}_async_", f"grouped_{_b}_"):
        COLLECTIVE_NAMES.add(_v)
# NB: hvd.join() is deliberately NOT here — it is the sanctioned way for
# ranks to stop submitting at different times (uneven final batches), so
# rank-divergent calls to it are correct, not a bug.
COLLECTIVE_NAMES |= {
    "broadcast_object", "allgather_object", "broadcast_pytree",
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_variables", "allreduce_gradients",
}

# Functions that perform the rank-0 state sync HVD103 wants to see.
_SYNC_CALLS = {
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_variables", "broadcast_object", "broadcast_pytree",
    "BroadcastGlobalVariablesCallback",
}

# Rank-identity accessors whose results make control flow rank-divergent
# (``get_rank`` is torch.distributed's spelling).
_RANK_CALLS = {"rank", "local_rank", "cross_rank", "process_index",
               "get_rank"}

# torch.distributed's collectives.  Names no JAX binding spells count
# wherever they are called; ``all_gather`` only on a ``dist`` receiver,
# where it is not ``lax.all_gather``.
_DIST_COLLECTIVES = {"all_reduce", "all_gather_into_tensor",
                     "all_to_all_single", "reduce_scatter_tensor",
                     "batch_isend_irecv"}
_DIST_RECEIVER_ONLY = {"all_gather"}
# The mesh's in-graph collectives (``parallel/mesh.py``), called as
# ``fn(x, mesh, axis, ...)``, and its autograd Functions' ``.apply`` of the
# same shape.
_MESH_COLLECTIVES = {"psum", "ppermute", "send_recv", "all_to_all",
                     "all_gather"}
_MESH_FUNCTIONS = {"PPermute", "AllToAll", "ReduceOutput", "CopyInput"}

# Host-sync / callback spellings flagged inside jit (HVD106).
_HOST_SYNC_CALLS = {
    "block_until_ready", "io_callback", "pure_callback", "call_host",
    "host_callback", "device_get",
}

# Gradient-reducing wrappers whose presence means "this is a training
# script" for HVD103.
_TRAINING_WRAPPERS = {
    "DistributedOptimizer", "DistributedGradientTape", "allreduce_gradients",
}

_DISABLE_RE = re.compile(r"hvd-lint\s*:\s*disable\s*=\s*([A-Za-z0-9_,\s]+)")

# Tracing wrappers whose body runs at trace time: @jit / @shard_map / @pmap
# decorations (directly or through functools.partial) put the function body
# in a jit context for HVD106/HVD107.
_JIT_WRAPPER_NAMES = {"jit", "shard_map", "pmap"}

# ZeRO-sharded configuration arguments (HVD110): these shape the
# whole data plane (reduce-scatter + allgather vs allreduce, 1/N shard
# layouts) and ride the negotiation digest — they must be fleet-uniform,
# never derived from rank identity.  Checked on collective submissions and
# on the wrappers that accept them.  ``hierarchical`` rides the
# fusion key rather than the digest, but batching groups entries BY fusion
# key, so a rank-divergent value still forks the batch plan — same rule.
# ``prefetch`` is fusion-key-only too AND picks the dispatch
# lane, so divergence would also reorder the backlog per rank.
_SHARD_ARG_NAMES = {"sharded", "num_shards", "shard_count", "hierarchical",
                    "prefetch"}
_SHARD_ARG_CALLS = {"DistributedOptimizer", "sharded_optimizer",
                    "init_sharded_state", "full_sharded_optimizer",
                    "init_full_sharded_state"}


def _call_name(node: ast.AST) -> Optional[str]:
    """Last dotted segment of a call target: ``hvd.ops.allreduce`` → ``allreduce``."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _names_mesh(expr: ast.AST) -> bool:
    """``mesh`` / ``self.mesh`` / ``tp_mesh`` (not ``mesh_axis``): an
    expression spelled as a mesh, the receiver or the second argument of
    the mesh's calls."""
    ident = expr.attr if isinstance(expr, ast.Attribute) else \
        expr.id if isinstance(expr, ast.Name) else ""
    return ident.lower().endswith("mesh")


def _is_dist_receiver(expr: ast.AST) -> bool:
    """``dist`` / ``torch.distributed`` / ``distributed``."""
    ident = expr.attr if isinstance(expr, ast.Attribute) else \
        expr.id if isinstance(expr, ast.Name) else ""
    return ident in ("dist", "distributed")


def mesh_call_parts(node: ast.Call):
    """``(mesh_expr, axis_expr)`` of a mesh collective in the port's
    spelling — ``psum(x, mesh, "tp")``, ``ReduceOutput.apply(x, mesh,
    axis)`` — or None (``lax.psum(x, "tp")`` names its axis second)."""
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr == "apply":
        if _call_name(func.value) not in _MESH_FUNCTIONS:
            return None
    elif _call_name(node) not in _MESH_COLLECTIVES:
        return None
    if len(node.args) < 3 or not _names_mesh(node.args[1]):
        return None
    return node.args[1], node.args[2]


def collective_name(node: ast.Call) -> Optional[str]:
    """The collective a call submits, as written (``ReduceOutput`` for
    ``ReduceOutput.apply(...)``), or None."""
    name = _call_name(node)
    if name in COLLECTIVE_NAMES or name in _DIST_COLLECTIVES:
        return name
    func = node.func
    if name in _DIST_RECEIVER_ONLY and isinstance(func, ast.Attribute) \
            and _is_dist_receiver(func.value):
        return name
    if mesh_call_parts(node) is not None:
        return _call_name(func.value) if name == "apply" else name
    return None


def _scoped_call(node: ast.Call) -> bool:
    """A collective that names its communicator: ``process_set=``,
    ``torch.distributed``'s ``group=``, or a mesh axis's group."""
    return any(kw.arg in ("process_set", "group") for kw in node.keywords) \
        or mesh_call_parts(node) is not None


def _is_collective_call(node: ast.Call) -> bool:
    return collective_name(node) is not None


def _is_rank_call(node: ast.Call) -> bool:
    """A rank-identity read: ``rank()``-style accessors, and a mesh's
    ``.index(axis)`` (``ProcessMesh.index``; not ``list.index``)."""
    name = _call_name(node)
    if name in _RANK_CALLS:
        return True
    return name == "index" and isinstance(node.func, ast.Attribute) \
        and _names_mesh(node.func.value)


def _mentions_rank(expr: ast.AST, tainted: Set[str]) -> bool:
    """True when the expression reads rank identity — a direct
    rank()/local_rank() call or a variable assigned from one."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and _is_rank_call(sub):
            return True
        if isinstance(sub, ast.Name) and sub.id in tainted:
            return True
    return False


def _iter_over_set_or_dict(it: ast.AST,
                           tainted: Optional[Set[str]] = None
                           ) -> Tuple[Optional[str], bool]:
    """Classify a for-loop iterable: ``(kind, neutralized)`` with kind
    'set'/'dict'/None.

    ``sorted(...)`` at the top neutralizes the ITERATION-order hazard —
    unless its ``key=`` is derived from rank identity, in which case each
    rank sorts into a different order and the hazard stands (a sorted()
    wrapper must not launder rank-divergent order).
    """
    if isinstance(it, ast.Call) and _call_name(it) == "sorted":
        kind, _ = _iter_over_set_or_dict(it.args[0], tainted) if it.args \
            else (None, False)
        for kw in it.keywords:
            if kw.arg == "key" and tainted is not None \
                    and _mentions_rank(kw.value, tainted):
                return kind, False
        return kind, True
    if isinstance(it, (ast.Set, ast.SetComp)):
        return "set", False
    if isinstance(it, ast.Call):
        name = _call_name(it)
        if name == "set":
            return "set", False
        if name in ("keys", "values", "items"):
            return "dict", False
        if name in ("enumerate", "list", "tuple", "reversed"):
            return _iter_over_set_or_dict(it.args[0], tainted) if it.args \
                else (None, False)
    return None, False


# In-graph lax collectives that name a mesh axis (positionally or via
# axis_name=) — HVD112 checks the name against the binding mesh's axes.
_LAX_AXIS_CALLS = {
    "psum", "pmean", "pmax", "pmin", "all_gather", "all_to_all",
    "ppermute", "pshuffle", "axis_index", "psum_scatter",
}


def _axes_from_mesh_call(call: ast.Call) -> Optional[Tuple[str, ...]]:
    """Statically known axis names of a mesh-constructing call:
    ``make_mesh({"dp": 2, "tp": 4})`` → ("dp", "tp");
    ``Mesh(devs, ("dp", "tp"))`` → ("dp", "tp");
    ``process_set_mesh(ps, axis_name="x")`` → ("x",).  None when the axes
    are not literal (no check is possible — and no false positive)."""
    name = _call_name(call)
    if name == "make_mesh":
        cands = list(call.args) + [kw.value for kw in call.keywords
                                   if kw.arg == "axis_sizes"]
        for arg in cands:
            if isinstance(arg, ast.Dict):
                keys = tuple(k.value for k in arg.keys
                             if isinstance(k, ast.Constant)
                             and isinstance(k.value, str))
                if keys and len(keys) == len(arg.keys):
                    return keys
        return None
    if name == "Mesh":
        cands = list(call.args[1:2]) + [kw.value for kw in call.keywords
                                        if kw.arg == "axis_names"]
        for arg in cands:
            if isinstance(arg, (ast.Tuple, ast.List)):
                if arg.elts and all(isinstance(e, ast.Constant)
                                    and isinstance(e.value, str)
                                    for e in arg.elts):
                    return tuple(e.value for e in arg.elts)
            elif isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                              str):
                return (arg.value,)
        return None
    if name == "process_set_mesh":
        for kw in call.keywords:
            if kw.arg == "axis_name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return (kw.value.value,)
        if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
                and isinstance(call.args[1].value, str):
            return (call.args[1].value,)
    return None


def _mesh_axis_vars(tree: ast.AST) -> Dict[str, Tuple[str, ...]]:
    """Names assigned from a mesh constructor with literal axes."""
    out: Dict[str, Tuple[str, ...]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call):
            axes = _axes_from_mesh_call(node.value)
            if axes:
                out[node.targets[0].id] = axes
    return out


def _mesh_axes_of_expr(expr: Optional[ast.AST],
                       mesh_vars: Dict[str, Tuple[str, ...]]
                       ) -> Optional[Tuple[str, ...]]:
    if isinstance(expr, ast.Name):
        return mesh_vars.get(expr.id)
    if isinstance(expr, ast.Call):
        return _axes_from_mesh_call(expr)
    return None


def _shard_map_call_info(node: ast.Call):
    """``(mesh_expr, spec_exprs, wrapped_name)`` for a ``shard_map(...)``
    call or a ``partial(shard_map, ...)`` decorator build; None otherwise."""
    name = _call_name(node)
    wrapped: Optional[ast.AST] = None
    if name == "shard_map":
        wrapped = node.args[0] if node.args else None
    elif not (name == "partial" and node.args
              and _call_name(node.args[0]) == "shard_map"):
        return None
    mesh = None
    specs: List[ast.AST] = []
    for kw in node.keywords:
        if kw.arg == "mesh":
            mesh = kw.value
        elif kw.arg in ("in_specs", "out_specs"):
            specs.append(kw.value)
    wname = wrapped.id if isinstance(wrapped, ast.Name) else None
    return mesh, specs, wname


def _jit_decorated(fn: ast.AST) -> bool:
    """True for ``@jax.jit`` / ``@jit`` / ``@partial(jax.jit, ...)`` /
    ``@functools.partial(shard_map, mesh=...)``-style decorations — any
    tracing wrapper in :data:`_JIT_WRAPPER_NAMES`, direct or via partial."""
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    for dec in fn.decorator_list:
        name = _call_name(dec)
        if name in _JIT_WRAPPER_NAMES:
            return True
        if name == "partial" and isinstance(dec, ast.Call) and dec.args:
            if _call_name(dec.args[0]) in _JIT_WRAPPER_NAMES:
                return True
    return False


def unwrap_wrapped_callable(call: ast.AST) -> Optional[str]:
    """Peel tracing/functools wrappers off a call expression and return the
    underlying function NAME: ``jax.jit(step)`` → ``step``,
    ``jit(shard_map(step, mesh=m))`` → ``step``,
    ``functools.partial(helper, 3)`` → ``helper``.  Returns None when the
    innermost wrapped object is not a plain name (lambda, attribute chain)
    or the expression is not a recognized wrapper."""
    seen = False
    while isinstance(call, ast.Call) and \
            _call_name(call) in (_JIT_WRAPPER_NAMES | {"partial", "wraps"}):
        if _call_name(call) == "partial" and call.args and \
                _call_name(call.args[0]) in _JIT_WRAPPER_NAMES:
            # partial(jit, static_argnums=...) builds a DECORATOR, it does
            # not wrap a user function.
            return None
        seen = True
        call = call.args[0] if call.args else None
    if seen and isinstance(call, ast.Name):
        return call.id
    return None


def _jit_wrapped_fn_names(tree: ast.AST) -> Set[str]:
    """Names of locally defined functions wrapped in a tracing context by
    ASSIGNMENT rather than decoration: ``step = jax.jit(step_impl)`` (or
    ``jit(shard_map(step_impl, ...))``) puts ``step_impl``'s body in a jit
    context for HVD106/HVD107 even though ``step_impl`` itself carries no
    decorator — previously such bodies hid from the jit-context rules."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _call_name(node.value) in _JIT_WRAPPER_NAMES:
            name = unwrap_wrapped_callable(node.value)
            if name:
                out.add(name)
    return out


class _FunctionFacts(ast.NodeVisitor):
    """Collect per-function taint: names assigned (transitively) from any
    of ``source_calls`` — rank-identity accessors by default; the
    whole-package HVD108 pass reuses this with world-size accessors to
    prove branch conditions rank-invariant."""

    def __init__(self, source_calls: Optional[Set[str]] = None):
        self.tainted: Set[str] = set()
        self._sources = source_calls

    def visit_Assign(self, node: ast.Assign):
        self._track(node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._track([node.target], node.value)
        self.generic_visit(node)

    def _track(self, targets, value):
        def taints(v) -> bool:
            if isinstance(v, ast.Call):
                return _is_rank_call(v) if self._sources is None \
                    else _call_name(v) in self._sources
            return isinstance(v, ast.Name) and v.id in self.tainted

        vals: List[ast.AST]
        if isinstance(value, ast.Tuple):
            vals = list(value.elts)
        else:
            vals = [value]
        for tgt in targets:
            tgts = list(tgt.elts) if isinstance(tgt, ast.Tuple) else [tgt]
            if len(tgts) == len(vals):
                for t, v in zip(tgts, vals):
                    if isinstance(t, ast.Name) and taints(v):
                        self.tainted.add(t.id)
            elif len(tgts) == 1 and isinstance(tgts[0], ast.Name) \
                    and any(taints(v) for v in vals):
                self.tainted.add(tgts[0].id)


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.findings: List[Finding] = []
        self.source = source
        # Module facts for HVD102/HVD103.
        self.has_init = False
        self.has_subgroup_sets = False
        self.has_sync = False
        self.has_training_wrapper = False
        self.uses_elastic_state = False
        self.init_line = 0
        self.first_training_line = 0
        self.collectives_without_ps: List[ast.Call] = []
        # Stack state while walking.
        self._fn_stack: List[dict] = []
        self._jit_depth = 0
        self._divergent_if_depth = 0
        # Per-function: line after which a rank-divergent early exit makes
        # later collectives subset-only.
        self._early_exit_after: List[Optional[int]] = []

    # -------------------------------------------------------------- helpers
    def _emit(self, rule: str, node: ast.AST, message: str):
        self.findings.append(Finding(
            rule=rule, path=self.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            message=message))

    def _tainted(self) -> Set[str]:
        return self._fn_stack[-1]["tainted"] if self._fn_stack else \
            self._module_tainted

    # ------------------------------------------------------------ functions
    def visit_Module(self, node: ast.Module):
        facts = _FunctionFacts()
        facts.visit(node)
        self._module_tainted = facts.tainted
        self._jit_wrapped_names = _jit_wrapped_fn_names(node)
        # HVD112: mesh vars with literal axes, and functions put in a
        # shard_map context by ASSIGNMENT (``step = shard_map(impl,
        # mesh=m)`` / ``jit(shard_map(impl, mesh=m))``) — their bodies
        # bind exactly that mesh's axes.
        self._mesh_vars = _mesh_axis_vars(node)
        self._shard_axes_by_name: Dict[str, Tuple[str, ...]] = {}
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _call_name(sub) == "shard_map":
                info = _shard_map_call_info(sub)
                if info and info[0] is not None and info[2]:
                    axes = _mesh_axes_of_expr(info[0], self._mesh_vars)
                    if axes:
                        self._shard_axes_by_name[info[2]] = axes
        self.generic_visit(node)

    def _visit_function(self, node):
        facts = _FunctionFacts()
        facts.visit(node)
        # @hvd.elastic.run / @run (imported from horovod_tpu_torch.elastic):
        # elastic-protected training syncs state on restore, which
        # satisfies HVD103's broadcast requirement.
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            dotted = []
            n = target
            while isinstance(n, ast.Attribute):
                dotted.append(n.attr)
                n = n.value
            if isinstance(n, ast.Name):
                dotted.append(n.id)
            if dotted and dotted[0] == "run" and (
                    len(dotted) == 1 or "elastic" in dotted):
                self.uses_elastic_state = True
        jit = _jit_decorated(node) or \
            node.name in getattr(self, "_jit_wrapped_names", ())
        # HVD112 context: the mesh axes this function's body is
        # shard_map-bound to (decorator or assignment wrapping).
        shard_axes: Optional[Tuple[str, ...]] = None
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call):
                info = _shard_map_call_info(dec)
                if info and info[0] is not None:
                    axes = _mesh_axes_of_expr(
                        info[0], getattr(self, "_mesh_vars", {}))
                    if axes:
                        shard_axes = axes
        if shard_axes is None:
            shard_axes = getattr(self, "_shard_axes_by_name",
                                 {}).get(node.name)
        self._fn_stack.append({"tainted": facts.tainted, "node": node,
                               "shard_axes": shard_axes})
        self._early_exit_after.append(None)
        if jit:
            self._jit_depth += 1
        self.generic_visit(node)
        if jit:
            self._jit_depth -= 1
        self._early_exit_after.pop()
        self._fn_stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # ------------------------------------------------- rank-divergent flow
    def _branch_has_exit(self, body: Sequence[ast.stmt]) -> bool:
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.Return, ast.Raise, ast.Continue,
                                    ast.Break)):
                    return True
                if isinstance(sub, ast.Call) and _call_name(sub) in (
                        "exit", "_exit", "abort"):
                    return True
        return False

    def visit_If(self, node: ast.If):
        divergent = _mentions_rank(node.test, self._tainted())
        if divergent:
            self._divergent_if_depth += 1
        self.generic_visit(node)
        if divergent:
            self._divergent_if_depth -= 1
            if self._early_exit_after and self._early_exit_after[-1] is None \
                    and (self._branch_has_exit(node.body)
                         or (node.orelse
                             and self._branch_has_exit(node.orelse))):
                self._early_exit_after[-1] = node.end_lineno or node.lineno

    def visit_While(self, node: ast.While):
        divergent = _mentions_rank(node.test, self._tainted())
        if divergent:
            self._divergent_if_depth += 1
        self.generic_visit(node)
        if divergent:
            self._divergent_if_depth -= 1

    def visit_IfExp(self, node: ast.IfExp):
        divergent = _mentions_rank(node.test, self._tainted())
        if divergent:
            self._divergent_if_depth += 1
        self.generic_visit(node)
        if divergent:
            self._divergent_if_depth -= 1

    # ------------------------------------------------------------ for loops
    def visit_For(self, node: ast.For):
        kind, neutralized = _iter_over_set_or_dict(node.iter,
                                                   self._tainted())
        if kind is not None and not neutralized:
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and _is_collective_call(sub):
                        rule = "HVD104" if kind == "set" else "HVD105"
                        self._emit(
                            rule, sub,
                            f"collective {collective_name(sub)!r} is "
                            f"submitted in "
                            f"{kind}-iteration order (loop at line "
                            f"{node.lineno}); ranks that build the {kind} "
                            f"differently submit in different order")
                        break
                else:
                    continue
                break
        elif kind is not None and neutralized:
            # sorted() fixed WHICH tensor comes out at each position — but
            # a grouped op whose process_set=/priorities= kwarg is derived
            # from rank identity still pairs each position with a
            # different communicator/priority per rank: same deadlock, a
            # sorted() wrapper must not launder it.
            done = False
            for stmt in node.body:
                if done:
                    break
                for sub in ast.walk(stmt):
                    if not (isinstance(sub, ast.Call)
                            and _is_collective_call(sub)):
                        continue
                    for kw in sub.keywords:
                        if kw.arg in ("process_set", "priorities") \
                                and _mentions_rank(kw.value,
                                                   self._tainted()):
                            rule = "HVD104" if kind == "set" else "HVD105"
                            self._emit(
                                rule, sub,
                                f"sorted() fixes the {kind}-iteration "
                                f"order of the loop at line {node.lineno}, "
                                f"but {kw.arg}= of "
                                f"{collective_name(sub)!r} is derived from "
                                f"rank identity — each rank still submits "
                                f"the group against a different process "
                                f"set/priority order")
                            done = True
                            break
                    if done:
                        break
        self.generic_visit(node)

    # ---------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call):
        name = _call_name(node)
        if name == "init":
            self.has_init = True
            self.init_line = self.init_line or node.lineno
        elif name == "add_process_set":
            self.has_subgroup_sets = True
        elif name in _SYNC_CALLS:
            self.has_sync = True
        elif name in ("JaxState", "TorchState", "TensorFlowKerasState"):
            # hvd.elastic state management syncs on restore.
            self.uses_elastic_state = True
        if name in _TRAINING_WRAPPERS:
            self.has_training_wrapper = True
            self.first_training_line = self.first_training_line or node.lineno

        if name in _HOST_SYNC_CALLS and self._jit_depth > 0:
            self._emit("HVD106", node,
                       f"{name!r} inside a jit-decorated function forces a "
                       f"host round-trip at trace/run time")

        self._check_axis_binding(node, name)
        self._check_mesh_axis(node)

        cname = collective_name(node)
        if cname is not None:
            self._check_collective(node, cname)
        if name in COLLECTIVE_NAMES or name in _SHARD_ARG_CALLS:
            self._check_shard_args(node, name)
        self.generic_visit(node)

    def _shard_axes(self) -> Optional[Tuple[str, ...]]:
        for entry in reversed(self._fn_stack):
            axes = entry.get("shard_axes")
            if axes is not None:
                return axes
        return None

    def _check_axis_binding(self, node: ast.Call, name: Optional[str]):
        """HVD112 (AST half): a collective naming an axis its binding mesh
        does not define, or a PartitionSpec naming an unknown axis at the
        shard_map site — the fsdp × tp mismatch.  Only fires when the
        mesh's axes are statically known (literal make_mesh/Mesh/
        process_set_mesh), so unknown meshes can't false-positive."""
        # (a) At a shard_map site with a known mesh: P()/PartitionSpec()
        # entries in in_specs/out_specs must name that mesh's axes.
        info = _shard_map_call_info(node) if isinstance(node, ast.Call) \
            else None
        if info and info[0] is not None:
            axes = _mesh_axes_of_expr(info[0],
                                      getattr(self, "_mesh_vars", {}))
            if axes:
                for spec in info[1]:
                    for sub in ast.walk(spec):
                        if isinstance(sub, ast.Call) and \
                                _call_name(sub) in ("P", "PartitionSpec"):
                            for c in ast.walk(sub):
                                if isinstance(c, ast.Constant) \
                                        and isinstance(c.value, str) \
                                        and c.value not in axes:
                                    self._emit(
                                        "HVD112", sub,
                                        f"PartitionSpec names axis "
                                        f"{c.value!r}, but the shard_map "
                                        f"mesh defines axes "
                                        f"{list(axes)} — the spec shards "
                                        f"over an axis that does not "
                                        f"exist on this mesh")
        # (b) Inside a shard_map-bound body: in-graph collectives must
        # name axes of THE binding mesh.
        axes = self._shard_axes()
        if axes is None:
            return
        if name not in _LAX_AXIS_CALLS and name not in COLLECTIVE_NAMES:
            return
        targets: List[ast.AST] = [kw.value for kw in node.keywords
                                  if kw.arg == "axis_name"]
        if not targets and name in _LAX_AXIS_CALLS and len(node.args) >= 2:
            targets = [node.args[1]]
        for t in targets:
            named: List[str] = []
            if isinstance(t, ast.Constant) and isinstance(t.value, str):
                named = [t.value]
            elif isinstance(t, (ast.Tuple, ast.List)):
                named = [e.value for e in t.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str)]
            for ax in named:
                if ax not in axes:
                    self._emit(
                        "HVD112", node,
                        f"collective {name!r} names axis {ax!r}, but its "
                        f"binding mesh defines axes {list(axes)} — the "
                        f"collective reduces over an axis that does not "
                        f"exist on this mesh (at best lowering fails; on "
                        f"a differently-built mesh it silently reduces "
                        f"over a 1-sized axis)")

    def _check_mesh_axis(self, node: ast.Call):
        """HVD112 in the port's spelling: a mesh collective naming an axis
        literal that the ``make_mesh({...})`` its mesh came from does not
        bind (``psum(x, mesh, "tq")`` on ``make_mesh({"tp": 2})``) —
        ``ProcessMesh.axis`` refuses it at run time, on every rank."""
        parts = mesh_call_parts(node)
        if parts is None:
            return
        mesh, axis = parts
        axes = _mesh_axes_of_expr(mesh, getattr(self, "_mesh_vars", {}))
        if axes and isinstance(axis, ast.Constant) \
                and isinstance(axis.value, str) and axis.value not in axes:
            self._emit(
                "HVD112", node,
                f"collective {collective_name(node)!r} names axis "
                f"{axis.value!r}, but its mesh defines axes {list(axes)} — "
                f"the collective reduces over an axis that does not exist "
                f"on this mesh")

    def _check_shard_args(self, node: ast.Call, name: str):
        """HVD110: sharded=/shard-count/hierarchical= arguments must be
        rank-invariant — sharded= is part of the negotiation digest and
        forks the whole collective schedule (reduce-scatter+allgather vs
        allreduce); hierarchical= is fusion-key-only but batching groups
        by fusion key, so divergence still forks the batch plan."""
        for kw in node.keywords:
            if kw.arg in _SHARD_ARG_NAMES \
                    and _mentions_rank(kw.value, self._tainted()):
                self._emit(
                    "HVD110", node,
                    f"{kw.arg}= argument of {name!r} is derived from rank "
                    f"identity: ranks would disagree on the collective "
                    f"data plane (sharded/two-level vs flat schedules) "
                    f"and submit mismatched programs")

    def _check_collective(self, node: ast.Call, name: str):
        if self._jit_depth > 0 and name in COLLECTIVE_NAMES \
                and not self._in_graph_spelling(node):
            self._emit("HVD107", node,
                       f"eager collective {name!r} inside a jit-decorated "
                       f"function submits to the engine at trace time")
        if self._divergent_if_depth > 0:
            self._emit("HVD101", node,
                       f"collective {name!r} is inside rank-divergent "
                       f"control flow: only a subset of ranks submits it, "
                       f"the rest of the world blocks in negotiation")
        elif self._early_exit_after and self._early_exit_after[-1] is not None \
                and node.lineno > self._early_exit_after[-1]:
            self._emit("HVD101", node,
                       f"collective {name!r} at line {node.lineno} is only "
                       f"reached by ranks that did not take the early "
                       f"return/raise under the rank-divergent branch ending "
                       f"at line {self._early_exit_after[-1]}")
        if not _scoped_call(node):
            self.collectives_without_ps.append(node)

    @staticmethod
    def _in_graph_spelling(node: ast.Call) -> bool:
        """In-graph collectives (``ops.collectives`` riding lax.psum) are
        jit-safe.  Recognized by an explicit ``axis_name=`` kwarg, or by the
        conventional receiver names for that module (``C.allreduce(x)``
        relying on the DEFAULT_AXIS default is correct in-graph code and
        must not fire HVD107)."""
        if any(kw.arg == "axis_name" for kw in node.keywords):
            return True
        func = node.func
        if isinstance(func, ast.Attribute) and isinstance(func.value,
                                                          ast.Name):
            return func.value.id in ("C", "collectives")
        return False

    # ------------------------------------------------------------ wrap-up
    def finish(self):
        if self.has_subgroup_sets:
            for node in self.collectives_without_ps:
                self._emit(
                    "HVD102", node,
                    f"collective {collective_name(node)!r} omits "
                    f"process_set= in "
                    f"a module that registers subgroup process sets; it "
                    f"targets the GLOBAL set — a deadlock if only subgroup "
                    f"members reach this call")
        if (self.has_init and self.has_training_wrapper
                and not self.has_sync and not self.uses_elastic_state):
            self.findings.append(Finding(
                rule="HVD103", path=self.path,
                line=self.first_training_line or self.init_line, col=1,
                message="training script calls init() and reduces gradients "
                        "but never broadcasts initial state from rank 0; "
                        "ranks train divergent models"))


def _suppressed_lines(source: str) -> Dict[int, Set[str]]:
    """Map line → suppressed rule IDs from ``# hvd-lint: disable=...``."""
    out: Dict[int, Set[str]] = {}
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type == tokenize.COMMENT:
                m = _DISABLE_RE.search(tok.string)
                if m:
                    ids = {s.strip().upper() for s in m.group(1).split(",")}
                    out.setdefault(tok.start[0], set()).update(ids)
    except (tokenize.TokenError, SyntaxError):  # pragma: no cover
        pass
    return out


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one module's source; returns findings sorted by line."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="HVD100", path=path, line=e.lineno or 1,
                        col=(e.offset or 0) + 1,
                        message=f"syntax error: {e.msg}",
                        severity=Severity.ERROR,
                        fix_hint="fix the syntax error; the linter cannot "
                                 "analyze this file")]
    linter = _Linter(path, source)
    linter.visit(tree)
    linter.finish()
    suppressed = _suppressed_lines(source)
    out = []
    for f in linter.findings:
        ids = suppressed.get(f.line, set())
        if "ALL" in ids or f.rule in ids:
            continue
        out.append(f)
    return sorted(out, key=lambda f: (f.line, f.col, f.rule))


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def iter_python_files(paths: Iterable[str]) -> List[str]:
    """Expand files/dirs to lintable files.  Directories contribute their
    ``.py`` trees; an explicitly named file is linted regardless of suffix
    (a suffix-less training script is still Python); a missing path raises
    so the CLI can report a usage error instead of a clean verdict."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        elif os.path.isfile(p):
            out.append(p)
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
    return out


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """Lint every ``.py`` file under the given files/directories."""
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(lint_file(f))
    return findings
