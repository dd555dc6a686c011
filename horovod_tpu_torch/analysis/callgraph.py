# Copied from horovod_tpu/analysis/callgraph.py:1-952 (jax-free; the port keeps its own copy).
"""Pass 1 of the whole-package analyzer: symbol table + call graph.

Per-module lint (``collective_lint``) cannot see across function or module
boundaries: a ``psum`` inside a helper called from a rank-guarded branch is
invisible to HVD101, and HVD102/HVD103 facts (process-set registration,
initial-broadcast hygiene) don't flow between modules.  This module walks
every file of a package ONCE and builds the structures pass 2
(:mod:`.whole_package`) propagates facts over:

- a **symbol table** per module: top-level functions, classes with their
  methods and base classes, import aliases (``import a.b as c``,
  ``from .m import f`` — relative imports resolved against the module's
  package), and callable aliases through wrapper factories
  (``step = jax.jit(train_step)``, ``g = functools.partial(helper, 3)``);
- a **call graph**: every call site, annotated with the rank-guard context
  it sits in (inside an ``if rank() == 0:`` branch, or after a
  rank-divergent early return) and resolved best-effort to the defining
  :class:`FunctionNode` — including method resolution for the
  optimizer/tape binding idiom (``opt = hvd.DistributedOptimizer(...);
  opt.apply_gradients(...)`` and ``self.attr = C(...); self.attr.m()``);
- per-function **fact summaries** (collective sites, init/broadcast/
  process-set calls) that pass 2 unions over entry-point closures.

Known imprecision (documented in docs/analysis.md): dynamic dispatch
through containers, ``getattr`` calls, and functions passed as values are
not resolved; decorators are treated as transparent (the decorated body is
assumed reachable through the name).  Everything here is pure ``ast`` —
no jax import, nothing executes.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .collective_lint import (
    _FunctionFacts, _TRAINING_WRAPPERS, _call_name, _mentions_rank,
    _suppressed_lines, collective_name, iter_python_files, mesh_call_parts,
    unwrap_wrapped_callable,
)

# Elastic/churn handlers that run while the rank set is MID-TRANSITION
# (HVD109).  ``on_reset`` is deliberately absent: reference semantics run
# reset callbacks AFTER re-rendezvous completes, where a state-sync
# broadcast is the sanctioned pattern.
MID_TRANSITION_CALLBACKS = {
    "on_leave", "on_join", "new_generation", "end_generation",
    "on_hosts_updated", "on_preempt", "on_host_down", "on_host_added",
    "on_drain",
}

_UNIFORM_CALLS = {
    # Rank-INVARIANT reads: every rank computes the same value, so a branch
    # on them does not diverge the collective schedule (HVD108 exemption).
    # ``get_world_size`` is torch.distributed's spelling.
    "size", "local_size", "cross_size", "num_ranks", "world_size",
    "device_count", "local_device_count", "process_count",
    "is_initialized", "initialized", "get_world_size",
}


@dataclasses.dataclass(frozen=True)
class ProcessSetValue:
    """Abstract value of a collective's process-set argument (the dataflow
    domain HVD111/113/114 run over).

    ``kind`` is one of:

    - ``"world"``   — no ``process_set=`` (or an explicit ``None``): the
      global set, id 0;
    - ``"named"``   — a value traced to an ``add_process_set(...)`` /
      ``ProcessSet(...)`` registration; ``ranks`` carries the literal rank
      list when the registration spelled one;
    - ``"param"``   — the enclosing function's own ``process_set``-style
      parameter (a scoped helper, resolved per call site by pass 2);
    - ``"unknown"`` — anything the tracker cannot prove.

    Overlap judgements (:func:`proven_overlap`) are deliberately
    one-sided: only PROVEN overlap fires the ERROR rules, so an unknown
    value can never produce a false HVD111.
    """
    kind: str
    spelling: str
    ranks: Optional[Tuple[int, ...]] = None

    @property
    def lane(self) -> str:
        """Stable per-set schedule-lane key (world is the default lane)."""
        if self.kind == "world":
            return "world"
        if self.kind == "param":
            return f"<{self.spelling}>"
        if self.kind == "unknown":
            return f"?{self.spelling}"
        return self.spelling

    def describe(self) -> str:
        if self.kind == "world":
            return "the world set"
        if self.kind == "named" and self.ranks is not None:
            return f"process set {self.spelling} (ranks {list(self.ranks)})"
        if self.kind == "param":
            return f"the caller-supplied process set '{self.spelling}'"
        return f"process set {self.spelling}"


WORLD = ProcessSetValue("world", "<world>")


def proven_overlap(a: ProcessSetValue, b: ProcessSetValue) -> bool:
    """True only when two DISTINCT sets provably share at least one rank.

    Every registered set is a nonempty subset of the world, so
    (world, named) always overlaps; two named sets overlap only when both
    spelled literal rank lists that intersect.  params/unknowns never
    prove overlap — the conservative side that keeps HVD111 free of false
    positives on disjoint or unresolvable sets.
    """
    if a.lane == b.lane:
        return False                 # same lane: one stream, no entangling
    kinds = (a.kind, b.kind)
    if "world" in kinds:
        other = b if a.kind == "world" else a
        return other.kind == "named"
    if a.kind == "named" and b.kind == "named" \
            and a.ranks is not None and b.ranks is not None:
        return bool(set(a.ranks) & set(b.ranks))
    return False


def _literal_ranks(call: ast.Call) -> Optional[Tuple[int, ...]]:
    """``add_process_set([0, 2])`` → ``(0, 2)``; None when not literal."""
    args = list(call.args)
    for kw in call.keywords:
        if kw.arg in ("ranks", "ps_or_ranks"):
            args.append(kw.value)
    for arg in args:
        if isinstance(arg, (ast.List, ast.Tuple)):
            vals = []
            for e in arg.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, int):
                    vals.append(e.value)
                else:
                    return None
            return tuple(sorted(vals))
    return None


@dataclasses.dataclass(frozen=True)
class Guard:
    """A rank-divergent context a call site sits in."""
    line: int
    kind: str            # "branch" | "early-exit"

    def describe(self, module_base: str) -> str:
        what = "rank-guarded branch" if self.kind == "branch" else \
            "rank-divergent early exit"
        return f"{what} at {module_base}:{self.line}"


@dataclasses.dataclass
class CallSite:
    callee_expr: Optional[str]   # dotted spelling as written, None if exotic
    line: int
    col: int
    guard: Optional[Guard]
    resolved: Optional["FunctionNode"] = None
    # Resolved ``process_set=`` kwarg at this call site — explicit, or
    # pinned by a ``functools.partial(helper, process_set=...)`` alias the
    # call goes through.  Pass 2 substitutes it for the callee's ``param``
    # values (HVD113's scoped-region entry edges).
    ps_kwarg: Optional[ProcessSetValue] = None


@dataclasses.dataclass
class CollectiveSite:
    name: str
    line: int
    col: int
    guard: Optional[Guard]
    has_process_set: bool
    # ZeRO-sharded site: the constant ``sharded=`` value a
    # collective was submitted with (True or "full"), or the mode of the
    # synthetic ``sharded_update`` site registered for ``opt.update(...)``
    # on a DistributedOptimizer(sharded=...) / sharded_optimizer /
    # full_sharded_optimizer binding — the schedule pass expands the
    # latter to its real reduce-scatter + allgather sequence, tagged
    # [sharded] or [full] by mode.
    sharded: Any = False
    # Two-level dispatch pin: a collective submitted with a
    # constant hierarchical= override.  Unlike sharded= it rides the
    # fusion key only (never the negotiation digest), but it still forks
    # the batch plan — the schedule pass keys on it like [sharded].
    hierarchical: bool = False
    # Resolved process-set value of this site (the schedule lane it
    # submits on); WORLD when no process_set= / axis binding applies.
    ps: ProcessSetValue = WORLD


@dataclasses.dataclass
class FunctionNode:
    qname: str                   # "modname:Class.method" / "modname:<module>"
    module: "ModuleInfo"
    name: str
    cls: Optional[str]
    lineno: int
    node: Optional[ast.AST]
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    collectives: List[CollectiveSite] = dataclasses.field(
        default_factory=list)
    called_names: Set[str] = dataclasses.field(default_factory=set)
    # var -> ("instance"|"alias", dotted target expr)
    bindings: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    uses_elastic_state: bool = False
    is_callback: bool = False
    in_edges: int = 0
    # Names bound to a sharded optimizer wrapper in this scope, mapped to
    # the sharding mode (True = ZeRO-1, "full" = ZeRO-3/FSDP): their
    # ``.update()`` calls register synthetic sharded_update sites.
    sharded_opt_vars: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    # Process-set dataflow: parameter names (so a
    # ``process_set=<param>`` resolves to kind="param"), names bound to
    # registered sets in this scope, partial-pinned process_set kwargs
    # (var of the partial alias -> pinned value), and mesh-axis bindings
    # from ``process_set_mesh(ps, axis_name=...)``.
    params: Tuple[str, ...] = ()
    ps_bindings: Dict[str, ProcessSetValue] = dataclasses.field(
        default_factory=dict)
    partial_ps: Dict[str, ProcessSetValue] = dataclasses.field(
        default_factory=dict)
    axis_bindings: Dict[str, ProcessSetValue] = dataclasses.field(
        default_factory=dict)

    @property
    def short(self) -> str:
        return f"{os.path.basename(self.module.path)}:{self.lineno} " \
               f"({self.name if not self.cls else self.cls + '.' + self.name})"


@dataclasses.dataclass
class ClassInfo:
    name: str
    qname: str
    module: "ModuleInfo"
    bases: List[str]
    methods: Dict[str, FunctionNode] = dataclasses.field(default_factory=dict)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModuleInfo:
    path: str
    modname: str
    package: str                 # package relative imports resolve against
    source: str = ""             # kept so pass 2 lints without re-reading
    functions: Dict[str, FunctionNode] = dataclasses.field(
        default_factory=dict)          # top-level (and nested) defs by name
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    toplevel: Optional[FunctionNode] = None
    all_functions: List[FunctionNode] = dataclasses.field(
        default_factory=list)
    suppressed: Dict[int, Set[str]] = dataclasses.field(default_factory=dict)
    init_line: int = 0
    first_training_line: int = 0

    @property
    def base(self) -> str:
        return os.path.basename(self.path)


@dataclasses.dataclass
class Package:
    # For IMPORT RESOLUTION, keyed by dotted module name (first wins on a
    # stem collision — two unrelated dir1/train.py + dir2/train.py can't
    # import each other anyway).
    modules: Dict[str, ModuleInfo]
    functions: Dict[str, FunctionNode]     # by qname (resolution only)
    classes: Dict[str, ClassInfo]          # by "modname:Class"
    # EVERY analyzed module, collisions included: the analysis passes
    # (closures, facts, schedules, findings) iterate this, so a shadowed
    # modname never silently drops a file's findings.
    all_modules: List[ModuleInfo] = dataclasses.field(default_factory=list)

    def iter_functions(self) -> Iterable[FunctionNode]:
        for mod in self.all_modules:
            for fn in mod.all_functions:
                yield fn


def module_name_for(path: str) -> str:
    """Dotted module name: ascend while ``__init__.py`` marks a package."""
    path = os.path.abspath(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    parts = [] if stem == "__init__" else [stem]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.insert(0, os.path.basename(d))
        d = os.path.dirname(d)
    return ".".join(parts) or stem


def _dotted(node: ast.AST) -> Optional[str]:
    """Render an attribute chain to a dotted string; None for exotica."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _resolve_relative(package: str, level: int, module: Optional[str]) -> str:
    """``from ..a import b`` in package ``p.q`` → base ``p.a``."""
    parts = package.split(".") if package else []
    if level > 1:
        parts = parts[: len(parts) - (level - 1)]
    if module:
        parts = parts + module.split(".")
    return ".".join(parts)


class _Collector(ast.NodeVisitor):
    """One pass over a module: symbols, guarded call sites, fact summaries.

    Mirrors the per-module linter's rank-guard model (_mentions_rank taint,
    divergent-if depth, early-exit lines) so whole-package HVD101 findings
    agree with per-function ones about what counts as guarded.
    """

    def __init__(self, mod: ModuleInfo, tree: ast.Module):
        self.mod = mod
        self._fn_stack: List[FunctionNode] = []
        self._guard_stack: List[Guard] = []
        self._early_exit: List[Optional[Guard]] = []
        self._class_stack: List[ClassInfo] = []
        facts = _FunctionFacts()
        facts.visit(tree)
        self._taint_stack: List[Set[str]] = [facts.tainted]
        top = FunctionNode(qname=f"{mod.modname}:<module>", module=mod,
                           name="<module>", cls=None, lineno=1, node=tree)
        mod.toplevel = top
        mod.all_functions.append(top)
        self._fn_stack.append(top)
        self._early_exit.append(None)

    # ----------------------------------------------------------- helpers
    def _cur(self) -> FunctionNode:
        return self._fn_stack[-1]

    def _cur_guard(self) -> Optional[Guard]:
        if self._guard_stack:
            return self._guard_stack[-1]
        return self._early_exit[-1]

    # --------------------------------------------------------- functions
    def _visit_function(self, node):
        cls = self._class_stack[-1] if self._class_stack else None
        qname = f"{self.mod.modname}:" + \
            (f"{cls.name}.{node.name}" if cls else node.name)
        fn = FunctionNode(qname=qname, module=self.mod, name=node.name,
                          cls=cls.name if cls else None,
                          lineno=node.lineno, node=node)
        fn.is_callback = node.name in MID_TRANSITION_CALLBACKS
        a = node.args
        fn.params = tuple(p.arg for p in
                          list(a.posonlyargs) + list(a.args)
                          + list(a.kwonlyargs))
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            d = _dotted(target) or ""
            tail = d.rsplit(".", 1)[-1]
            if tail == "run" and ("elastic" in d or d == "run"):
                fn.uses_elastic_state = True
        if cls is not None:
            cls.methods[node.name] = fn
        elif len(self._fn_stack) == 1:      # genuine top-level def
            self.mod.functions[node.name] = fn
        else:                                # nested def: best-effort by name
            self.mod.functions.setdefault(node.name, fn)
        self.mod.all_functions.append(fn)

        facts = _FunctionFacts()
        facts.visit(node)
        self._fn_stack.append(fn)
        self._taint_stack.append(facts.tainted)
        self._early_exit.append(None)
        saved_guards = self._guard_stack
        self._guard_stack = []      # a def body does not run at the def site
        self.generic_visit(node)
        self._guard_stack = saved_guards
        self._early_exit.pop()
        self._taint_stack.pop()
        self._fn_stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_ClassDef(self, node: ast.ClassDef):
        info = ClassInfo(
            name=node.name, qname=f"{self.mod.modname}:{node.name}",
            module=self.mod,
            bases=[b for b in (_dotted(x) for x in node.bases) if b])
        self.mod.classes[node.name] = info
        self._class_stack.append(info)
        self.generic_visit(node)
        self._class_stack.pop()

    # ----------------------------------------------------------- imports
    def visit_Import(self, node: ast.Import):
        # Imports anywhere in the file bind module-wide (best effort).
        for alias in node.names:
            name = alias.asname or alias.name.split(".")[0]
            target = alias.name if alias.asname else alias.name.split(".")[0]
            self.mod.imports[name] = target
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        base = node.module or ""
        if node.level:
            base = _resolve_relative(self.mod.package or self.mod.modname,
                                     node.level, node.module)
        for alias in node.names:
            if alias.name == "*":
                continue
            name = alias.asname or alias.name
            self.mod.imports[name] = f"{base}.{alias.name}" if base \
                else alias.name
        self.generic_visit(node)

    # --------------------------------------------------- rank-guard flow
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

    def _visit_divergent(self, node, bodies=()):
        divergent = _mentions_rank(node.test, self._taint_stack[-1])
        if divergent:
            self._guard_stack.append(Guard(line=node.lineno, kind="branch"))
        self.generic_visit(node)
        if divergent:
            self._guard_stack.pop()
            if isinstance(node, ast.If) and self._early_exit[-1] is None \
                    and (self._branch_has_exit(node.body)
                         or (node.orelse
                             and self._branch_has_exit(node.orelse))):
                self._early_exit[-1] = Guard(
                    line=node.end_lineno or node.lineno, kind="early-exit")

    visit_If = _visit_divergent
    visit_While = _visit_divergent
    visit_IfExp = _visit_divergent

    # ------------------------------------------------- process-set values
    def _ps_scopes(self) -> List["FunctionNode"]:
        scopes = [self._cur()]
        if self.mod.toplevel is not None \
                and self._cur() is not self.mod.toplevel:
            scopes.append(self.mod.toplevel)
        return scopes

    def _resolve_ps(self, expr: ast.AST) -> ProcessSetValue:
        """Abstract-evaluate a ``process_set=`` argument expression."""
        if isinstance(expr, ast.Constant) and expr.value is None:
            return WORLD
        if isinstance(expr, ast.Call):
            cname = _call_name(expr)
            if cname in ("add_process_set", "ProcessSet"):
                return ProcessSetValue("named", "<anonymous>",
                                       _literal_ranks(expr))
            return ProcessSetValue("unknown", cname or "<call>")
        if isinstance(expr, ast.Name):
            for scope in self._ps_scopes():
                if expr.id in scope.ps_bindings:
                    return scope.ps_bindings[expr.id]
            if expr.id in self._cur().params:
                return ProcessSetValue("param", expr.id)
            return ProcessSetValue("unknown", expr.id)
        d = _dotted(expr)
        return ProcessSetValue("unknown", d or "<expr>")

    def _lookup_axis(self, axis: str) -> Optional[ProcessSetValue]:
        for scope in self._ps_scopes():
            if axis in scope.axis_bindings:
                return scope.axis_bindings[axis]
        return None

    # --------------------------------------------------------- bindings
    @staticmethod
    def _is_sharded_opt_call(val: ast.Call) -> Any:
        """The sharding mode a binding value yields, or False: the zero
        wrappers themselves (sharded_optimizer → True,
        full_sharded_optimizer → "full"), or DistributedOptimizer with a
        constant sharded= whose value is the mode (non-constant sharded=
        is HVD110's territory)."""
        name = _call_name(val)
        if name == "sharded_optimizer":
            return True
        if name == "full_sharded_optimizer":
            return "full"
        if name == "DistributedOptimizer":
            for kw in val.keywords:
                if kw.arg == "sharded" and isinstance(kw.value,
                                                      ast.Constant):
                    v = kw.value.value
                    if v == "full":
                        return "full"
                    return bool(v)
        return False

    def visit_Assign(self, node: ast.Assign):
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            tgt = node.targets[0].id
            val = node.value
            # ANY rebind clears a sharded-optimizer marking first (a
            # Name/None/attribute reassignment must not leave a stale
            # entry registering phantom sharded_update sites).  Same for
            # stale process-set / partial-pin entries.
            self._cur().sharded_opt_vars.pop(tgt, None)
            self._cur().ps_bindings.pop(tgt, None)
            self._cur().partial_ps.pop(tgt, None)
            if isinstance(val, ast.Call):
                cname = _call_name(val)
                if cname in ("add_process_set", "ProcessSet"):
                    self._cur().ps_bindings[tgt] = ProcessSetValue(
                        "named", tgt, _literal_ranks(val))
                elif cname == "partial":
                    for kw in val.keywords:
                        if kw.arg == "process_set":
                            self._cur().partial_ps[tgt] = \
                                self._resolve_ps(kw.value)
                mode = self._is_sharded_opt_call(val)
                if mode:
                    self._cur().sharded_opt_vars[tgt] = mode
                wrapped = unwrap_wrapped_callable(val)
                if wrapped is not None:
                    self._cur().bindings[tgt] = ("alias", wrapped)
                else:
                    d = _dotted(val.func)
                    if d:
                        self._cur().bindings[tgt] = ("instance", d)
            elif isinstance(val, ast.Name):
                self._cur().bindings[tgt] = ("alias", val.id)
                for scope in self._ps_scopes():
                    if val.id in scope.ps_bindings:
                        self._cur().ps_bindings[tgt] = \
                            scope.ps_bindings[val.id]
                        break
            elif isinstance(val, ast.Attribute):
                d = _dotted(val)
                if d:
                    self._cur().bindings[tgt] = ("alias", d)
                # ``axis = ps.axis_name``: the axis VARIABLE now carries
                # the set — in-graph collectives submitting over it are
                # set-scoped, not bare world (the jax/optimizer.py
                # pattern).  Keyed by variable name in the same table as
                # constant axis strings; _lookup_axis serves both.
                if val.attr == "axis_name" \
                        and isinstance(val.value, ast.Name):
                    base = self._resolve_ps(val.value)
                    if base.kind in ("named", "param"):
                        self._cur().axis_bindings[tgt] = base
        # self.attr = C(...) inside a method: class attribute type.
        if self._class_stack and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Attribute) \
                and isinstance(node.targets[0].value, ast.Name) \
                and node.targets[0].value.id == "self" \
                and isinstance(node.value, ast.Call):
            d = _dotted(node.value.func)
            if d:
                self._class_stack[-1].attr_types[node.targets[0].attr] = d
        self.generic_visit(node)

    # ------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call):
        fn = self._cur()
        name = _call_name(node)
        if name:
            fn.called_names.add(name)
            if name == "init" and not self.mod.init_line:
                self.mod.init_line = node.lineno
            if name in _TRAINING_WRAPPERS and not self.mod.first_training_line:
                self.mod.first_training_line = node.lineno
            if name in ("JaxState", "TorchState", "TensorFlowKerasState"):
                fn.uses_elastic_state = True
        if name == "process_set_mesh":
            # ``m = process_set_mesh(evens, axis_name="dp")`` binds the
            # mesh axis "dp" to the set's value: in-graph collectives over
            # that axis_name submit on the set's lane.
            ps_arg: Optional[ast.AST] = node.args[0] if node.args else None
            axis: Optional[str] = None
            for kw in node.keywords:
                if kw.arg == "process_set":
                    ps_arg = kw.value
                elif kw.arg == "axis_name" \
                        and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    axis = kw.value.value
            if axis is not None:
                fn.axis_bindings[axis] = (
                    self._resolve_ps(ps_arg) if ps_arg is not None
                    else WORLD)
        cname = collective_name(node)
        if cname is not None:
            ps = WORLD
            has_ps = False
            for kw in node.keywords:
                if kw.arg in ("process_set", "group"):
                    has_ps = True
                    ps = self._resolve_ps(kw.value)
            parts = mesh_call_parts(node)
            if parts is not None:
                # A mesh collective runs on its axis's own group: the lane
                # is the mesh and axis as spelled.
                has_ps = True
                axis = parts[1]
                ps = ProcessSetValue("unknown", "{}:{}".format(
                    _dotted(parts[0]) or "<mesh>",
                    axis.value if isinstance(axis, ast.Constant)
                    else _dotted(axis) if axis is not None else "?"))
            if not has_ps:
                # Positional forwarding: a registered-set name (or the
                # enclosing function's own process_set parameter) passed
                # positionally still scopes the site — the eager-op
                # wrappers thread process_set positionally, and treating
                # them as bare world sites would false-positive HVD113.
                for arg in node.args:
                    if not isinstance(arg, ast.Name):
                        continue
                    v: Optional[ProcessSetValue] = None
                    for scope in self._ps_scopes():
                        if arg.id in scope.ps_bindings:
                            v = scope.ps_bindings[arg.id]
                            break
                    if v is None and "process_set" in arg.id \
                            and arg.id in self._cur().params:
                        v = ProcessSetValue("param", arg.id)
                    if v is not None:
                        ps = v
                        break
            if not has_ps and ps is WORLD:
                # In-graph form: an axis_name bound by a process_set_mesh
                # in scope (constant) or carrying ``ps.axis_name`` (axis
                # variable) pins the site to that lane.
                for kw in node.keywords:
                    if kw.arg != "axis_name":
                        continue
                    key: Optional[str] = None
                    if isinstance(kw.value, ast.Constant) \
                            and isinstance(kw.value.value, str):
                        key = kw.value.value
                    elif isinstance(kw.value, ast.Name):
                        key = kw.value.id
                    if key is not None:
                        bound = self._lookup_axis(key)
                        if bound is not None:
                            ps = bound
            fn.collectives.append(CollectiveSite(
                name=cname, line=node.lineno, col=node.col_offset + 1,
                guard=self._cur_guard(),
                has_process_set=has_ps,
                sharded=next(
                    (("full" if kw.value.value == "full"
                      else bool(kw.value.value))
                     for kw in node.keywords
                     if kw.arg == "sharded"
                     and isinstance(kw.value, ast.Constant)
                     and kw.value.value),
                    False),
                hierarchical=any(kw.arg == "hierarchical"
                                 and isinstance(kw.value, ast.Constant)
                                 and bool(kw.value.value)
                                 for kw in node.keywords),
                ps=ps))
        elif name in ("update", "apply_gradients"):
            # opt.update(...) on a name bound to DistributedOptimizer(
            # sharded=True) / sharded_optimizer: a synthetic sharded_update
            # site — the schedule pass expands it to the reduce-scatter +
            # allgather sequence the eager pipeline actually submits, so
            # HVD108/HVD109 model the sharded data plane, not an allreduce.
            d = _dotted(node.func)
            head = d.split(".")[0] if d else None
            scopes = [fn.sharded_opt_vars]
            if self.mod.toplevel is not None and fn is not self.mod.toplevel:
                scopes.append(self.mod.toplevel.sharded_opt_vars)
            mode = next((s[head] for s in scopes
                         if head is not None and head in s), False)
            if mode:
                fn.collectives.append(CollectiveSite(
                    name="sharded_update", line=node.lineno,
                    col=node.col_offset + 1, guard=self._cur_guard(),
                    has_process_set=False, sharded=mode))
        ps_kwarg: Optional[ProcessSetValue] = None
        for kw in node.keywords:
            if kw.arg == "process_set":
                ps_kwarg = self._resolve_ps(kw.value)
        callee_expr = _dotted(node.func)
        if ps_kwarg is None and callee_expr:
            head = callee_expr.split(".")[0]
            for scope in self._ps_scopes():
                if head in scope.partial_ps:
                    ps_kwarg = scope.partial_ps[head]
                    break
        fn.calls.append(CallSite(
            callee_expr=callee_expr, line=node.lineno,
            col=node.col_offset + 1, guard=self._cur_guard(),
            ps_kwarg=ps_kwarg))
        # Functions handed to TRANSITION registrars become transition
        # callbacks themselves.  register_reset_callbacks is deliberately
        # not here: reset callbacks run post-re-rendezvous (same reasoning
        # as excluding ``on_reset`` from MID_TRANSITION_CALLBACKS).
        if name in ("register_transition_callbacks", "register_leave_hooks",
                    "register_preempt_hooks", "on_generation_change"):
            for arg in node.args:
                elts = arg.elts if isinstance(arg, (ast.List, ast.Tuple)) \
                    else [arg]
                for e in elts:
                    d = _dotted(e)
                    if d:
                        fn.bindings.setdefault(
                            f"<cb:{d}>", ("callback", d))
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# Build + link
# ---------------------------------------------------------------------------

def build_package(paths: Sequence[str]) -> Package:
    """Parse every ``.py`` under ``paths`` and link the call graph."""
    modules: Dict[str, ModuleInfo] = {}
    all_modules: List[ModuleInfo] = []
    for f in iter_python_files(paths):
        try:
            with open(f, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=f)
        except (OSError, SyntaxError):
            continue                 # per-module lint reports HVD100
        modname = module_name_for(f)
        # An __init__.py IS its package (relative imports resolve against
        # the full dotted name); any other module's package is its parent.
        if os.path.basename(f) == "__init__.py":
            package = modname
        elif "." in modname:
            package = modname.rsplit(".", 1)[0]
        else:
            package = ""
        mod = ModuleInfo(path=os.path.abspath(f), modname=modname,
                         package=package, source=source)
        mod.suppressed = _suppressed_lines(source)
        modules.setdefault(modname, mod)     # resolution map: first wins
        all_modules.append(mod)              # analysis set: every file
        _Collector(mod, tree).visit(tree)

    pkg = Package(modules=modules, functions={}, classes={},
                  all_modules=all_modules)
    for mod in all_modules:
        for fn in mod.all_functions:
            pkg.functions.setdefault(fn.qname, fn)
        for cls in mod.classes.values():
            pkg.classes.setdefault(cls.qname, cls)
    _link(pkg)
    return pkg


def _split_module_prefix(pkg: Package, dotted: str
                         ) -> Tuple[Optional[ModuleInfo], List[str]]:
    """Longest analyzed-module prefix of a dotted path + leftover parts."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        mod = pkg.modules.get(".".join(parts[:i]))
        if mod is not None:
            return mod, parts[i:]
    return None, parts


def _resolve_in_module(pkg: Package, mod: ModuleInfo, parts: List[str],
                       depth: int = 0):
    """Resolve a symbol path inside a module: function, class, alias or
    re-exported import — chased across modules with a depth bound."""
    if depth > 10 or not parts:
        return None
    head, rest = parts[0], parts[1:]
    if not rest:
        if head in mod.functions:
            return mod.functions[head]
        if head in mod.classes:
            return mod.classes[head]
    else:
        cls = mod.classes.get(head)
        if cls is not None:
            return _method_lookup(pkg, cls, rest[0]) if len(rest) == 1 \
                else None
    binding = (mod.toplevel.bindings.get(head)
               if mod.toplevel is not None else None)
    if binding is not None and binding[0] == "alias":
        return _resolve_dotted(pkg, mod, binding[1].split(".") + rest,
                               depth + 1)
    if head in mod.imports:
        target = mod.imports[head].split(".") + rest
        tmod, leftover = _split_module_prefix(pkg, ".".join(target))
        if tmod is not None:
            if not leftover:
                return tmod
            return _resolve_in_module(pkg, tmod, leftover, depth + 1)
    return None


def _resolve_dotted(pkg: Package, mod: ModuleInfo, parts: List[str],
                    depth: int = 0):
    if depth > 10:
        return None
    return _resolve_in_module(pkg, mod, parts, depth)


def _method_lookup(pkg: Package, cls: ClassInfo, method: str,
                   depth: int = 0) -> Optional[FunctionNode]:
    if depth > 5:
        return None
    if method in cls.methods:
        return cls.methods[method]
    for base in cls.bases:
        resolved = _resolve_dotted(pkg, cls.module, base.split("."))
        if isinstance(resolved, ClassInfo):
            found = _method_lookup(pkg, resolved, method, depth + 1)
            if found is not None:
                return found
    return None


def _resolve_call(pkg: Package, fn: FunctionNode, expr: str
                  ) -> Optional[FunctionNode]:
    mod = fn.module
    parts = expr.split(".")
    head = parts[0]

    # self.m(...) / self.attr.m(...)
    if head == "self" and fn.cls:
        cls = mod.classes.get(fn.cls)
        if cls is None:
            return None
        if len(parts) == 2:
            return _method_lookup(pkg, cls, parts[1])
        if len(parts) == 3 and parts[1] in cls.attr_types:
            target = _resolve_dotted(
                pkg, mod, cls.attr_types[parts[1]].split("."))
            if isinstance(target, ClassInfo):
                return _method_lookup(pkg, target, parts[2])
        return None

    # Local binding: alias chain or instance method.
    scopes = [fn.bindings]
    if mod.toplevel is not None and fn is not mod.toplevel:
        scopes.append(mod.toplevel.bindings)
    for bindings in scopes:
        b = bindings.get(head)
        if b is None:
            continue
        kind, target = b
        if kind == "alias":
            resolved = _resolve_dotted(pkg, mod, target.split(".") + parts[1:])
            if isinstance(resolved, FunctionNode):
                return resolved
            if isinstance(resolved, ClassInfo) and len(parts) == 1:
                return _method_lookup(pkg, resolved, "__init__")
        elif kind == "instance" and len(parts) == 2:
            resolved = _resolve_dotted(pkg, mod, target.split("."))
            if isinstance(resolved, ClassInfo):
                return _method_lookup(pkg, resolved, parts[1])
        break

    resolved = _resolve_dotted(pkg, mod, parts)
    if isinstance(resolved, FunctionNode):
        return resolved
    if isinstance(resolved, ClassInfo):
        return _method_lookup(pkg, resolved, "__init__")
    return None


def _link(pkg: Package) -> None:
    for fn in list(pkg.iter_functions()):
        for cs in fn.calls:
            if not cs.callee_expr:
                continue
            target = _resolve_call(pkg, fn, cs.callee_expr)
            if target is not None and target is not fn:
                cs.resolved = target
                target.in_edges += 1
        # Registered callbacks: mark the handed function.
        for key, (kind, target) in list(fn.bindings.items()):
            if kind == "callback":
                resolved = _resolve_call(pkg, fn, target)
                if isinstance(resolved, FunctionNode):
                    resolved.is_callback = True


def reachable(fn: FunctionNode, max_depth: int = 16
              ) -> Iterable[Tuple[FunctionNode, Tuple[CallSite, ...]]]:
    """All functions reachable from ``fn`` through resolved call edges,
    yielded with the (first-found, shortest) call-site chain leading there.
    Bounded BFS; ``fn`` itself is not yielded."""
    seen: Set[str] = {fn.qname}
    frontier: List[Tuple[FunctionNode, Tuple[CallSite, ...]]] = [(fn, ())]
    depth = 0
    while frontier and depth < max_depth:
        nxt: List[Tuple[FunctionNode, Tuple[CallSite, ...]]] = []
        for cur, chain in frontier:
            for cs in cur.calls:
                t = cs.resolved
                if t is None or t.qname in seen:
                    continue
                seen.add(t.qname)
                yield t, chain + (cs,)
                nxt.append((t, chain + (cs,)))
        frontier = nxt
        depth += 1


def _uniform_expr(node: ast.AST, uniform_names: Set[str]) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id == "__name__" or node.id in uniform_names
    if isinstance(node, ast.Call):
        return _call_name(node) in _UNIFORM_CALLS and \
            all(_uniform_expr(a, uniform_names) for a in node.args) and \
            not node.keywords
    if isinstance(node, ast.Compare):
        return _uniform_expr(node.left, uniform_names) and \
            all(_uniform_expr(c, uniform_names) for c in node.comparators)
    if isinstance(node, ast.BoolOp):
        return all(_uniform_expr(v, uniform_names) for v in node.values)
    if isinstance(node, ast.UnaryOp):
        return _uniform_expr(node.operand, uniform_names)
    if isinstance(node, ast.BinOp):
        return _uniform_expr(node.left, uniform_names) and \
            _uniform_expr(node.right, uniform_names)
    return False


def is_uniform_test(test: ast.AST, tainted: Set[str],
                    uniform_names: Optional[Set[str]] = None) -> bool:
    """True when a branch condition is provably identical on every rank
    (HVD108 exemption): built only from constants, ``__name__`` checks,
    world-size-style accessors and names assigned from them
    (``size = hvd.size(); if size >= 2:``).  Rank-divergent tests are
    HVD101's domain and also return True here (already reported there)."""
    if _mentions_rank(test, tainted):
        return True
    return _uniform_expr(test, uniform_names or set())
