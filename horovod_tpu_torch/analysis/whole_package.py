# Copied from horovod_tpu/analysis/whole_package.py:1-913 (jax-free; the port keeps its own copy).
"""Pass 2 of the whole-package analyzer: interprocedural fact propagation.

Runs on the symbol table + call graph from :mod:`.callgraph` and closes the
gaps per-module lint cannot see:

- **HVD101, interprocedural** — a collective inside a helper that is only
  *called* from a rank-guarded branch (possibly across modules, through
  aliases/partials/methods) is flagged at the collective site with the
  guarded call chain spelled out.  Context-bounded: a helper called from
  both guarded and unguarded sites reports only the guarded path — the
  guard context travels along each chain instead of being merged into the
  callee.
- **HVD102/HVD103, cross-module** — process-set registration and
  initial-broadcast facts are unioned over each entry point's call-graph
  closure.  A training script whose ``broadcast_parameters`` lives in a
  helper module stops false-positiving; one whose ``init()`` and
  ``DistributedOptimizer`` are split across modules starts firing.
- **HVD108** — per entry point, a *collective schedule* (the sequence of
  collectives reachable along each branch) is computed; two paths through
  one function that emit different sequences are flagged unless the branch
  condition is provably rank-invariant.
- **HVD109** — collectives reachable from elastic/churn transition
  callbacks (``on_leave``/``new_generation``/... or functions handed to
  ``register_reset_callbacks``), where the rank set is mid-transition.

``build_static_index`` exports a call-site → static-node map that the
runtime sanitizer (``HVD_TPU_SANITIZER_STATIC_INDEX``) folds into its
ledger reports, so a runtime divergence names the static finding that
would have caught it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .callgraph import (
    CallSite, CollectiveSite, FunctionNode, ModuleInfo, Package,
    ProcessSetValue, build_package, is_uniform_test, proven_overlap,
    reachable,
)
from .collective_lint import (
    _FunctionFacts, _SYNC_CALLS, _TRAINING_WRAPPERS, _mentions_rank,
    lint_file,
)
from .findings import Finding

_MAX_CHAIN = 16          # call-graph propagation depth bound
_MAX_SCHEDULE_DEPTH = 10  # schedule splice depth bound


def _site_events(col: CollectiveSite) -> List:
    """Schedule events a collective site actually submits.

    A ``sharded_update`` site (``opt.update(...)`` on a
    ``DistributedOptimizer(sharded=...)`` / ``sharded_optimizer`` /
    ``full_sharded_optimizer`` binding) schedules the ZeRO pipeline —
    reduce-scatter then allgather, never an allreduce.  Sharded
    collectives carry the ``[sharded]`` / ``[full]`` dimension their
    fusion key / negotiation digest carries: a sharded reduce-scatter and
    an unsharded one of the same shapes are DIFFERENT programs — and the
    FSDP pipeline's legs a third flavour again — so schedules
    comparing them must diverge.

    Every event carries the site's process-set LANE: each
    registered set is its own communicator with its own ordered stream, so
    ``allreduce@evens`` and a world ``allreduce`` are different schedule
    entries — divergence is judged per set, and HVD111 compares the
    cross-lane interleaving of overlapping sets."""
    lane = col.ps.lane
    tag = "full" if col.sharded == "full" else "sharded"
    if col.name == "sharded_update":
        return [("op", f"reducescatter[{tag}]", lane),
                ("op", f"allgather[{tag}]", lane)]
    if col.sharded:
        return [("op", f"{col.name}[{tag}]", lane)]
    if col.hierarchical:
        # Two-level dispatch pin: hierarchical= rides the
        # fusion key (never the digest), so a pinned two-level allreduce
        # and a flat one are different batch plans — a schedule dimension
        # exactly like [sharded].
        return [("op", f"{col.name}[hier]", lane)]
    return [("op", col.name, lane)]


def _suppressed(mod: ModuleInfo, line: int, rule: str) -> bool:
    ids = mod.suppressed.get(line, set())
    return "ALL" in ids or rule in ids


def _chain_str(entry: FunctionNode, chain: Sequence[CallSite],
               target: FunctionNode) -> str:
    hops = [f"{entry.module.base}:{chain[0].line}" if chain else
            entry.module.base]
    for cs in chain[1:]:
        hops.append(f"{cs.callee_expr or '?'}()")
    hops.append(f"{target.name}() [{target.module.base}:{target.lineno}]")
    return " -> ".join(hops)


# ---------------------------------------------------------------------------
# HVD101: rank-guard propagation along the call graph
# ---------------------------------------------------------------------------

def _interprocedural_hvd101(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    best: Dict[Tuple[str, int], Tuple[int, Finding]] = {}
    for fn in pkg.iter_functions():
        for cs in fn.calls:
            if cs.guard is None or cs.resolved is None:
                continue
            # BFS from the guarded callee; the guard context belongs to
            # THIS chain only (bounded context-sensitivity): other call
            # sites of the same helper stay unguarded.
            targets = [(cs.resolved, (cs,))]
            targets += [(t, (cs,) + chain)
                        for t, chain in reachable(cs.resolved,
                                                  max_depth=_MAX_CHAIN)]
            for target, chain in targets:
                for col in target.collectives:
                    if col.guard is not None:
                        continue        # already flagged intra-procedurally
                    if _suppressed(target.module, col.line, "HVD101") or \
                            _suppressed(fn.module, cs.line, "HVD101"):
                        continue
                    key = (target.module.path, col.line)
                    f = Finding(
                        rule="HVD101", path=target.module.path,
                        line=col.line, col=col.col,
                        message=(
                            f"collective {col.name!r} is only reached "
                            f"through a rank-guarded call chain "
                            f"({cs.guard.describe(fn.module.base)}): "
                            f"{_chain_str(fn, chain, target)} — only a "
                            f"subset of ranks submits it, the rest of the "
                            f"world blocks in negotiation"))
                    prev = best.get(key)
                    if prev is None or len(chain) < prev[0]:
                        best[key] = (len(chain), f)
    findings.extend(f for _, f in best.values())
    return findings


# ---------------------------------------------------------------------------
# HVD102/HVD103: entry-closure fact flow
# ---------------------------------------------------------------------------

def _entry_roots(mod: ModuleInfo) -> List[FunctionNode]:
    """Closure roots of a module: its top level plus every function defined
    in it that no analyzed code calls (externally invokable — ``main()``
    behind an ``if __name__`` block, CLI handlers, callbacks)."""
    roots = [mod.toplevel] if mod.toplevel is not None else []
    roots += [fn for fn in mod.all_functions
              if fn is not mod.toplevel and fn.in_edges == 0]
    return roots


def _closure(mod: ModuleInfo) -> List[FunctionNode]:
    out: List[FunctionNode] = []
    seen: Set[str] = set()
    for root in _entry_roots(mod):
        if root.qname not in seen:
            seen.add(root.qname)
            out.append(root)
        for t, _chain in reachable(root, max_depth=_MAX_CHAIN):
            if t.qname not in seen:
                seen.add(t.qname)
                out.append(t)
    return out


def _closure_facts_hvd102_103(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    for mod in pkg.all_modules:
        closure = _closure(mod)
        names: Set[str] = set()
        elastic = False
        for fn in closure:
            names |= fn.called_names
            elastic = elastic or fn.uses_elastic_state

        # HVD103 over the closure: init + gradient reduction anywhere in
        # reach, no state sync anywhere in reach.
        if "init" in names and (names & _TRAINING_WRAPPERS) \
                and not (names & _SYNC_CALLS) and not elastic:
            line = mod.first_training_line or mod.init_line or 1
            if not _suppressed(mod, line, "HVD103"):
                findings.append(Finding(
                    rule="HVD103", path=mod.path, line=line, col=1,
                    message=(
                        "entry point calls init() and reduces gradients "
                        "(directly or through its call-graph closure) but "
                        "never broadcasts initial state from rank 0; ranks "
                        "train divergent models")))

        # HVD102 cross-module: the closure registers subgroup process sets
        # somewhere, and THIS module's own code submits bare collectives.
        # (Same-module registration is per-module lint's job — skip it to
        # avoid duplicate findings.)
        own_names: Set[str] = set()
        for fn in mod.all_functions:
            own_names |= fn.called_names
        if "add_process_set" in names and "add_process_set" not in own_names:
            for fn in mod.all_functions:
                for col in fn.collectives:
                    if col.has_process_set or \
                            _suppressed(mod, col.line, "HVD102"):
                        continue
                    findings.append(Finding(
                        rule="HVD102", path=mod.path, line=col.line,
                        col=col.col,
                        message=(
                            f"collective {col.name!r} omits process_set= "
                            f"while this entry point's call-graph closure "
                            f"registers subgroup process sets (in another "
                            f"module); it targets the GLOBAL set — a "
                            f"deadlock if only subgroup members reach "
                            f"this call")))
    return findings


# ---------------------------------------------------------------------------
# HVD108: collective schedules per branch
# ---------------------------------------------------------------------------

def _terminates(stmts) -> bool:
    """A statement list that definitely leaves the enclosing suite."""
    import ast
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _schedule_stmts(stmts, fn: FunctionNode, pkg: Package, memo, stack,
                    divergences, depth: int, collect: bool):
    """Schedule of a statement list.  ``collect`` gates divergence
    recording so each function's If nodes are reported once (when the
    function itself is analyzed), not re-reported at every splice site."""
    import ast
    seq: List = []
    calls_by_line: Dict[Tuple[int, int], FunctionNode] = {}
    for cs in fn.calls:
        if cs.resolved is not None:
            calls_by_line[(cs.line, cs.col)] = cs.resolved
    cols_by_line: Dict[Tuple[int, int], CollectiveSite] = {
        (c.line, c.col): c for c in fn.collectives}

    def expr_events(node) -> List:
        # Post-order: a call's arguments are evaluated (and their
        # collectives submitted) BEFORE the call itself completes, so
        # hvd.allgather(helper(x)) must record helper's ops first.
        ev: List = []

        def rec(n):
            for child in ast.iter_child_nodes(n):
                rec(child)
            if not isinstance(n, ast.Call):
                return
            key = (n.lineno, n.col_offset + 1)
            col = cols_by_line.get(key)
            if col is not None:
                ev.extend(_site_events(col))
                return
            target = calls_by_line.get(key)
            if target is not None:
                spliced = _schedule_of(target, pkg, memo, stack, depth + 1)
                if spliced is not None:
                    ev.append(spliced)

        rec(node)
        return [e for e in ev if e not in (("seq",), None)]

    def sub_sched(sub_stmts):
        return _schedule_stmts(sub_stmts, fn, pkg, memo, stack,
                               divergences, depth, collect)

    tainted = _fn_tainted(fn)
    i, n = 0, len(stmts)
    while i < n:
        stmt = stmts[i]
        i += 1
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue                       # defs don't run at the def site
        if isinstance(stmt, ast.If):
            seq.extend(expr_events(stmt.test))
            body_t, or_t = _terminates(stmt.body), _terminates(stmt.orelse)
            if (body_t or or_t) and i < n:
                # Guard-clause folding: a terminating arm's real
                # alternative is the FALL-THROUGH code, not the lexical
                # orelse — `if fast: return coll(x)` vs the rest of the
                # function compare as two complete paths.
                rest = stmts[i:]
                a = _prune(sub_sched(
                    list(stmt.body) + ([] if body_t else rest)))
                b = _prune(sub_sched(
                    list(stmt.orelse) + ([] if or_t else rest)))
                i = n                      # rest is folded into the arms
            else:
                a = _prune(sub_sched(stmt.body))
                b = _prune(sub_sched(stmt.orelse))
            if a == b:
                if a is not None:
                    seq.append(a)
            else:
                if collect:
                    # Classify the divergence: rank-divergent tests are
                    # HVD101's domain (so HVD108 skips them) but they ARE
                    # the classic cross-communicator interleaving (HVD111
                    # judges both kinds); provably-uniform tests diverge
                    # for no rank at all.
                    if _mentions_rank(stmt.test, tainted):
                        divergences.append((fn, stmt.lineno, a, b, "rank"))
                    elif not is_uniform_test(stmt.test, tainted,
                                             _fn_uniform_names(fn)):
                        divergences.append((fn, stmt.lineno, a, b, "data"))
                seq.append(("branch", a or ("seq",), b or ("seq",)))
        elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            if isinstance(stmt, ast.While):
                seq.extend(expr_events(stmt.test))
            else:
                seq.extend(expr_events(stmt.iter))
            body = _schedule_stmts(stmt.body, fn, pkg, memo, stack,
                                   divergences, depth, collect)
            if len(body) > 1:
                seq.append(("loop", body))
            seq.extend(_schedule_stmts(stmt.orelse, fn, pkg, memo, stack,
                                       divergences, depth, collect)[1:])
        elif isinstance(stmt, ast.Try):
            seq.extend(_schedule_stmts(stmt.body, fn, pkg, memo, stack,
                                       divergences, depth, collect)[1:])
            # handlers model exceptional divergence — deliberately ignored
            seq.extend(_schedule_stmts(stmt.finalbody, fn, pkg, memo, stack,
                                       divergences, depth, collect)[1:])
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                seq.extend(expr_events(item.context_expr))
            seq.extend(_schedule_stmts(stmt.body, fn, pkg, memo, stack,
                                       divergences, depth, collect)[1:])
        else:
            seq.extend(expr_events(stmt))
    return tuple(["seq"] + seq)


def _prune(sched):
    """Normalize a schedule: drop every structural node (seq/branch/loop)
    that contains no collective op anywhere beneath it, and flatten nested
    sequences — so two branches that differ only in collective-free
    structure compare EQUAL (both prune to None).  Cycle markers prune
    away too: an unexpanded recursive call contributes no known ops."""
    if not isinstance(sched, tuple) or not sched:
        return None
    tag = sched[0]
    if tag == "op":
        return sched
    if tag == "seq":
        flat: List = []
        for item in sched[1:]:
            p = _prune(item)
            if p is None:
                continue
            if isinstance(p, tuple) and p and p[0] == "seq":
                flat.extend(p[1:])
            else:
                flat.append(p)
        return tuple(["seq"] + flat) if flat else None
    if tag == "branch":
        a, b = _prune(sched[1]), _prune(sched[2])
        if a is None and b is None:
            return None
        if a == b:
            return a
        return ("branch", a or ("seq",), b or ("seq",))
    if tag == "loop":
        body = _prune(sched[1])
        return None if body is None else ("loop", body)
    return None        # "cycle" and anything unknown


def _fn_tainted(fn: FunctionNode) -> Set[str]:
    cached = getattr(fn, "_tainted", None)
    if cached is None:
        facts = _FunctionFacts()
        if fn.node is not None:
            facts.visit(fn.node)
        cached = fn._tainted = facts.tainted
    return cached


def _fn_uniform_names(fn: FunctionNode) -> Set[str]:
    """Names assigned from world-size-style accessors — rank-invariant by
    construction, so branches on them don't diverge the schedule."""
    from .callgraph import _UNIFORM_CALLS
    cached = getattr(fn, "_uniform_names", None)
    if cached is None:
        facts = _FunctionFacts(source_calls=_UNIFORM_CALLS)
        if fn.node is not None:
            facts.visit(fn.node)
        cached = fn._uniform_names = facts.tainted
    return cached


# Reserved memo key counting cycle/depth truncations ("::" can't appear in
# a function qname, so it never collides with one).
_TRUNCATED = "::truncated::"


def _schedule_of(fn: FunctionNode, pkg: Package, memo, stack,
                 depth: int = 0):
    """Context-insensitive schedule summary of a function.

    Memoized ONLY when the computation was not truncated by a cycle or the
    depth bound: a truncated schedule depends on what was on the recursion
    stack at the time, and caching it would silently hide collectives in
    every later (non-cyclic) context — suppressing real HVD108 findings.
    """
    if fn.qname in memo:
        return memo[fn.qname]
    if fn.qname in stack or depth > _MAX_SCHEDULE_DEPTH:
        memo[_TRUNCATED] = memo.get(_TRUNCATED, 0) + 1
        return ("cycle", fn.qname)
    if fn.node is None:
        return ("seq",)
    import ast
    body = fn.node.body if isinstance(
        fn.node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)) else []
    stack = stack | {fn.qname}
    before = memo.get(_TRUNCATED, 0)
    sched = _prune(_schedule_stmts(body, fn, pkg, memo, stack, [], depth,
                                   collect=False))
    if memo.get(_TRUNCATED, 0) == before:
        memo[fn.qname] = sched         # context-free: safe to reuse
    return sched


def _render_schedule(sched, limit: int = 6) -> str:
    if sched is None:
        return "(no collectives)"
    ops: List[str] = []

    def walk(node):
        if not isinstance(node, tuple) or not node:
            return
        if node[0] == "op":
            lane = node[2] if len(node) > 2 else "world"
            ops.append(node[1] if lane == "world"
                       else f"{node[1]}@{lane}")
        elif node[0] == "seq":
            for item in node[1:]:
                walk(item)
        elif node[0] == "branch":
            ops.append("{" + _render_schedule(node[1], limit) + " | "
                       + _render_schedule(node[2], limit) + "}")
        elif node[0] == "loop":
            ops.append("loop[" + _render_schedule(node[1], limit) + "]")
        elif node[0] == "cycle":
            ops.append("…")

    walk(sched)
    if not ops:
        return "(no collectives)"
    if len(ops) > limit:
        ops = ops[:limit] + ["…"]
    return ", ".join(ops)


def _collect_divergences(pkg: Package) -> List:
    """All branch divergences in the package as ``(fn, line, a, b, kind)``
    with kind ``"data"`` (HVD108's domain) or ``"rank"`` (HVD101's domain,
    but HVD111-eligible: a rank-divergent branch is exactly how ranks end
    up submitting different cross-set interleavings)."""
    import ast
    memo: Dict = {}
    divergences: List = []
    for fn in pkg.iter_functions():
        if fn.node is None:
            continue
        body = fn.node.body if isinstance(
            fn.node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)) \
            else []
        _schedule_stmts(body, fn, pkg, memo, {fn.qname}, divergences, 0,
                        collect=True)
    return divergences


def _schedule_hvd108(divergences: List) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for owner, line, a, b, kind in divergences:
        if kind != "data":
            continue
        key = (owner.module.path, line)
        if key in seen or _suppressed(owner.module, line, "HVD108"):
            continue
        seen.add(key)
        findings.append(Finding(
            rule="HVD108", path=owner.module.path, line=line, col=1,
            message=(
                f"the if/else branches at line {line} of "
                f"{owner.name}() emit different collective schedules: "
                f"[{_render_schedule(a)}] vs [{_render_schedule(b)}] — "
                f"ranks taking different branches negotiate different "
                f"sequences")))
    return findings


# ---------------------------------------------------------------------------
# HVD111: branch-divergent interleaving of overlapping process sets
# ---------------------------------------------------------------------------

def _flat_ops(sched) -> List[Tuple[str, str]]:
    """Flatten a schedule to its ``(op, lane)`` submission stream.  Branch
    arms are included in order (a then b) — deterministic, and identical
    sub-branches contribute identically to both outer arms."""
    out: List[Tuple[str, str]] = []

    def walk(node):
        if not isinstance(node, tuple) or not node:
            return
        if node[0] == "op":
            out.append((node[1], node[2] if len(node) > 2 else "world"))
        elif node[0] in ("seq", "branch"):
            for item in node[1:]:
                walk(item)
        elif node[0] == "loop":
            walk(node[1])

    walk(sched)
    return out


def _lane_values(pkg: Package) -> Dict[str, ProcessSetValue]:
    vals: Dict[str, ProcessSetValue] = {}
    for fn in pkg.iter_functions():
        for col in fn.collectives:
            vals.setdefault(col.ps.lane, col.ps)
    return vals


def _schedule_hvd111(divergences: List, pkg: Package) -> List[Finding]:
    """The cross-communicator deadlock: two branch arms interleave
    collectives over two PROVEN-overlapping process sets differently.
    Each set's own lane can even be self-consistent — but the shared
    ranks execute submissions in program order, so arm A holds set-1's
    slot while waiting on set-2 and arm B the reverse."""
    import itertools
    lane_vals = _lane_values(pkg)
    findings: List[Finding] = []
    seen: Set[Tuple] = set()
    for owner, line, a, b, _kind in divergences:
        fa, fb = _flat_ops(a), _flat_ops(b)
        lanes = sorted({lane for _, lane in fa + fb})
        for l1, l2 in itertools.combinations(lanes, 2):
            v1, v2 = lane_vals.get(l1), lane_vals.get(l2)
            if v1 is None or v2 is None or not proven_overlap(v1, v2):
                continue
            pa = [(op, ln) for op, ln in fa if ln in (l1, l2)]
            pb = [(op, ln) for op, ln in fb if ln in (l1, l2)]
            if pa == pb or not pa or not pb:
                continue
            # An actual interleaving requires one arm to touch BOTH lanes;
            # one-sided pairs are HVD101/HVD108's territory.
            if not any({ln for _, ln in p} == {l1, l2} for p in (pa, pb)):
                continue
            key = (owner.module.path, line, l1, l2)
            if key in seen or _suppressed(owner.module, line, "HVD111"):
                continue
            seen.add(key)
            related = [(owner.module.path, c.line)
                       for c in owner.collectives if c.ps.lane in (l1, l2)]

            def _fmt(p):
                return ", ".join(op if ln == "world" else f"{op}@{ln}"
                                 for op, ln in p)

            findings.append(Finding(
                rule="HVD111", path=owner.module.path, line=line, col=1,
                message=(
                    f"the branches at line {line} of {owner.name}() submit "
                    f"collectives over OVERLAPPING process sets "
                    f"({v1.describe()} and {v2.describe()}) in different "
                    f"interleavings: [{_fmt(pa)}] vs [{_fmt(pb)}] — ranks "
                    f"shared by both sets hold one communicator's slot "
                    f"while waiting on the other: cross-communicator "
                    f"deadlock"),
                process_set=f"{v1.lane} | {v2.lane}",
                related=related or None))
    return findings


# ---------------------------------------------------------------------------
# HVD113: world collective reachable from a process-set-scoped region
# ---------------------------------------------------------------------------

def _is_bare_world(col: CollectiveSite) -> bool:
    return not col.has_process_set and col.ps.kind == "world"


def _hvd113(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    best: Dict[Tuple[str, int], Tuple[int, Finding]] = {}

    # (a) Interprocedural: a call site binds a concrete registered set into
    # a helper (process_set=<named>, directly or pinned via partial) whose
    # closure contains hard-coded world collectives.  Callees that FORWARD
    # a process_set to a site don't trip it — that's the clean pattern.
    for fn in pkg.iter_functions():
        for cs in fn.calls:
            v = cs.ps_kwarg
            if v is None or v.kind != "named" or cs.resolved is None:
                continue
            targets = [(cs.resolved, (cs,))]
            targets += [(t, (cs,) + chain)
                        for t, chain in reachable(cs.resolved,
                                                  max_depth=_MAX_CHAIN)]
            for target, chain in targets:
                for col in target.collectives:
                    if not _is_bare_world(col):
                        continue
                    if _suppressed(target.module, col.line, "HVD113") or \
                            _suppressed(fn.module, cs.line, "HVD113"):
                        continue
                    key = (target.module.path, col.line)
                    f = Finding(
                        rule="HVD113", path=target.module.path,
                        line=col.line, col=col.col,
                        message=(
                            f"collective {col.name!r} hard-codes the WORLD "
                            f"set but is reached from a region scoped to "
                            f"{v.describe()} "
                            f"(process_set= bound at {fn.module.base}:"
                            f"{cs.line}, {_chain_str(fn, chain, target)}) "
                            f"— only the set's members run this region, "
                            f"so the world collective waits on ranks that "
                            f"never arrive (tenant-leak)"),
                        chain=[_chain_str(fn, chain, target)],
                        process_set=v.lane,
                        related=[(fn.module.path, cs.line)])
                    prev = best.get(key)
                    if prev is None or len(chain) < prev[0]:
                        best[key] = (len(chain), f)
    findings.extend(f for _, f in best.values())

    # (b) Intra-function: a helper that takes a process set and scopes at
    # least one collective with it (``process_set=<param>``, or forwarding
    # the param positionally) leaks if another collective in the same body
    # silently targets the world.
    for fn in pkg.iter_functions():
        scoped = [c for c in fn.collectives if c.ps.kind == "param"]
        if not scoped:
            continue
        for col in fn.collectives:
            if not _is_bare_world(col):
                continue
            if _suppressed(fn.module, col.line, "HVD113"):
                continue
            key = (fn.module.path, col.line)
            if key in best:
                continue
            v = scoped[0].ps
            findings.append(Finding(
                rule="HVD113", path=fn.module.path, line=col.line,
                col=col.col,
                message=(
                    f"collective {col.name!r} hard-codes the WORLD set "
                    f"inside {fn.name}(), which scopes its other "
                    f"collectives to {v.describe()} — when a caller binds "
                    f"a subgroup, only its members reach this line and "
                    f"the world collective deadlocks (tenant-leak)"),
                process_set=v.lane,
                related=[(fn.module.path, c.line) for c in scoped]))
    return findings


# ---------------------------------------------------------------------------
# HVD114: overlapping sets interleaved with no dominating order edge
# ---------------------------------------------------------------------------

def _suite_streams(fn: FunctionNode):
    """Yield ``(stream, in_loop)`` per straight-line suite of ``fn``:
    the function body, each branch arm, each loop/try/with body — WITHOUT
    mixing arms of one If into a single stream (they never execute
    together).  ``stream`` is the suite's direct collective sites in
    source order (nested control-flow suites are yielded separately)."""
    import ast
    if fn.node is None:
        return
    by_pos = {(c.line, c.col): c for c in fn.collectives}

    def direct_sites(stmt) -> List[CollectiveSite]:
        out = []
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                col = by_pos.get((n.lineno, n.col_offset + 1))
                if col is not None:
                    out.append(col)
        return sorted(out, key=lambda c: (c.line, c.col))

    def suites(body, in_loop):
        stream: List[CollectiveSite] = []
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                stream.extend(direct_sites(stmt.test))
                yield from suites(stmt.body, in_loop)
                yield from suites(stmt.orelse, in_loop)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                yield from suites(stmt.body, True)
                yield from suites(stmt.orelse, in_loop)
            elif isinstance(stmt, ast.Try):
                yield from suites(stmt.body, in_loop)
                for h in stmt.handlers:
                    yield from suites(h.body, in_loop)
                yield from suites(stmt.orelse, in_loop)
                yield from suites(stmt.finalbody, in_loop)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from suites(stmt.body, in_loop)
            else:
                stream.extend(direct_sites(stmt))
        yield stream, in_loop

    body = fn.node.body if isinstance(
        fn.node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)) \
        else []
    yield from suites(body, False)


def _is_order_edge(col: CollectiveSite) -> bool:
    """A world-level barrier (or world synchronize) between two lanes
    dominates both sets' streams: everything before it on every member
    rank completes before anything after — the order edge HVD114 wants."""
    return col.ps.kind == "world" and (
        "barrier" in col.name or col.name == "synchronize")


def _hvd114(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()

    def emit(fn, site, a: CollectiveSite, b: CollectiveSite, looped: bool):
        key = (fn.module.path, site.line)
        if key in seen or _suppressed(fn.module, site.line, "HVD114"):
            return
        seen.add(key)
        findings.append(Finding(
            rule="HVD114", path=fn.module.path, line=site.line,
            col=site.col,
            message=(
                f"{fn.name}() alternates submissions between overlapping "
                f"process sets ({a.ps.describe()} and {b.ps.describe()}"
                + (", across loop iterations" if looped else "")
                + ") with no world barrier between the lanes — nothing "
                  "establishes a dominating order edge, so scheduling "
                  "skew on the shared ranks can entangle the two "
                  "streams"),
            process_set=f"{a.ps.lane} | {b.ps.lane}"))

    for fn in pkg.iter_functions():
        for stream, in_loop in _suite_streams(fn):
            n = len(stream)
            if n < 2:
                continue
            # Straight-line alternation A ... B ... A with no world
            # barrier anywhere between the first and last leg.
            for k in range(n):
                ck = stream[k]
                if _is_order_edge(ck):
                    continue
                for j in range(k):
                    cj = stream[j]
                    if cj.ps.lane == ck.ps.lane or \
                            not proven_overlap(cj.ps, ck.ps):
                        continue
                    for i in range(j):
                        ci = stream[i]
                        if ci.ps.lane != ck.ps.lane or _is_order_edge(ci):
                            continue
                        if any(_is_order_edge(c)
                               for c in stream[i + 1:k]):
                            continue
                        emit(fn, ck, cj, ck, looped=False)
                        break
            # A loop body touching two overlapping lanes alternates by
            # construction (iteration N's tail meets iteration N+1's
            # head) unless an order edge sits somewhere in the body.
            if in_loop and not any(_is_order_edge(c) for c in stream):
                for j in range(n):
                    for i in range(j):
                        if stream[i].ps.lane != stream[j].ps.lane and \
                                proven_overlap(stream[i].ps,
                                               stream[j].ps):
                            emit(fn, stream[j], stream[i], stream[j],
                                 looped=True)
    return findings


# ---------------------------------------------------------------------------
# HVD109: collectives reachable from transition callbacks
# ---------------------------------------------------------------------------

def _callback_hvd109(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for fn in pkg.iter_functions():
        if not fn.is_callback:
            continue
        targets: List[Tuple[FunctionNode, Tuple[CallSite, ...]]] = \
            [(fn, ())] + list(reachable(fn, max_depth=_MAX_CHAIN))
        for target, chain in targets:
            for col in target.collectives:
                key = (target.module.path, col.line)
                if key in seen or \
                        _suppressed(target.module, col.line, "HVD109"):
                    continue
                seen.add(key)
                tag = "full" if col.sharded == "full" else "sharded"
                what = (f"sharded optimizer update (schedules "
                        f"reducescatter[{tag}] + allgather[{tag}])"
                        if col.name == "sharded_update" else
                        f"collective {col.name!r}")
                if col.ps.kind != "world":
                    what += f" over {col.ps.describe()}"
                findings.append(Finding(
                    rule="HVD109", path=target.module.path, line=col.line,
                    col=col.col,
                    message=(
                        f"{what} is reachable from "
                        f"elastic-transition callback {fn.name!r} "
                        f"({fn.module.base}:{fn.lineno}"
                        + (f", via {_chain_str(fn, chain, target)}"
                           if chain else "")
                        + ") — the rank set is mid-transition there; "
                          "peers may already have left")))
    return findings


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def analyze_package(paths: Sequence[str],
                    package: Optional[Package] = None) -> List[Finding]:
    """Whole-package analysis: per-module lint + interprocedural passes.

    Returns findings sorted by (path, line, rule).  Per-module HVD103
    findings refuted by cross-module facts (the broadcast lives in a
    helper module) are dropped — whole-package mode is strictly more
    precise in both directions.
    """
    pkg = package or build_package(paths)
    findings: List[Finding] = []
    from .collective_lint import iter_python_files, lint_source
    by_path = {m.path: m for m in pkg.all_modules}
    for f in iter_python_files(paths):
        ap = os.path.abspath(f)
        mod = by_path.get(ap)
        # Pass 1 already read+parsed every parseable module — lint its
        # retained source instead of re-reading; files pass 1 skipped
        # (syntax errors) still go through lint_file for their HVD100.
        per_module = lint_source(mod.source, ap) if mod is not None \
            else lint_file(f)
        for finding in per_module:
            if finding.rule == "HVD103":
                continue    # recomputed over closures below, both verdicts
            finding.path = os.path.abspath(finding.path)
            findings.append(finding)
    findings += _interprocedural_hvd101(pkg)
    findings += _closure_facts_hvd102_103(pkg)
    divergences = _collect_divergences(pkg)
    findings += _schedule_hvd108(divergences)
    findings += _schedule_hvd111(divergences, pkg)
    findings += _hvd113(pkg)
    findings += _hvd114(pkg)
    findings += _callback_hvd109(pkg)
    uniq: Dict[Tuple[str, str, int, int], Finding] = {}
    for f in findings:
        uniq.setdefault((f.rule, os.path.abspath(f.path), f.line, f.col), f)
    return sorted(uniq.values(), key=lambda f: (f.path, f.line, f.col,
                                                f.rule))


def build_static_index(paths: Sequence[str],
                       package: Optional[Package] = None,
                       findings: Optional[List[Finding]] = None) -> Dict:
    """Map ``basename:line`` call sites → static call-graph nodes + the
    rules flagged there.  The runtime sanitizer keys its ledger sites the
    same way (``HVD_TPU_SANITIZER_STATIC_INDEX``), so a runtime divergence
    report can name the static finding that would have caught it."""
    pkg = package or build_package(paths)
    if findings is None:
        findings = analyze_package(paths, package=pkg)
    rules_by_site: Dict[str, List[str]] = {}
    for f in findings:
        anchors = [(f.path, f.line)] + list(f.related or [])
        for path, line in anchors:
            site = f"{os.path.basename(path)}:{line}"
            rules = rules_by_site.setdefault(site, [])
            if f.rule not in rules:
                rules.append(f.rule)
    sites: Dict[str, Dict] = {}
    for fn in pkg.iter_functions():
        for i, col in enumerate(fn.collectives):
            site = f"{fn.module.base}:{col.line}"
            sites[site] = {
                "node": fn.qname,
                "op": col.name,
                "index": i,
                "guarded": col.guard is not None,
                "process_set": col.ps.lane,
                "rules": rules_by_site.get(site, []),
            }
    return {"version": 1, "sites": sites}
