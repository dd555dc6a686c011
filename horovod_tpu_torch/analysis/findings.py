# Copied from horovod_tpu/analysis/findings.py:1-339 (jax-free; the port keeps its own copy).
"""Finding model + rule catalog for the collective-correctness analyzer.

The reference devotes C++ runtime machinery (message-table negotiation in
``controller.cc``, the stall inspector — SURVEY.md §L2) to diagnosing ranks
that disagree about collectives.  In the TPU rebuild most of those bugs are
visible in the Python source or the traced jaxpr, so each known failure mode
gets a *rule* here and the three analyzer layers (``collective_lint``,
``trace_check``, ``runtime_sanitizer``) emit :class:`Finding` records
against this shared catalog.

This module and the linter are deliberately jax-free: the lint path only
parses source text, so ``python -m horovod_tpu_torch.analysis`` never executes
user code, initializes the runtime, or touches a device.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def is_package_frame(filename: str) -> bool:
    """True when a stack frame's file belongs to the horovod_tpu_torch package.

    Shared by the ``check=`` hook's caller discovery and the runtime
    sanitizer's call-site attribution.  Matched by path prefix, NOT
    substring — a ``horovod_tpu/...`` frame is user code here, and a user's
    ``~/horovod_tpu_torch/train.py`` too.
    """
    return filename == _PKG_DIR or filename.startswith(_PKG_DIR + os.sep)


class Severity(enum.Enum):
    ERROR = "error"      # will deadlock / corrupt numerics on some worlds
    WARNING = "warning"  # divergence-prone; needs human judgement

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return self.value


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: Severity
    title: str
    rationale: str
    fix_hint: str


# The catalog.  IDs are stable API: suppression comments, allowlists and the
# docs reference them.  1xx = source lint, 2xx = jaxpr trace, 3xx = runtime.
RULES: Dict[str, Rule] = {r.id: r for r in [
    Rule(
        "HVD101", Severity.ERROR,
        "collective under rank-divergent control flow",
        "A collective inside an `if rank() == 0:`-style branch (or after an "
        "early return taken only by some ranks) is submitted by a subset of "
        "ranks; the peers block in negotiation forever and the job wedges "
        "with no diagnostics — the reference's #1 stall-inspector report.",
        "Hoist the collective out of the branch so every rank submits it, "
        "or restrict it to a registered process_set whose members all take "
        "the branch.",
    ),
    Rule(
        "HVD102", Severity.WARNING,
        "collective missing process_set while subgroup sets exist",
        "Once add_process_set() carves subgroups, a collective that omits "
        "process_set= targets the GLOBAL set.  If only the subgroup's ranks "
        "reach the call site, the rest of the world never submits and the "
        "job deadlocks at the readiness threshold.",
        "Pass process_set= explicitly on every collective issued from code "
        "paths only subgroup members execute.",
    ),
    Rule(
        "HVD103", Severity.WARNING,
        "missing broadcast_parameters after init()",
        "Training starts from per-rank random init: without a rank-0 "
        "broadcast of params/optimizer state after init(), ranks average "
        "gradients of DIFFERENT models and silently diverge (reference: "
        "Usage step 4, broadcast_parameters/broadcast_optimizer_state).",
        "Call broadcast_parameters(...) (and broadcast_optimizer_state) "
        "right after init(), or manage state through hvd.elastic state "
        "sync.",
    ),
    Rule(
        "HVD104", Severity.ERROR,
        "collective ordered by set iteration",
        "Python set iteration order is hash-randomized across processes "
        "(PYTHONHASHSEED): each rank submits the collectives in a different "
        "sequence, scrambling fusion-bucket order and pairing different "
        "tensors under one negotiated name — deadlock or silent corruption.",
        "Iterate over sorted(the_set) so every rank submits in one order.",
    ),
    Rule(
        "HVD105", Severity.WARNING,
        "collective ordered by dict iteration",
        "Dict iteration follows insertion order, which drifts across ranks "
        "whenever the dicts were built differently (conditionally inserted "
        "keys, checkpoint-restored vs fresh).  Divergent submission order "
        "scrambles fusion buckets across ranks.",
        "Iterate over sorted(d.items()) — the reference does exactly this "
        "for named_parameters.",
    ),
    Rule(
        "HVD106", Severity.ERROR,
        "host sync/callback inside jit",
        "block_until_ready / io_callback / pure_callback inside a jitted "
        "function forces a host round-trip per step (or traces to a stub): "
        "on multi-process TPU the host sync point can interleave "
        "differently per rank and wedge the collective schedule.",
        "Move host syncs outside the jitted step; use jax.debug.print for "
        "in-graph debugging.",
    ),
    Rule(
        "HVD107", Severity.ERROR,
        "eager engine collective traced under jit",
        "hvd.allreduce()-family eager ops submit to the background engine "
        "at TRACE time, not run time: under jit the collective runs once "
        "during compilation and never again, so ranks diverge after the "
        "first step (and re-traces deadlock peers).",
        "Use the in-graph form (lax.psum / C.allreduce with axis_name "
        "inside shard_map), or call the eager op outside jit.",
    ),
    Rule(
        "HVD108", Severity.WARNING,
        "branch-divergent collective schedule",
        "Two paths through one function emit different collective sequences "
        "(whole-package analysis, call chains included).  Unless the branch "
        "condition is provably identical on every rank, ranks taking "
        "different paths submit different schedules — negotiation wedges at "
        "the readiness threshold or pairs the wrong tensors under one slot. "
        "Horovod-style background negotiation assumes every rank submits "
        "THE SAME schedule; this rule proves it per branch statically.",
        "Make both branches emit the same collective sequence (hoist the "
        "collectives out of the branch), or ensure the condition is "
        "rank-invariant (derived from size()/hyperparameters, not data).",
    ),
    Rule(
        "HVD109", Severity.ERROR,
        "collective reachable from an elastic/churn transition callback",
        "A collective is reachable (through the call graph) from an "
        "elastic-transition handler (on_leave / new_generation / "
        "on_hosts_updated / preemption hooks).  Those callbacks run while "
        "the rank set is MID-TRANSITION: peers may already have left or not "
        "yet joined, so the collective negotiates against a world that is "
        "being torn down — the fleet wedges with no diagnostics.",
        "Defer the collective until after re-rendezvous completes (elastic "
        "state sync on restore), or restrict it to a process_set formed "
        "from the post-transition world.",
    ),
    Rule(
        "HVD110", Severity.ERROR,
        "world-divergent collective data-plane configuration",
        "A sharded= / shard-count / hierarchical= argument of a "
        "collective or a DistributedOptimizer/sharded_optimizer wrapper "
        "is derived from rank identity.  The sharded flag is part of the "
        "negotiation digest and shapes the whole data plane "
        "(reduce-scatter + allgather vs allreduce; 1/N shard layouts); "
        "the hierarchical override rides the fusion key only, but "
        "batching groups entries by fusion key, so divergence still "
        "forks the batch plan: ranks disagreeing submit mismatched "
        "programs — negotiation fails fast at best, or the fleet wedges "
        "mid-collective at worst.",
        "Make the data-plane configuration a fleet-uniform constant "
        "(hyperparameter, HOROVOD_SHARDED_OPTIMIZER / --sharded, "
        "HOROVOD_HIERARCHICAL_ALLREDUCE / HOROVOD_HIER_THRESHOLD), never "
        "a function of rank()/local_rank().",
    ),
    Rule(
        "HVD111", Severity.ERROR,
        "branch-divergent interleaving of overlapping process sets",
        "Two paths through one function submit collectives over two "
        "process sets that share ranks in DIFFERENT interleavings.  Each "
        "set is its own communicator with its own ordered stream, but the "
        "shared ranks execute submissions in program order: rank A holds "
        "set-1's slot while waiting on set-2, rank B holds set-2's slot "
        "while waiting on set-1 — the classic cross-communicator deadlock "
        "(MPI forbids exactly this; Horovod's per-communicator negotiation "
        "cannot detect it because each lane looks self-consistent).",
        "Give the overlapping sets one fixed relative submission order on "
        "every path (hoist the collectives out of the branch), or make "
        "the sets disjoint so their streams cannot entangle.",
    ),
    Rule(
        "HVD112", Severity.ERROR,
        "collective axis absent from its binding mesh/PartitionSpec",
        "A shard_map/in-graph collective names an axis_name (or a "
        "PartitionSpec names an axis) that the binding mesh does not "
        "define — the fsdp-by-tp mismatch.  At best lowering fails; at "
        "worst a differently-built mesh binds the name to a 1-sized axis "
        "and the reduction silently becomes a no-op on every rank.",
        "Use an axis name the binding mesh actually defines (check "
        "make_mesh()/process_set_mesh(axis_name=...) at the shard_map "
        "site), and keep PartitionSpecs within the mesh's axis set.",
    ),
    Rule(
        "HVD113", Severity.ERROR,
        "hard-coded world collective reachable from a process-set-scoped region",
        "Code scoped to a registered process set (helpers called with "
        "process_set=<set>, or functions that take a process_set and use "
        "it) reaches a collective that omits process_set= and therefore "
        "targets the GLOBAL set.  In a multi-tenant world only the set's "
        "members run this region: the world collective waits on ranks "
        "that never arrive (tenant-leak deadlock), and if they DO arrive "
        "it silently mixes tenants' data.",
        "Thread the process_set through to every collective in the scoped "
        "region (forward the parameter), or hoist the deliberate world "
        "sync out of the set-scoped code path.",
    ),
    Rule(
        "HVD114", Severity.WARNING,
        "overlapping process sets interleaved without a dominating order edge",
        "A function alternates submissions between two process sets that "
        "share ranks (set-1, set-2, set-1 ...) with no world-level "
        "barrier establishing a dominating order edge between the lanes.  "
        "Each lane is self-consistent, but nothing orders them against "
        "each other: any rank-dependent scheduling skew (HVD111's dynamic "
        "cousin) can entangle the shared ranks' streams.",
        "Insert hvd.barrier() between the lanes, batch each set's "
        "collectives contiguously, or make the sets disjoint.",
    ),
    Rule(
        "HVD201", Severity.ERROR,
        "collective over unknown mesh axis",
        "A traced lax collective names an axis_name the surrounding mesh "
        "does not bind; under pjit/shard_map this fails at lowering — or "
        "worse, silently reduces over a 1-sized axis on a differently-"
        "built mesh.",
        "Make the collective's axis_name match an axis of the mesh the "
        "step is shard_map'ped over.",
    ),
    Rule(
        "HVD202", Severity.ERROR,
        "axis_index_groups do not partition the axis",
        "psum/all_gather with axis_index_groups that skip or repeat a rank "
        "make the skipped ranks wait on a collective they never joined.",
        "Every rank 0..axis_size-1 must appear in exactly one group.",
    ),
    Rule(
        "HVD203", Severity.WARNING,
        "host callback primitive in traced step",
        "The traced step contains a host callback (io_callback / "
        "pure_callback / debug_callback): per-step host round-trips "
        "serialize the device pipeline and order differently per rank.",
        "Keep callbacks out of the hot step; aggregate on device and "
        "fetch outside.",
    ),
    Rule(
        "HVD204", Severity.ERROR,
        "ppermute permutation is not a bijection over the axis",
        "lax.ppermute with a perm that repeats a source/destination, names "
        "a rank outside the axis, or leaves ranks uncovered makes the "
        "uncovered/over-covered ranks exchange with partners that never "
        "send — the same deadlock shape as bad axis_index_groups (HVD202). "
        "JAX's single-host semantics mask it (missing pairs read zeros); "
        "a multi-host launch wedges.",
        "Make perm a bijection: every rank 0..axis_size-1 appears exactly "
        "once as a source and exactly once as a destination (e.g. a full "
        "ring [(i, (i + 1) % n) for i in range(n)]).",
    ),
    Rule(
        "HVD301", Severity.ERROR,
        "cross-rank collective order/signature divergence",
        "At runtime, ranks submitted different collectives (or the same "
        "ones in different order / from different call sites) under one "
        "negotiated sequence slot.",
        "Inspect the two call sites named in the message; make every rank "
        "issue the same collective sequence.",
    ),
    Rule(
        "HVD302", Severity.WARNING,
        "collective stalled waiting on laggard ranks",
        "A submitted collective has waited past the sanitizer timeout; the "
        "named ranks have not submitted their contribution.",
        "Check the laggard ranks' logs for the branch they took instead; "
        "the ledger tail in this report shows the last calls they made.",
    ),
    Rule(
        "HVD303", Severity.ERROR,
        "control-plane peer failure (dead or unresponsive rank)",
        "The coordinator declared one or more ranks dead — their socket "
        "died (process crash, ECONNRESET) or they missed the per-round "
        "deadline (HOROVOD_ROUND_TIMEOUT_S) — and broadcast a typed ABORT "
        "to the survivors, which surface it as PeerFailureError (or "
        "RoundTimeoutError when this rank's own round deadline expired "
        "without a verdict).  Without this machinery every surviving rank "
        "would block in a deadline-free recv until a human killed the "
        "job.",
        "Check the named ranks' logs for the crash; under the elastic "
        "driver the survivors re-rendezvous automatically — otherwise "
        "restart the job without the dead host.  docs/fault_tolerance.md "
        "covers the knobs.",
    ),
]}


@dataclasses.dataclass
class Finding:
    """One analyzer result, printable as ``path:line:col: ID severity msg``."""
    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: Optional[Severity] = None
    fix_hint: Optional[str] = None
    # Interprocedural provenance (filled by the whole-package passes, used by
    # `lint_gate --explain` and the SARIF `processSet` property).  Appended
    # after the original fields so positional construction stays valid.
    chain: Optional[List[str]] = None          # call path, caller -> site
    process_set: Optional[str] = None          # resolved process-set value(s)
    related: Optional[List[tuple]] = None      # [(path, line)] of involved sites

    def __post_init__(self):
        r = RULES.get(self.rule)
        if self.severity is None:
            self.severity = r.severity if r else Severity.WARNING
        if self.fix_hint is None and r is not None:
            self.fix_hint = r.fix_hint

    @property
    def is_error(self) -> bool:
        return self.severity == Severity.ERROR

    def render(self, show_fix: bool = True) -> str:
        s = f"{self.path}:{self.line}:{self.col}: {self.rule} " \
            f"{self.severity.value}: {self.message}"
        if show_fix and self.fix_hint:
            s += f"\n    fix: {self.fix_hint}"
        return s


def summarize(findings: List[Finding]) -> str:
    errs = sum(1 for f in findings if f.is_error)
    warns = len(findings) - errs
    return f"{len(findings)} finding(s): {errs} error(s), {warns} warning(s)"
