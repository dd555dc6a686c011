# Ported from horovod_tpu/analysis/trace_check.py:1-328 (CollectiveRecord
# :51-66, TraceReport :69-77, _check_ppermute :121-176 and compare_ledgers
# :299-328 copied; the jaxpr walk :179-243 and check_step_fn :246-296 are a
# torch.fx walk here).
"""Trace-level collective checker (rules HVD201, HVD203, HVD204, HVD112).

The static analogue of the controller's negotiation in
``common/controller.py``: trace a per-rank step function (under its real
mesh or an :class:`AbstractMesh` stand-in) and build a **collective
ledger** — the ordered sequence of (primitive, axes, shape, dtype) every
rank will execute.  The JAX package walks the step's jaxpr; here the step
is traced with ``torch.fx.experimental.proxy_tensor.make_fx(fn,
tracing_mode="fake")`` and the walk runs over the ``torch.fx`` graph:

- while the trace runs, the mesh's collectives (``parallel/mesh.py``
  ``psum``, ``ppermute``, ``send_recv``, ``all_to_all``, ``all_gather``,
  and so the ``.apply`` of ``PPermute``, ``AllToAll``, ``ReduceOutput`` and
  ``CopyInput``) hand their call to a recorder instead of moving data.  It
  emits an ``hvd_audit`` operator (``hvd_audit.psum`` ...), whose fake
  implementation returns a stand-in of the output's shape: the node that
  the walk reads, with its axis (and a ppermute's permutation) as
  arguments and its input's shape and dtype in ``meta["val"]``;
- the flash entry points return stand-ins for fake CUDA tensors
  (``ops/flash_attention.py``), so no fake tensor reaches a launch;
- nothing executes: the inputs become fake tensors, no kernel launches and
  no ``torch.distributed`` call is made, and no world is needed
  (``axis_sizes=`` binds the axes, as the JAX abstract mesh does).

The ledger has the JAX record: primitive ``psum`` / ``ppermute`` /
``all_to_all`` / ``all_gather``, named axes, per-rank shapes and numpy
dtype names, so :func:`compare_ledgers` holds a port step against the JAX
one.  The checks:

- HVD201: a collective names an axis neither the mesh nor ``axis_sizes``
  binds;
- HVD204: a ``ppermute`` whose perm is not a bijection over the axis.
  ``send_recv`` is one hop of a rotation without its wrap: both ends skip
  the hop off the end, decided alike from the tick, so it is recorded as
  the rotation it is a part of (``ppermute`` with the full ring);
- HVD112: with ``partition_axes=``, a collective over a bound axis the
  step's specs never split over (the fsdp × tp mismatch);
- HVD203: a host sync inside the step — ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()`` — which serializes the card's queue and orders
  differently per rank (the JAX rule's host callbacks).

HVD202 (``axis_index_groups``) has no spelling in the port: a mesh
collective runs over its whole axis group.

A step whose optimizer updates the parameters in place cannot be traced
whole (the optimizer holds the real tensors, and a
``DistributedOptimizer``'s hooks submit to the engine): audit the per-rank
loss and gradients instead, which is what the JAX check sees inside
``shard_map`` (``models/llama.py``'s step carries them as ``step.audit``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding, Severity

# Host syncs inside a traced step (HVD203).
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One traced collective: the static twin of the controller digest."""
    index: int
    primitive: str
    axes: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    axis_index_groups: Optional[Tuple[Tuple[int, ...], ...]] = None

    def digest(self) -> str:
        """Signature string, comparable across ranks/versions — the same
        role the controller's ``_digest`` plays on the wire."""
        return "|".join([self.primitive, ",".join(self.axes),
                         str(self.shapes), str(self.dtypes),
                         str(self.axis_index_groups)])


@dataclasses.dataclass
class TraceReport:
    ledger: List[CollectiveRecord]
    findings: List[Finding]
    bound_axes: Dict[str, int]

    @property
    def ok(self) -> bool:
        return not any(f.is_error for f in self.findings)


# ------------------------------------------------------------ stand-in mesh
class AbstractMesh:
    """A mesh without a world: the axes, their sizes and this rank's
    coordinates (0 by default), with no process group behind them — what
    a step needs to be traced (``ProcessMesh``'s ``axis_names``,
    ``shape``, ``axis``, ``size``, ``index``), for an audit only."""

    def __init__(self, axis_sizes: Dict[str, int],
                 coords: Optional[Dict[str, int]] = None):
        from ..parallel.mesh import MeshAxis
        self._names = tuple(axis_sizes)
        coords = coords or {}
        self._axes = {a: MeshAxis(a, int(n), int(coords.get(a, 0)),
                                  tuple(range(int(n))))
                      for a, n in axis_sizes.items()}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self._names

    @property
    def shape(self) -> Dict[str, int]:
        return {a: self._axes[a].size for a in self._names}

    def axis(self, name: str):
        from ..parallel.mesh import require_axis
        return self._axes[require_axis(self, name)]

    def size(self, name: str) -> int:
        return self.axis(name).size

    def index(self, name: str) -> int:
        return self.axis(name).index

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


# -------------------------------------------------------- audit operators
_LIB = None
_LIB_LOCK = threading.Lock()


def _define_ops():
    """Define the ``hvd_audit`` operators once: each a node of the traced
    graph that carries its axis (and a ppermute's permutation), with a
    fake implementation that gives the output's shape."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return
        import torch
        lib = torch.library.Library("hvd_audit", "DEF")
        lib.define("psum(Tensor x, str axis) -> Tensor")
        lib.define("ppermute(Tensor x, str axis, int[] src, int[] dst) "
                   "-> Tensor")
        lib.define("all_to_all(Tensor x, str axis, int size, int split_dim, "
                   "int concat_dim) -> Tensor")
        lib.define("all_gather(Tensor x, str axis, int size, int dim) "
                   "-> Tensor")

        def same(x, *_):
            return torch.empty_like(x)

        def a2a(x, axis, size, split_dim, concat_dim):
            shape = list(x.shape)
            shape[split_dim] //= size
            shape[concat_dim] *= size
            return x.new_empty(shape)

        def gather(x, axis, size, dim):
            shape = list(x.shape)
            shape[dim] *= size
            return x.new_empty(shape)

        for name, fn in (("psum", same), ("ppermute", same),
                         ("all_to_all", a2a), ("all_gather", gather)):
            # Stand-ins outside a fake trace too: nothing is exchanged.
            lib.impl(name, fn, "CompositeExplicitAutograd")
            torch.library.register_fake(f"hvd_audit::{name}", fn, lib=lib)
        _LIB = lib


class _Recorder:
    """What the mesh's collectives call while an audit traces a step
    (``parallel/mesh.py`` ``_audit``): each returns what the collective
    would, as a stand-in, through an ``hvd_audit`` operator, and keeps the
    real call's early returns (an axis of size 1, a null rotation)."""

    def __init__(self, bound: Dict[str, int]):
        self.bound = bound
        self.count = 0                     # collectives recorded so far
        self._p2p_ready: set = set()

    def _size(self, axis: str) -> int:
        # An unbound axis (HVD201 in the walk) is traced as size 1.
        return int(self.bound.get(axis, 1))

    def _op(self, name: str):
        import torch
        self.count += 1
        return getattr(torch.ops.hvd_audit, name)

    def psum(self, x, mesh, axis):
        if axis in self.bound and self._size(axis) == 1:
            return x
        return self._op("psum")(x.contiguous(), axis)

    def _rotate(self, x, axis, shift):
        n = self._size(axis)
        src = list(range(n))
        dst = [(i + shift) % n for i in src]
        return self._op("ppermute")(x.contiguous(), axis, src, dst)

    def ppermute(self, tensors, mesh, axis, shift=1, async_op=False):
        from ..parallel.mesh import Exchange
        n = self._size(axis)
        if n == 1 or shift % n == 0:
            out = [t.contiguous() for t in tensors]
        else:
            out = [self._rotate(t, axis, shift) for t in tensors]
        done = Exchange([], out, None)
        return done if async_op else done.wait()

    def send_recv(self, x, mesh, axis, send, recv, shift=1):
        n = self._size(axis)
        if n == 1:
            return None
        if (id(mesh), axis) not in self._p2p_ready:
            self._p2p_ready.add((id(mesh), axis))
            self._rotate(x.new_zeros(1), axis, 1)
        # One hop of the rotation without its wrap: recorded as the
        # rotation, which the hops of every rank at this tick are part of.
        out = self._rotate(x, axis, shift)
        src = mesh.index(axis) - shift
        return out if recv and 0 <= src < n else None

    def all_to_all(self, x, mesh, axis, split_dim, concat_dim):
        n = self._size(axis)
        if n == 1:
            return x
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all along {axis!r} needs dim "
                             f"{split_dim} ({x.shape[split_dim]}) divisible "
                             f"by the axis size {n}")
        return self._op("all_to_all")(x.contiguous(), axis, n, split_dim,
                                      concat_dim)

    def all_gather(self, x, mesh, axis, dim=0):
        n = self._size(axis)
        if n == 1:
            return x
        return self._op("all_gather")(x.contiguous(), axis, n, dim)


def _host_sync_mode(recorder: _Recorder, findings: List[Finding],
                    path: str):
    """A ``TorchFunctionMode`` that reports each host sync of the traced
    step (HVD203) and answers it with zeros of its shape, so the trace
    goes on, as the JAX trace goes on past a host callback."""
    import numpy as np
    import torch
    from torch.overrides import TorchFunctionMode

    def zeros(t):
        return np.zeros(tuple(t.shape),
                        dtype=str(t.dtype).replace("torch.", "")
                        if t.dtype != torch.bfloat16 else "float32")

    class _HostSyncs(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in HOST_SYNC_METHODS and args \
                    and isinstance(args[0], torch.Tensor):
                n = recorder.count
                findings.append(Finding(
                    rule="HVD203", path=path, line=n, col=1,
                    message=f"host sync {name!r} inside the traced step "
                            f"(after collective #{n - 1})"))
                if name == "item":
                    return zeros(args[0]).item() if args[0].dim() == 0 \
                        else 0
                if name == "tolist":
                    return zeros(args[0]).tolist()
                if name == "numpy":
                    return zeros(args[0])
            return func(*args, **(kwargs or {}))

    return _HostSyncs()


@contextlib.contextmanager
def _recording(recorder: _Recorder):
    """Arm the mesh's audit hook for the duration of one trace."""
    from ..parallel import mesh as _mesh
    if _mesh._audit is not None:
        raise RuntimeError("a collective audit is already tracing")
    _mesh._audit = recorder
    try:
        yield
    finally:
        _mesh._audit = None


# ------------------------------------------------------------------ walk
def _check_ppermute(rec: CollectiveRecord, perm, bound: Dict[str, int],
                    findings: List[Finding], path: str):
    """HVD204: a ppermute's perm must be a bijection over its axis —
    every rank appears exactly once as a source and once as a destination,
    all within [0, axis_size).  Non-bijective perms deadlock on multi-host
    runtimes the way bad axis_index_groups do (HVD202); JAX's local
    zero-fill semantics hide the bug until the pod launch."""
    if perm is None or not rec.axes:
        return
    # ppermute over several named axes indexes ranks over the axes'
    # flattened PRODUCT — validating against axes[0] alone would flag
    # valid rings on multi-axis meshes.
    sizes = [bound.get(a) for a in rec.axes]
    if any(not s for s in sizes):
        return
    size = 1
    for s in sizes:
        size *= s
    ax = rec.axes[0] if len(rec.axes) == 1 else tuple(rec.axes)
    pairs = [tuple(p) for p in perm]
    srcs = [p[0] for p in pairs]
    dsts = [p[1] for p in pairs]

    def _fail(detail: str, severity=None):
        findings.append(Finding(
            rule="HVD204", path=path, line=rec.index, col=1,
            severity=severity,
            message=f"collective #{rec.index} (ppermute) over axis {ax!r} "
                    f"of size {size} is not a bijection: {detail}"))

    oob = sorted({r for r in srcs + dsts if r < 0 or r >= size})
    if oob:
        _fail(f"ranks {oob} are outside [0, {size})")
        return
    dup_src = sorted({s for s in srcs if srcs.count(s) > 1})
    dup_dst = sorted({d for d in dsts if dsts.count(d) > 1})
    if dup_src or dup_dst:
        detail = []
        if dup_src:
            detail.append(f"sources {dup_src} send more than once")
        if dup_dst:
            detail.append(f"destinations {dup_dst} receive more than once")
        _fail("; ".join(detail))
        return
    missing = sorted(set(range(size)) - set(srcs))
    if missing:
        # WARNING, not error: partial perms are defined JAX semantics
        # (uncovered destinations read zeros) and XLA's CollectivePermute
        # accepts them — but they are the classic accident behind
        # wedge-shaped halo/pipeline bugs, and point-to-point emulations
        # over eager runtimes deadlock on them, so they stay flagged.
        _fail(f"ranks {missing} appear in no (src, dst) pair (valid "
              f"zero-fill semantics under XLA, but deadlock-prone on "
              f"point-to-point runtimes; make the ring explicit if the "
              f"gap is intended)", severity=Severity.WARNING)


def _walk(graph, bound: Dict[str, int], ledger: List[CollectiveRecord],
          findings: List[Finding], path: str,
          declared: Optional[frozenset] = None):
    """The jaxpr walk of the JAX package over a ``torch.fx`` graph: each
    ``hvd_audit`` node is a ledger record."""
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        target = str(node.target)
        if not target.startswith("hvd_audit."):
            continue
        name = target.split(".")[1]
        x, axis = node.args[0], node.args[1]
        val = x.meta.get("val") if hasattr(x, "meta") else None
        shapes = (tuple(int(d) for d in val.shape),) if val is not None \
            else ()
        dtypes = (str(val.dtype).replace("torch.", ""),) \
            if val is not None else ()
        rec = CollectiveRecord(index=len(ledger), primitive=name,
                               axes=(axis,), shapes=shapes, dtypes=dtypes)
        ledger.append(rec)
        if axis not in bound:
            findings.append(Finding(
                rule="HVD201", path=path, line=rec.index, col=1,
                message=f"collective #{rec.index} ({name}) reduces "
                        f"over axis {axis!r}, but the mesh only binds "
                        f"axes {sorted(bound)} — this fails at "
                        f"lowering or silently no-ops"))
        elif declared is not None and axis not in declared:
            findings.append(Finding(
                rule="HVD112", path=path, line=rec.index, col=1,
                message=f"collective #{rec.index} ({name}) reduces "
                        f"over axis {axis!r}, which the mesh binds but "
                        f"the step's partition specs never shard "
                        f"over (declared: {sorted(declared)}) — the "
                        f"reduction runs over replicated data, "
                        f"scaling results by the axis size"))
        if name == "ppermute":
            _check_ppermute(rec, list(zip(node.args[2], node.args[3])),
                            bound, findings, path)


def check_step_fn(fn, *example_args, mesh=None,
                  axis_sizes: Optional[Dict[str, int]] = None,
                  partition_axes: Optional[Sequence[str]] = None,
                  path: str = "<trace>") -> TraceReport:
    """Trace ``fn(*example_args)`` and audit its collective ledger.

    ``mesh``: the ``ProcessMesh`` (or :class:`AbstractMesh`) the step runs
    on, whose axes it binds.  ``axis_sizes``: name→size bindings without a
    mesh (a step built on an :class:`AbstractMesh` of those sizes).
    ``partition_axes``: the axes the step's specs split over; when given,
    a collective over a bound axis *outside* this set fires HVD112.
    Example args may be real tensors (on the card or the CPU) or pytrees
    of them: each becomes a fake tensor, and nothing executes — no kernel
    launches and no collective moves.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    bound: Dict[str, int] = {}
    if mesh is not None and hasattr(mesh, "shape"):
        bound.update(dict(mesh.shape))
    if axis_sizes:
        bound.update(axis_sizes)

    _define_ops()
    findings: List[Finding] = []
    recorder = _Recorder(bound)
    try:
        with _recording(recorder), \
                _host_sync_mode(recorder, findings, path):
            # Through *args: a default (``generator=None``) must not count
            # as an input to trace.
            gm = make_fx(lambda *args: fn(*args),
                         tracing_mode="fake")(*example_args)
    except Exception as e:  # surface trace failures as findings, not crashes
        findings.append(Finding(
            rule="HVD201", path=path, line=0, col=1,
            message=f"step function failed to trace: {type(e).__name__}: "
                    f"{e}"))
        return TraceReport(ledger=[], findings=findings, bound_axes=bound)

    ledger: List[CollectiveRecord] = []
    declared = frozenset(partition_axes) if partition_axes is not None \
        else None
    _walk(gm.graph, bound, ledger, findings, path, declared)
    findings.sort(key=lambda f: f.line)
    return TraceReport(ledger=ledger, findings=findings, bound_axes=bound)


def compare_ledgers(a: Sequence[CollectiveRecord],
                    b: Sequence[CollectiveRecord],
                    names: Tuple[str, str] = ("rank A", "rank B"),
                    path: str = "<ledger>") -> List[Finding]:
    """Diff two collective ledgers; findings name the first divergence.

    The offline twin of the controller's per-tensor digest mismatch check:
    run it over ledgers recorded by the runtime sanitizer, or over two
    traced variants of a step that must stay wire-compatible.
    """
    findings: List[Finding] = []
    for i, (ra, rb) in enumerate(zip(a, b)):
        if ra.digest() != rb.digest():
            findings.append(Finding(
                rule="HVD301", path=path, line=i, col=1,
                message=f"ledgers diverge at collective #{i}: "
                        f"{names[0]} submitted {ra.digest()} but "
                        f"{names[1]} submitted {rb.digest()}"))
            break
    else:
        if len(a) != len(b):
            longer, shorter = (names[0], names[1]) if len(a) > len(b) \
                else (names[1], names[0])
            extra = (a if len(a) > len(b) else b)[min(len(a), len(b))]
            findings.append(Finding(
                rule="HVD301", path=path, line=min(len(a), len(b)), col=1,
                message=f"{longer} submitted {abs(len(a) - len(b))} more "
                        f"collective(s) than {shorter}, starting with "
                        f"{extra.digest()} — {shorter} will block forever"))
    return findings
