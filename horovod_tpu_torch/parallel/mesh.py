# Ported from horovod_tpu/parallel/mesh.py: the axis names :27, axes_of
# :86-90, require_axis :93-108, make_mesh :111-127 and infer_mesh :130-152.
"""A mesh of process groups for dp/tp/sp/ep/pp parallelism.

The JAX package's mesh is a ``jax.sharding.Mesh``: a device array with
named axes, over which ``shard_map`` binds axis names and XLA issues the
in-graph collectives (``lax.ppermute``, ``lax.all_to_all``).  Here every
process drives one card, so the mesh is a :class:`ProcessMesh` over the
world's ranks: for each named axis this rank's coordinate, the axis size,
and a ``torch.distributed`` group over the ranks that share every other
coordinate.  The **last** axis varies fastest, as in ``make_mesh``.

:func:`ppermute` and :func:`all_to_all` are the counterparts of the
in-graph collectives that the sequence-parallel schemes use
(``parallel/ring_attention.py``, ``parallel/ulysses.py``).  Besides the
engine's cycle thread they are the port's only collectives, and they run
only on the mesh's own groups: ``dist.new_group`` groups that this mesh
creates, never a process set's group, which the engine's cycle thread
drives.  A call on a communicator from two threads can be issued in
another order on each rank, so the two never share one.  On the card the
mesh's communicators run on their own NCCL streams, apart from the
engine's.

``dist.new_group`` is itself a collective: every rank creates every axis
group, those it is not in included, in the same order.
:meth:`ProcessMesh.shutdown` destroys the groups before ``hvd.shutdown()``
tears the world down.

Not carried over, for want of a counterpart: ``SpecLayout`` and
``fsdp_mesh`` (partition specs of ``shard_map``; the port shards no
parameter yet), ``process_set_mesh``/``_spec``/``_sharding`` (translations
between process sets and ``jax.sharding``, which the port does not have),
and the ICI-topology order of ``common/topology.py`` ``ordered_devices``
(ROADMAP queue 1 item 4): ranks are laid out in rank order.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DP, TP, SP, EP, PP = "dp", "tp", "sp", "ep", "pp"


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis as this rank sees it: ``ranks`` are the world ranks along
    the axis through this rank, by coordinate, and ``group`` their process
    group (None for an axis of size 1)."""
    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: object = None


class ProcessMesh:
    """Named axes over the world's ranks, last axis fastest.

    ``axis_sizes`` maps each axis name to its size, in layout order; their
    product is the world size.  Constructing one creates the process
    groups of every axis of size above 1 on every rank (a collective: call
    it on every rank at the same point)."""

    def __init__(self, axis_sizes: Dict[str, int], rank: int, world: int):
        sizes = [int(n) for n in axis_sizes.values()]
        if any(n < 1 for n in sizes) or int(np.prod(sizes)) != world:
            raise ValueError(f"Mesh axes {dict(axis_sizes)} require "
                             f"{int(np.prod(sizes))} ranks, have {world}")
        self._names = tuple(str(a) for a in axis_sizes)
        # The runtime's generation: an elastic re-init tears down every
        # group this mesh holds, and the mesh then refuses to run.
        from ..common import basics
        self._generation = basics._get_state().generation
        # A list to collect the (start, end) marks around each exchange's
        # wait (CUDA events on the card, host times on the CPU), or None.
        self.timing: Optional[list] = None
        grid = np.arange(world).reshape(sizes)
        coords = np.argwhere(grid == rank)[0]
        self._groups: List[object] = []
        self._axes: Dict[str, MeshAxis] = {}
        for d, name in enumerate(self._names):
            mine = tuple(int(r) for r in np.moveaxis(grid, d, -1)[
                tuple(np.delete(coords, d))])
            group = None
            if sizes[d] > 1:
                import torch.distributed as dist
                others = [range(n) for i, n in enumerate(sizes) if i != d]
                for rest in itertools.product(*others):
                    ranks = [int(r) for r in np.moveaxis(grid, d, -1)[rest]]
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        group = g
                        self._groups.append(g)
            self._axes[name] = MeshAxis(name, sizes[d], int(coords[d]), mine,
                                        group)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self._names

    @property
    def shape(self) -> Dict[str, int]:
        return {a: self._axes[a].size for a in self._names}

    def _stale(self) -> bool:
        from ..common import basics
        return basics._get_state().generation != self._generation

    def axis(self, name: str) -> MeshAxis:
        if self._stale():
            raise RuntimeError(
                "this mesh was made in an earlier generation of the world "
                "(an elastic reset has torn its process groups down); make "
                "a new one with make_mesh() after hvd.init()")
        return self._axes[require_axis(self, name)]

    def size(self, name: str) -> int:
        return self.axis(name).size

    def index(self, name: str) -> int:
        return self.axis(name).index

    def shutdown(self) -> None:
        """Destroy this mesh's process groups (before ``hvd.shutdown()``)."""
        import torch.distributed as dist
        groups, self._groups = self._groups, []
        if self._stale():
            return          # torn down with its generation
        for g in groups:
            dist.destroy_process_group(g)

    def __repr__(self):
        return f"ProcessMesh({self.shape})"


def axes_of(mesh: ProcessMesh) -> Tuple[str, ...]:
    """The mesh's named axes, in layout order."""
    return mesh.axis_names


def require_axis(mesh: ProcessMesh, axis_name: str) -> str:
    """Assert ``axis_name`` is an axis of ``mesh`` and return it: an
    exchange over an axis the mesh does not define would run on no group
    or on the wrong one."""
    names = axes_of(mesh)
    if axis_name not in names:
        raise ValueError(
            f"axis {axis_name!r} is not bound by this mesh (axes: "
            f"{list(names)}) — a collective over it would reduce over the "
            f"wrong communicator (HVD112)")
    return axis_name


def _world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(axis_sizes: Dict[str, int]) -> ProcessMesh:
    """Build a named mesh over the world, e.g. ``make_mesh({"dp": 2,
    "sp": 2})``, after ``hvd.init()`` (a world of one process needs no
    process group).  The last axis varies fastest: put the axis whose
    exchanges are heaviest last, where ranks are neighbours."""
    rank, world = _world()
    return ProcessMesh(axis_sizes, rank, world)


def infer_mesh(tp: int = 1, sp: int = 1, ep: int = 1,
               pp: int = 1) -> ProcessMesh:
    """dp fills whatever the fixed axes leave of the world; every axis is
    present (an axis of size 1 costs nothing)."""
    n = _world()[1]
    denom = tp * sp * ep * pp
    if n % denom:
        raise ValueError(f"{n} ranks not divisible by tp*sp*ep*pp={denom}")
    return make_mesh({DP: n // denom, PP: pp, EP: ep, SP: sp, TP: tp})


# ------------------------------------------------------------ exchanges
class Exchange:
    """Tensors in flight from :func:`ppermute`; :meth:`wait` returns them
    received.  On the card the wait is the caller's stream waiting on the
    exchange; ``mesh.timing``, when a list, gets the CUDA events (or host
    times) around each wait."""

    def __init__(self, works, received, timing):
        self._works, self._received, self._timing = works, received, timing

    def wait(self) -> List[torch.Tensor]:
        mark = _mark(self._timing, self._received)
        for w in self._works:
            w.wait()
        if mark is not None:
            self._timing.append((mark, _mark(self._timing, self._received)))
        return self._received


def _mark(timing, tensors):
    """A point on the caller's stream (a CUDA event) or the host's clock,
    when ``timing`` is a list."""
    if timing is None:
        return None
    if tensors and tensors[0].is_cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    import time
    return time.perf_counter()


def timed_ms(marks) -> float:
    """The milliseconds between each ``(start, end)`` pair of
    ``mesh.timing``, summed (read once the card has passed the ends)."""
    return sum(a.elapsed_time(b) if isinstance(a, torch.cuda.Event)
               else (b - a) * 1e3 for a, b in marks)


def ppermute(tensors: Sequence[torch.Tensor], mesh: ProcessMesh,
             axis: str, shift: int = 1, async_op: bool = False):
    """Rotate ``tensors`` along ``axis``: coordinate ``i`` sends each to
    ``(i + shift) % n`` and receives its peer's from ``(i - shift) % n``
    (``lax.ppermute`` with the ring permutation), as one
    ``batch_isend_irecv`` group, so that the sends and receives of a
    rotation cannot block each other.  Returns the received tensors, or
    with ``async_op`` an :class:`Exchange` to ``wait()`` on."""
    import torch.distributed as dist
    ax = mesh.axis(axis)
    tensors = [t.contiguous() for t in tensors]
    if ax.size == 1 or shift % ax.size == 0:
        done = Exchange([], tensors, None)
        return done if async_op else done.wait()
    dst = ax.ranks[(ax.index + shift) % ax.size]
    src = ax.ranks[(ax.index - shift) % ax.size]
    received = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, group=ax.group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, src, group=ax.group)
            for r in received]
    pending = Exchange(dist.batch_isend_irecv(ops), received, mesh.timing)
    return pending if async_op else pending.wait()


def all_to_all(x: torch.Tensor, mesh: ProcessMesh, axis: str,
               split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)`` along ``axis``: ``x`` is cut into
    ``n`` chunks along ``split_dim``, chunk ``j`` goes to coordinate
    ``j``, and the chunks received are concatenated along ``concat_dim``
    in coordinate order.  The regrouping around the one
    ``all_to_all_single`` is plain tensor ops."""
    import torch.distributed as dist
    ax = mesh.axis(axis)
    if ax.size == 1:
        return x
    if x.shape[split_dim] % ax.size:
        raise ValueError(f"all_to_all along {axis!r} needs dim {split_dim} "
                         f"({x.shape[split_dim]}) divisible by the axis "
                         f"size {ax.size}")
    send = torch.stack(x.chunk(ax.size, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    mark = _mark(mesh.timing, [x])
    dist.all_to_all_single(recv, send, group=ax.group)
    if mark is not None:
        mesh.timing.append((mark, _mark(mesh.timing, [x])))
    return torch.cat(recv.unbind(0), dim=concat_dim)
