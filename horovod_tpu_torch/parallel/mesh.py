# Ported from horovod_tpu/parallel/mesh.py: the axis names :27, axes_of
# :86-90, require_axis :93-108, make_mesh :111-127 and infer_mesh :130-152;
# the tensor-parallel reduction stands for the lax.psum calls of
# horovod_tpu/models/llama.py:366-367, :431-432 and bert.py:137-138, :145-146.
"""A mesh of process groups for dp/tp/sp/ep/pp parallelism.

The JAX package's mesh is a ``jax.sharding.Mesh``: a device array with
named axes, over which ``shard_map`` binds axis names and XLA issues the
in-graph collectives (``lax.ppermute``, ``lax.all_to_all``).  Here every
process drives one card, so the mesh is a :class:`ProcessMesh` over the
world's ranks: for each named axis this rank's coordinate, the axis size,
and a ``torch.distributed`` group over the ranks that share every other
coordinate.  The **last** axis varies fastest, as in ``make_mesh``.

:func:`ppermute`, :func:`all_to_all` and :func:`all_gather` are the
counterparts of the in-graph collectives that the sequence- and
expert-parallel schemes use (``parallel/ring_attention.py``,
``parallel/ulysses.py``, ``models/moe.py``, ``models/dlrm.py``);
:class:`AllToAll` is the all-to-all under autograd, whose backward is the
inverse exchange, as the transpose of ``lax.all_to_all`` is, and
:class:`PPermute` the rotation under autograd, whose backward is the
inverse rotation.  :func:`send_recv` is one hop of a rotation without
its wrap, each side taken only where it carries data: the pipeline's
stage-to-stage hop (``parallel/pipeline.py``).
:func:`psum` is ``lax.psum``, and :class:`ReduceOutput` and
:class:`CopyInput` are Megatron's pair over it for tensor parallelism:
``g``, the sum after a row-split product, whose backward is the identity,
and ``f``, the identity on the input of a column-split block, whose
backward sums the cotangent.  The JAX models psum in the forward only
(psum's transpose is a psum), divide each rank's loss by tp and psum the
replicated leaves' gradients over tp in ``sync_grads``; with the pair,
every rank's loss is its own mean, as everywhere in the port, and each
replicated leaf's gradient comes out whole and equal on every tp rank, so
that ``DistributedOptimizer``'s average serves it as before.  The two
give the same gradients.  Besides the
engine's cycle thread these are the port's only collectives, and they run
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
``fsdp_mesh`` (partition specs of ``shard_map``, which the port does not
have: each model's ``param_specs`` names the axis and dimension a leaf is
split over, ``parallel/expert.py`` ``Split``),
``process_set_mesh``/``_spec``/``_sharding`` (translations between process
sets and ``jax.sharding``), and the ICI-topology order of
``common/topology.py`` ``ordered_devices`` (ROADMAP queue 1 item 4): ranks
are laid out in rank order.
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
        # The axes whose group has carried a point-to-point exchange in
        # which every rank took part (see send_recv).
        self._p2p_ready: set = set()
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
    mesh._p2p_ready.add(axis)
    return pending if async_op else pending.wait()


class PPermute(torch.autograd.Function):
    """:func:`ppermute` of one tensor under autograd: ``PPermute.apply(x,
    mesh, axis, shift)``.  The backward is the inverse rotation (``-shift``),
    as the transpose of ``lax.ppermute`` is: each cotangent goes back to
    the coordinate its tensor came from.  Every rank of the axis must reach
    the backward, as every rank rotated in the forward: a rank whose loss
    does not depend on what it received still passes a zero cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis, shift=1):
        ctx.attrs = (mesh, axis, shift)
        return ppermute([x], mesh, axis, shift)[0]

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.attrs
        return ppermute([g], mesh, axis, -shift)[0], None, None, None


def send_recv(x: torch.Tensor, mesh: ProcessMesh, axis: str, send: bool,
              recv: bool, shift: int = 1) -> Optional[torch.Tensor]:
    """One hop along ``axis`` that does not wrap: coordinate ``i`` sends
    ``x`` to ``i + shift`` when ``send``, and receives a tensor shaped like
    ``x`` from ``i - shift`` when ``recv`` (None otherwise), as one
    ``batch_isend_irecv`` group; a side whose peer falls off the end of
    the axis is skipped.  Both ends must agree on which hops carry data
    (the pipeline decides it from the tick, which every stage knows).
    Every rank of the axis calls it at the same points, with nothing to
    do or not: the first call on an axis first rotates one element around
    the whole group, because NCCL requires every rank of a group in its
    first point-to-point batch.  ``mesh.timing`` marks the hops that carry
    data."""
    import torch.distributed as dist
    ax = mesh.axis(axis)
    if ax.size == 1:
        return None
    if axis not in mesh._p2p_ready:
        ppermute([x.new_zeros(1)], mesh, axis)
    dst, src = ax.index + shift, ax.index - shift
    ops, received = [], None
    if send and 0 <= dst < ax.size:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), ax.ranks[dst],
                              group=ax.group))
    if recv and 0 <= src < ax.size:
        received = torch.empty_like(x, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, received, ax.ranks[src],
                              group=ax.group))
    if ops:
        Exchange(dist.batch_isend_irecv(ops), [received if received
                                               is not None else x],
                 mesh.timing).wait()
    return received


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


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all` under autograd: ``AllToAll.apply(x, mesh, axis,
    split_dim, concat_dim)``.  The backward is the inverse exchange (the
    split and concatenated dimensions swapped), as the transpose of
    ``lax.all_to_all`` is: each chunk's cotangent goes back to the rank the
    chunk came from."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.attrs = (mesh, axis, split_dim, concat_dim)
        return all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.attrs
        return (all_to_all(g, mesh, axis, concat_dim, split_dim),
                None, None, None, None)


def all_gather(x: torch.Tensor, mesh: ProcessMesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(tiled=True)`` along ``axis``: every coordinate's
    ``x`` concatenated along ``dim`` in coordinate order.  One
    ``all_to_all_single`` of ``x`` repeated ``n`` times (each coordinate
    sends its one tensor to every other), so that the mesh keeps to its two
    exchange kinds.  Not differentiable: it carries integer ids
    (``models/dlrm.py``)."""
    import torch.distributed as dist
    ax = mesh.axis(axis)
    if ax.size == 1:
        return x
    send = x.unsqueeze(0).expand(ax.size, *x.shape).contiguous()
    recv = torch.empty_like(send)
    mark = _mark(mesh.timing, [x])
    dist.all_to_all_single(recv, send, group=ax.group)
    if mark is not None:
        mesh.timing.append((mark, _mark(mesh.timing, [x])))
    return torch.cat(recv.unbind(0), dim=dim)


def psum(x: torch.Tensor, mesh: ProcessMesh, axis: str) -> torch.Tensor:
    """``lax.psum`` along ``axis``: the sum of every coordinate's ``x``, the
    same on each (a new tensor; ``x`` itself at an axis of size 1)."""
    import torch.distributed as dist
    ax = mesh.axis(axis)
    if ax.size == 1:
        return x
    out = x.contiguous().clone()
    mark = _mark(mesh.timing, [x])
    dist.all_reduce(out, group=ax.group)
    if mark is not None:
        mesh.timing.append((mark, _mark(mesh.timing, [x])))
    return out


class ReduceOutput(torch.autograd.Function):
    """Megatron's ``g``: ``ReduceOutput.apply(x, mesh, axis)`` sums ``x``
    over ``axis`` in the forward (after a row-split product) and passes the
    cotangent through unchanged: every rank downstream holds the same
    activation and the same loss, so each already holds the whole
    cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class CopyInput(torch.autograd.Function):
    """Megatron's ``f``: ``CopyInput.apply(x, mesh, axis)`` is the identity
    in the forward (on the input of a column-split block) and sums the
    cotangent over ``axis`` in the backward: each rank's block saw only its
    columns' share of the input's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.attrs = (mesh, axis)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.attrs
        return psum(g, mesh, axis), None, None
