# Ported from horovod_tpu/parallel/adasum.py: adasum_combine :41-53,
# _tree_reduce :56-71, adasum_allreduce :74-78, adasum_allreduce_hd
# :108-144, adasum_allreduce_hier :147-181 and the _vhd core :184-251.
"""Adasum: adaptive summation of gradients across ranks.

Port of ``horovod_tpu/parallel/adasum.py`` (reference: ``horovod/common/
ops/adasum/adasum.h``, ``adasum_mpi_operations.cc`` — SURVEY.md §2a N20).
Two gradients combine by subtracting their mutual projections:

    adasum(a, b) = (1 - a·b / (2|a|²)) a + (1 - a·b / (2|b|²)) b

and n ranks reduce by applying it pairwise in a binary tree.

- :func:`adasum_allreduce`: every rank's vector gathered, then the tree,
  for any number of ranks; each combine casts its result back to the
  input's dtype, as the JAX function does.
- :func:`adasum_allreduce_hd`: vector-halving-doubling (VHD), power-of-two
  worlds.  In halving round ``b`` a rank and its partner ``index XOR 2^b``
  swap the halves of their working segment that the other keeps; the dots
  of the full vectors being combined are spread over the ``2^(i+1)`` ranks
  of the round's subgroup, so each rank's partial triple is summed over it
  by recursive doubling (a swap of 12 bytes, then an addition, once for each
  round so far).  The doubling rounds swap the combined segments back.
  Every step is float32, from the cast at the start to the cast back at
  the end, as the JAX ``_vhd`` is.
- :func:`adasum_allreduce_hier`: the same core with its rounds over the
  local group's bits first, then the cross group's.  The launcher numbers a
  host's ranks consecutively, so that schedule is the flat identity-order
  VHD over the world (``horovod_tpu/parallel/adasum.py:153-160``): the two
  give the same bits, and only the groups that carry the swaps differ.

This module issues no collective.  Its callers pass the exchanges: a
round is ``(swap, index, bit)``, where ``swap(send, out, peer)`` sends
``send`` to the rank at position ``peer`` of the round's group and
receives that rank's tensor of the same length into ``out``, and ``index``
is this rank's position in the group (the engine's cycle thread passes
``batch_isend_irecv`` swaps on its own groups; the tests pass lock-step
swaps between threads).  The arithmetic is ``ops/adasum.py``'s kernels
(``hvd_adasum_dots``, ``hvd_adasum_combine``), on the card; the float32
casts around them are plain torch casts, where the JAX code casts too.

``torus_bit_order`` has no counterpart: GPU ranks carry no torus
coordinates, and the JAX engine takes the identity order without them
(``horovod_tpu/ops/engine.py:2056-2061``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..ops import adasum as K

Swap = Callable[[torch.Tensor, torch.Tensor, int], None]
Round = Tuple[Swap, int, int]          # (swap, index in its group, bit)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` flat in float32 (a complex tensor's real part, as JAX's
    ``astype(float32)`` takes it)."""
    if x.is_complex():
        x = torch.real(x)
    return x.reshape(-1).to(torch.float32).contiguous()


def adasum_combine(a: torch.Tensor, b: torch.Tensor,
                   eps: float = K.EPS) -> torch.Tensor:
    """Pairwise Adasum of two same-shaped tensors, in float32, cast back
    to ``a``'s dtype.  Orthogonal gradients sum exactly; parallel ones
    average."""
    af, bf = _f32(a), _f32(b)
    out = K.combine(af, bf, K.dots(af, bf), True, eps=eps)
    return out.view(a.shape).to(a.dtype)


def _tree_reduce(vals: Sequence[torch.Tensor]) -> torch.Tensor:
    """Pairs ``(0, 1), (2, 3), ...`` at each level; an odd remainder
    folds into the level's last pair."""
    vals = list(vals)
    while len(vals) > 1:
        nxt = [adasum_combine(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2 == 1:
            nxt[-1] = adasum_combine(nxt[-1], vals[-1])
        vals = nxt
    return vals[0]


def adasum_allreduce(x: torch.Tensor,
                     gather: Callable[[torch.Tensor], List[torch.Tensor]]
                     ) -> torch.Tensor:
    """Adasum over any number of ranks: ``gather(x)`` returns every rank's
    tensor in rank order, then the tree."""
    return _tree_reduce(gather(x))


def _power_of_two(n: int, what: str) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two, got {n}")


def adasum_allreduce_hd(x: torch.Tensor, swap: Swap, index: int, n: int,
                        bit_order: Optional[Sequence[int]] = None,
                        eps: float = K.EPS) -> torch.Tensor:
    """VHD Adasum over a group of ``n`` ranks (a power of two), this rank
    at ``index``; rounds over ``bit_order`` (identity by default)."""
    _power_of_two(n, "adasum_allreduce_hd's world")
    rounds = n.bit_length() - 1
    bits = list(bit_order) if bit_order is not None else list(range(rounds))
    if sorted(bits) != list(range(rounds)):
        raise ValueError(f"bit_order must order the bits 0..{rounds - 1}, "
                         f"got {bits}")
    return vhd(x, [(swap, index, b) for b in bits], eps)


def adasum_allreduce_hier(x: torch.Tensor, local: Tuple[Swap, int, int],
                          cross: Tuple[Swap, int, int],
                          local_bits: Optional[Sequence[int]] = None,
                          cross_bits: Optional[Sequence[int]] = None,
                          eps: float = K.EPS) -> torch.Tensor:
    """Two-level VHD Adasum: ``local`` and ``cross`` are ``(swap, index,
    size)`` of this rank's local and cross groups, both sizes powers of
    two; the local rounds run first."""
    (lswap, lidx, nl), (cswap, cidx, nc) = local, cross
    _power_of_two(nl, "adasum_allreduce_hier's local extent")
    _power_of_two(nc, "adasum_allreduce_hier's cross extent")
    lb = list(local_bits) if local_bits is not None \
        else list(range(nl.bit_length() - 1))
    cb = list(cross_bits) if cross_bits is not None \
        else list(range(nc.bit_length() - 1))
    return vhd(x, [(lswap, lidx, b) for b in lb]
               + [(cswap, cidx, b) for b in cb], eps)


def vhd(x: torch.Tensor, rounds: Sequence[Round],
        eps: float = K.EPS) -> torch.Tensor:
    """The halving-doubling core over a round schedule (JAX ``_vhd``).

    ``x`` is cast to float32 and padded with zeros to a multiple of
    ``2^len(rounds)`` in one working buffer.  Halving round ``i`` swaps the
    half of the working segment that the partner keeps into a scratch
    buffer, forms the partial triple ``(a·b, |a|², |b|²)`` on this rank's
    pieces (``a`` the low rank's vector), sums it over the subgroup of the
    rounds so far, and combines in place over the kept half.  The doubling
    rounds receive the partner's combined segment straight into its place
    beside this rank's, so nothing is concatenated.  Returns the result in
    ``x``'s shape and dtype (a view of the buffer for float32)."""
    n = x.numel()
    if not rounds or n == 0:
        return x
    total = 1 << len(rounds)
    padded = n + (-n) % total
    work = torch.empty(padded, dtype=torch.float32, device=x.device)
    work[n:].zero_()
    work[:n].copy_((torch.real(x) if x.is_complex() else x).reshape(-1))
    scratch = torch.empty(padded // 2, dtype=torch.float32, device=x.device)
    peer3 = torch.empty(3, dtype=torch.float32, device=x.device)
    off, length = 0, padded
    for i, (swap, idx, b) in enumerate(rounds):
        half = length // 2
        is_low = ((idx >> b) & 1) == 0
        low = work[off:off + half]
        high = work[off + half:off + length]
        kept, send = (low, high) if is_low else (high, low)
        received = scratch[:half]
        swap(send, received, idx ^ (1 << b))
        triple = K.dots(kept, received) if is_low \
            else K.dots(received, kept)
        for swap2, idx2, b2 in rounds[:i + 1]:
            swap2(triple, peer3, idx2 ^ (1 << b2))
            triple = triple + peer3
        K.combine(kept, received, triple, is_low, out=kept, eps=eps)
        if not is_low:
            off += half
        length = half
    for swap, idx, b in reversed(rounds):
        is_low = ((idx >> b) & 1) == 0
        seg = work[off:off + length]
        other = (work[off + length:off + 2 * length] if is_low
                 else work[off - length:off])
        swap(seg, other, idx ^ (1 << b))
        if not is_low:
            off -= length
        length *= 2
    out = work[:n].view(x.shape)
    return out if x.dtype == torch.float32 else out.to(x.dtype)
