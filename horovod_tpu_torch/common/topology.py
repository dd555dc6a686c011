# Ported from horovod_tpu/common/topology.py:57-118 (Topology: local_counts,
# local_size, local_rank_of, ranks_of_process; build_topology).
"""The world's layout over hosts, one process a GPU.

The JAX package's ``Topology`` holds the world's devices, one or more a
process, and counts the devices of each process (``local_counts``).  Here a
rank is a process that drives one card, and the two-level structure that
matters is the **host**: the ranks that share a host's NVLink.  So
``local_counts`` is the world's ranks on each host, in host order, taken
from the launcher, which numbers a host's ranks consecutively (host-major)
and sets ``HOROVOD_LOCAL_COUNTS`` beside ``HOROVOD_CROSS_SIZE``
(``runner/run.py`` ``worker_envs``).  It must be the same list on every
rank: a rank's own ``HOROVOD_LOCAL_SIZE`` and ``HOROVOD_CROSS_SIZE`` do
not show whether the hosts are uniform (with hosts of 2, 1 and 3 ranks the
first host sees 2 × 3 = 6 and would call the world uniform where the
others would not), so ranks deciding from those alone could take different
schedules and deadlock.  A rank started without the list has
``local_counts`` None, and its world is flat unless a knob sets the slices
(``parallel/topology.py`` ``slice_topology`` uses ``local_counts`` only
when they are uniform).

``ordered_devices``, ``torus_dims`` and ``hierarchical_mesh`` have no
counterpart: GPU ranks are ordered host-major by the launcher and have no
torus coordinates, and the JAX engine takes the identity bit order for
Adasum when it finds no coordinates (``horovod_tpu/ops/engine.py:2056-
2061``).  The (cross, local) groups the two-level data plane runs on are
the engine's (``ops/engine.py`` ``_make_hier_groups``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

LOCAL_COUNTS_ENV = "HOROVOD_LOCAL_COUNTS"


@dataclasses.dataclass(frozen=True)
class Topology:
    """The world's ranks over hosts: ``local_counts[h]`` ranks on host
    ``h``, host-major; None when the launcher gave no list."""

    size: int
    rank: int
    local_counts: Optional[Tuple[int, ...]]

    def _counts(self) -> Tuple[int, ...]:
        if self.local_counts is None:
            raise ValueError(f"the ranks per host are unknown (no "
                             f"{LOCAL_COUNTS_ENV} from the launcher)")
        return self.local_counts

    def host_of(self, rank: int) -> int:
        first = 0
        for h, c in enumerate(self._counts()):
            if rank < first + c:
                return h
            first += c
        raise ValueError(f"rank {rank} is outside a world of {self.size}")

    @property
    def my_host(self) -> int:
        return self.host_of(self.rank)

    @property
    def local_size(self) -> int:
        return self._counts()[self.my_host]

    @property
    def local_rank_of(self) -> Dict[int, int]:
        """rank -> its index among its host's ranks."""
        out, r = {}, 0
        for c in self._counts():
            for i in range(c):
                out[r] = i
                r += 1
        return out

    def ranks_of_process(self, host: int) -> List[int]:
        """The ranks of host ``host``."""
        counts = self._counts()
        first = sum(counts[:host])
        return list(range(first, first + counts[host]))


def parse_local_counts(text: str, size: int) -> Optional[Tuple[int, ...]]:
    """``"2,1,3"`` → ``(2, 1, 3)``: positive counts that sum to the world's
    size; empty → None; anything else raises ``ValueError``."""
    if not text or not text.strip():
        return None
    try:
        counts = tuple(int(p) for p in text.split(","))
    except ValueError:
        raise ValueError(f"{LOCAL_COUNTS_ENV}={text!r}: not a list of "
                         f"integers")
    if any(c < 1 for c in counts) or sum(counts) != size:
        raise ValueError(f"{LOCAL_COUNTS_ENV}={text!r}: positive counts "
                         f"summing to the world's size {size} expected")
    return counts


def build_topology(size: int, rank: int) -> Topology:
    """The topology of this process's world, from the launcher's
    ``HOROVOD_LOCAL_COUNTS`` (one host of one rank in a world of one)."""
    counts = parse_local_counts(os.environ.get(LOCAL_COUNTS_ENV, ""), size)
    if counts is None and size == 1:
        counts = (1,)
    return Topology(size=size, rank=rank, local_counts=counts)
