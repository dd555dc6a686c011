"""Process sets: named subgroups of ranks with their own process group.

Port of ``horovod_tpu/common/process_sets.py``.  Where the JAX package gives
each set a ``jax.sharding.Mesh`` over its devices, a set here is a sorted
rank list plus a ``torch.distributed`` process group over those ranks.  In a
single-process world there is no process group at all: ``group`` is None and
every collective over the set is the identity.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class ProcessSet:
    """A named subgroup of ranks over which collectives can run.

    ``ProcessSet([0, 1])`` mirrors ``hvd.ProcessSet([0, 1])`` in the
    reference.  The special ``global_process_set`` contains every rank.
    """

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.ranks: Optional[List[int]] = (sorted(ranks) if ranks is not None
                                           else None)
        self.process_set_id: Optional[int] = None
        self.group = None       # torch.distributed ProcessGroup, or None

    def _materialize(self, ps_id: int, world_size: int, make_group):
        if self.ranks is None:
            self.ranks = list(range(world_size))
        bad = [r for r in self.ranks if r < 0 or r >= world_size]
        if bad:
            raise ValueError(f"ProcessSet ranks out of range: {bad}")
        self.process_set_id = ps_id
        self.group = make_group(self.ranks)

    def size(self) -> int:
        if self.ranks is None:
            raise RuntimeError("ProcessSet not yet registered")
        return len(self.ranks)

    def rank_in_set(self, global_rank: int) -> int:
        """Position of a global rank inside this set (ValueError if absent)."""
        assert self.ranks is not None
        return self.ranks.index(global_rank)

    def included(self, global_rank: int) -> bool:
        assert self.ranks is not None
        return global_rank in self.ranks

    def __repr__(self):
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


class ProcessSetTable:
    """Registry of process sets, id 0 = global set."""

    def __init__(self):
        self._sets: Dict[int, ProcessSet] = {}
        self._next_id = 0

    def initialize(self, world_size: int, make_group,
                   extra_sets: Optional[Sequence[ProcessSet]] = None
                   ) -> ProcessSet:
        self._sets.clear()
        self._next_id = 0
        global_set = ProcessSet(None)
        self.add(global_set, world_size, make_group)
        for ps in (extra_sets or []):
            self.add(ps, world_size, make_group)
        return global_set

    def add(self, ps: ProcessSet, world_size: int, make_group) -> ProcessSet:
        want = (sorted(ps.ranks) if ps.ranks is not None
                else list(range(world_size)))
        for existing in self._sets.values():
            if existing.ranks == want:
                raise ValueError(
                    f"A process set with ranks {existing.ranks} already "
                    f"exists")
        ps._materialize(self._next_id, world_size, make_group)
        self._sets[self._next_id] = ps
        self._next_id += 1
        return ps

    def remove(self, ps: ProcessSet):
        if ps.process_set_id == 0:
            raise ValueError("Cannot remove the global process set")
        self._sets.pop(ps.process_set_id, None)
        ps.process_set_id = None
        ps.group = None

    def get(self, ps_id: int) -> ProcessSet:
        return self._sets[ps_id]

    @property
    def global_set(self) -> ProcessSet:
        return self._sets[0]

    def all_sets(self) -> List[ProcessSet]:
        return list(self._sets.values())


# Singleton placeholder mirroring hvd.global_process_set; bound at init().
global_process_set = ProcessSet(None)
