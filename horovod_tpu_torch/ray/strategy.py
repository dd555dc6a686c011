# Copied from horovod_tpu/ray/strategy.py:1-89.
"""Worker-placement strategies for the Ray executor.

Parity: reference ``horovod/ray/strategy.py`` — pack vs. spread colocation
of workers onto cluster nodes.  Pure functions of the node inventory so the
logic is testable without a Ray cluster (the reference tests the same way,
SURVEY.md §4 ``test_ray.py``).

TPU note: a "node" here is a TPU VM worker; ``accelerators_per_node`` maps
to chips per VM, and pack-by-slice keeps workers on the same ICI domain.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class NodeResources:
    hostname: str
    cpus: int = 0
    accelerators: int = 0


@dataclasses.dataclass(frozen=True)
class Allocation:
    """One worker's placement."""
    hostname: str
    local_rank: int
    rank: int
    cross_rank: int


def _allocate(counts: List[Tuple[str, int]]) -> List[Allocation]:
    out: List[Allocation] = []
    rank = 0
    for cross_rank, (host, n) in enumerate(counts):
        for local_rank in range(n):
            out.append(Allocation(host, local_rank, rank, cross_rank))
            rank += 1
    return out


def pack(nodes: List[NodeResources], num_workers: int,
         use_accelerators: bool = True) -> List[Allocation]:
    """Fill each node to capacity before moving on (minimizes hosts used →
    maximizes intra-host/ICI communication).  Reference: PackStrategy."""
    counts: List[Tuple[str, int]] = []
    remaining = num_workers
    for node in nodes:
        cap = node.accelerators if use_accelerators else node.cpus
        take = min(cap, remaining)
        if take > 0:
            counts.append((node.hostname, take))
            remaining -= take
        if remaining == 0:
            break
    if remaining > 0:
        total = sum(n.accelerators if use_accelerators else n.cpus
                    for n in nodes)
        raise ValueError(
            f"Cannot place {num_workers} workers: cluster capacity {total}")
    return _allocate(counts)


def spread(nodes: List[NodeResources], num_workers: int,
           use_accelerators: bool = True) -> List[Allocation]:
    """Round-robin workers across as many nodes as possible (maximizes
    aggregate host NIC/DCN bandwidth).  Reference: SpreadStrategy."""
    caps = {n.hostname: (n.accelerators if use_accelerators else n.cpus)
            for n in nodes}
    counts: Dict[str, int] = {n.hostname: 0 for n in nodes}
    placed = 0
    while placed < num_workers:
        progressed = False
        for n in nodes:
            if placed == num_workers:
                break
            if counts[n.hostname] < caps[n.hostname]:
                counts[n.hostname] += 1
                placed += 1
                progressed = True
        if not progressed:
            raise ValueError(
                f"Cannot place {num_workers} workers: cluster capacity "
                f"{sum(caps.values())}")
    ordered = [(n.hostname, counts[n.hostname]) for n in nodes
               if counts[n.hostname] > 0]
    return _allocate(ordered)
