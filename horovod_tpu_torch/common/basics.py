"""Core runtime state and the ``init``/``rank``/``size`` API family.

Port of ``horovod_tpu/common/basics.py:77-200``.  The world contract:

- With no ``HOROVOD_*`` env the world is one process of size 1 and no
  process group is formed.
- With ``HOROVOD_RANK``, ``HOROVOD_SIZE``, ``HOROVOD_LOCAL_RANK`` and
  ``HOROVOD_CONTROLLER_ADDR``/``HOROVOD_CONTROLLER_PORT`` set (the launcher
  contract of ``horovod_tpu/runner/run.py``) and a size above 1, ``init()``
  forms the ``torch.distributed`` world at that address: NCCL when the
  device is a card, gloo on the CPU.

The device is ``cuda:{local_rank}`` unless the caller asks for the CPU
(``init(device="cpu")``, as the tests do).  With no card and no such
request ``init()`` raises: the port never carries on on the CPU by itself.
Elastic membership, topology, the timeline and the collective engine come
with later parts of the port.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

import torch

from .process_sets import ProcessSet, ProcessSetTable, global_process_set


class NotInitializedError(RuntimeError):
    def __init__(self):
        super().__init__(
            "horovod_tpu_torch has not been initialized; call hvd.init() "
            "first.")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v.strip() else default


class GlobalState:
    def __init__(self):
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.device: Optional[torch.device] = None
        self.owns_process_group = False
        self.process_set_table = ProcessSetTable()
        self._lock = threading.Lock()


_state = GlobalState()


def _get_state() -> GlobalState:
    return _state


def _resolve_device(device, local_rank: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch.init(): no CUDA device is available; pass "
            "device='cpu' to run on the CPU explicitly")
    return torch.device(f"cuda:{local_rank}")


def init(process_sets: Optional[Sequence[ProcessSet]] = None,
         device=None) -> None:
    """Initialize the runtime.  Idempotent, like ``hvd.init()``."""
    st = _state
    with st._lock:
        if st.initialized:
            return
        size = _env_int("HOROVOD_SIZE", 1)
        rank = _env_int("HOROVOD_RANK", 0)
        local_rank = _env_int("HOROVOD_LOCAL_RANK", 0)
        local_size = _env_int("HOROVOD_LOCAL_SIZE", size)
        dev = _resolve_device(device, local_rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        st.owns_process_group = False
        if size > 1:
            import torch.distributed as dist
            if not dist.is_initialized():
                addr = os.environ.get("HOROVOD_CONTROLLER_ADDR", "")
                port = os.environ.get("HOROVOD_CONTROLLER_PORT", "")
                if not addr or not port:
                    raise RuntimeError(
                        f"HOROVOD_SIZE={size} needs HOROVOD_CONTROLLER_ADDR "
                        f"and HOROVOD_CONTROLLER_PORT to form the world")
                dist.init_process_group(
                    backend="nccl" if dev.type == "cuda" else "gloo",
                    init_method=f"tcp://{addr}:{port}",
                    world_size=size, rank=rank)
                st.owns_process_group = True
        st.rank, st.size = rank, size
        st.local_rank, st.local_size = local_rank, local_size
        st.device = dev
        gs = st.process_set_table.initialize(size, _make_group,
                                             extra_sets=process_sets)
        # Rebind the module-level global_process_set singleton.
        global_process_set.__dict__.update(gs.__dict__)
        st.process_set_table._sets[0] = global_process_set
        st.initialized = True


def _make_group(ranks):
    """The process group of a set: none in a world of one process, the
    default group for the global set, a new group for a subset."""
    if _state.size == 1:
        return None
    import torch.distributed as dist
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks)


def shutdown() -> None:
    st = _state
    with st._lock:
        if not st.initialized:
            return
        if st.owns_process_group:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
        st.owns_process_group = False
        st.process_set_table = ProcessSetTable()
        st.device = None
        st.initialized = False


def is_initialized() -> bool:
    return _state.initialized


def _checked() -> GlobalState:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def size() -> int:
    """Global number of ranks (one process per card)."""
    return _checked().size


def rank() -> int:
    return _checked().rank


def local_size() -> int:
    return _checked().local_size


def local_rank() -> int:
    return _checked().local_rank


def device() -> torch.device:
    """The device this process computes on (``cuda:{local_rank}`` unless
    ``init(device=...)`` said otherwise)."""
    return _checked().device


def add_process_set(ps_or_ranks) -> ProcessSet:
    st = _checked()
    ps = (ps_or_ranks if isinstance(ps_or_ranks, ProcessSet)
          else ProcessSet(ps_or_ranks))
    return st.process_set_table.add(ps, st.size, _make_group)


def remove_process_set(ps: ProcessSet):
    _checked().process_set_table.remove(ps)


def process_set_included(ps: ProcessSet) -> bool:
    return ps.included(rank())
