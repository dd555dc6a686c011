"""The port's repaired faults, each pinned on the CPU.

- Shutdown race: a batch whose collective completed settles with its
  result even when the next negotiation round fails because the
  coordinator's host exited (the last rank to finish a two-rank run).
- A rank whose local rank has no card is refused by ``init()`` at once,
  naming the local rank and the card count.
- The in-flight window's watcher lets go of a batch once it has settled
  it, so the batch's tensors (inputs, outputs, the fusion buffer) are not
  held until the next batch arrives.
- A replicated ``DistributedOptimizer`` with its gradient hooks is freed
  once nothing refers to it: the hooks, which each parameter holds, refer
  to it weakly (a strong reference through a tensor's hook dict is a cycle
  the collector cannot see, which kept the parameters, gradients and
  optimizer state alive for ever).
- ``functions.broadcast_object`` exists, as the reference's torch binding
  defines it in its ``functions`` module: a pass-through to
  ``mpi_ops.broadcast_object``.
"""

import gc
import threading
import time
import types
import weakref

import pytest
import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.exceptions import PeerFailureError
from horovod_tpu_torch.common.process_sets import ProcessSetTable
from horovod_tpu_torch.ops import engine as port_engine


class _DyingCoordinator:
    """A controller whose first round makes every entry ready and whose
    second fails as a round does once the coordinator's host has exited."""
    left_ranks = None
    interrupted = False
    spec_dispatch_ok = False

    def __init__(self):
        self.rounds = 0
        self.join_error = None

    def negotiate(self, entries):
        self.rounds += 1
        if self.rounds == 1:
            return list(entries), []
        raise PeerFailureError("controller round rc=-1", dead_ranks=[0])

    def forget(self, e):
        pass

    def fail_join(self, exc):
        self.join_error = exc


def test_torch_completed_batch_settles_with_its_result(monkeypatch):
    """The watcher has not yet claimed the completed batch (its waiter is
    held) when the next round fails: the abort must hand the waiter the
    batch's result, and the engine still latches the fault."""
    table = ProcessSetTable()
    table.initialize(2, lambda ranks: None)
    eng = port_engine.CollectiveEngine(types.SimpleNamespace(
        config=Config(), process_set_table=table,
        device=torch.device("cpu")))
    eng.controller = _DyingCoordinator()
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda buf, op, group: buf.mul_(2))
    held, release = threading.Event(), threading.Event()

    def waiter(results):
        held.set()
        release.wait()
    eng._wait_done = waiter
    x = torch.arange(4, dtype=torch.float32)
    h = eng.enqueue("last", port_engine.CollectiveType.ALLREDUCE, x,
                    reduce_op=port_engine.C.ReduceOp.SUM,
                    output=torch.empty_like(x))
    try:
        eng.run_loop_once()                  # the batch's collective
        assert held.wait(5)
        eng.run_loop_once()                  # the round that fails
        assert isinstance(eng.fault, PeerFailureError)
        out = eng.synchronize(h, timeout=5)
        assert torch.equal(out, 2 * x)
        assert eng.controller.join_error is eng.fault
    finally:
        release.set()
        eng.stop()


def test_torch_init_refuses_a_local_rank_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert basics._resolve_device(None, 0) == torch.device("cuda:0")
    with pytest.raises(RuntimeError, match=r"local rank 1 .* 1 CUDA device"):
        basics._resolve_device(None, 1)
    # An explicit device is the caller's choice.
    assert basics._resolve_device("cpu", 3) == torch.device("cpu")


def test_torch_inflight_ring_drops_a_settled_batch():
    """Once the watcher has settled a batch and the caller has let go of
    it, nothing of the window refers to it any more."""
    from horovod_tpu_torch.ops.scheduler import InflightRing
    settled = threading.Event()
    ring = InflightRing(lambda results: None,
                        lambda batch, results, err: settled.set(), depth=2)
    try:
        batch, results = [torch.zeros(4)], (torch.zeros(1 << 10), None)
        refs = [weakref.ref(batch[0]), weakref.ref(results[0])]
        ring.submit(batch, results)
        assert settled.wait(5) and ring.flush(5)
        del batch, results
        t0 = time.time()
        while any(r() is not None for r in refs) and time.time() - t0 < 2:
            gc.collect()
            time.sleep(0.01)
        assert all(r() is None for r in refs)
    finally:
        ring.stop()


def test_torch_replicated_optimizer_is_collected(monkeypatch):
    """At a size above 1 the optimizer registers a hook on every
    parameter; dropped, it must be freed with its parameters."""
    import horovod_tpu_torch as hvd
    monkeypatch.setattr(basics, "size", lambda: 2)
    ps = [torch.zeros(8, requires_grad=True) for _ in range(3)]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1))
    assert opt._requires_update == set(ps)
    refs = [weakref.ref(opt)] + [weakref.ref(p) for p in ps]
    del opt, ps
    gc.collect()
    assert all(r() is None for r in refs)



def test_torch_functions_broadcast_object():
    """``from horovod_tpu_torch.functions import broadcast_object`` works,
    as ``horovod_tpu/torch/functions.py:88-90`` serves it, and broadcasts
    through ``mpi_ops`` (the package root exports the same call)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import functions, mpi_ops
    from horovod_tpu.torch import functions as ref
    assert "broadcast_object" in vars(ref)
    from horovod_tpu_torch.functions import broadcast_object
    seen = []

    def spy(obj, root_rank=0, name=None, process_set=None):
        seen.append((obj, root_rank, name, process_set))
        return obj

    mp = pytest.MonkeyPatch()
    mp.setattr(mpi_ops, "broadcast_object", spy)
    try:
        assert broadcast_object({"a": 1}, 0, name="n") == {"a": 1}
    finally:
        mp.undo()
    assert seen == [({"a": 1}, 0, "n", None)]
    hvd.init(device="cpu")
    try:
        assert functions.broadcast_object([3, "x"]) == [3, "x"]
    finally:
        hvd.shutdown()
