"""The port's serving plane on the CPU: ``Replica`` behind the copied
``ContinuousBatcher`` answers with the tokens a direct ``generate`` gives,
the per-bucket forward cache misses once per bucket, a repeated version is
a no-op, failures route as in the JAX replica (an untyped failure waits up
to ``fault_grace_s`` for the engine's fault, as the JAX replica does on the
same stub engine), and ``broadcast_parameters`` fans weights out over a
real two-process gloo world.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import PeerFailureError
from horovod_tpu_torch.common.net import reserve_ports
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.serve import (ContinuousBatcher, ForwardFailed,
                                     FrontDoor, ReplicaFaulted, Replica)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_NEW = 4


@pytest.fixture(scope="module")
def model():
    cfg = tl.tiny(dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params


def _apply(cfg):
    def apply_fn(params, prompts):
        return tl.generate(params, prompts, N_NEW, cfg)
    return apply_fn


def _prompts(n, T=12, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, T)).astype(
        np.int32)


def _serve(replica, batcher, prompts):
    stop = threading.Event()
    th = threading.Thread(target=replica.serve_loop, args=(batcher, stop),
                          daemon=True)
    th.start()
    try:
        reqs = [batcher.submit(p, deadline_ms=60000) for p in prompts]
        return [r.wait(timeout=60) for r in reqs]
    finally:
        stop.set()
        th.join(timeout=30)


def test_torch_replica_serves_generate_tokens(model):
    cfg, params = model
    rep = Replica(_apply(cfg), device="cpu")
    assert rep.load(params, version=1)
    prompts = _prompts(5)
    batcher = ContinuousBatcher(max_batch=8, buckets=(1, 2, 4, 8),
                                max_inflight=1)
    out = _serve(rep, batcher, prompts)
    direct = tl.generate(params, torch.from_numpy(prompts), N_NEW, cfg)
    np.testing.assert_array_equal(np.stack(out), direct.numpy())
    assert batcher.stats()["requests_total"] == 5


def test_torch_replica_bucket_cache_misses_once_per_bucket(model):
    cfg, params = model
    rep = Replica(_apply(cfg), device="cpu")
    rep.load(params, version=1)
    for n in (1, 3, 2, 4, 3, 1):      # buckets 1, 4, 2, 4, 4, 1
        assert rep.forward(_prompts(n)).shape == (n, N_NEW)
    assert rep.cache.misses == 3 and rep.cache.hits == 3


def test_torch_replica_row_position_invariant(model):
    """A request's tokens depend only on its own row: the same prompt at
    two row positions of one bucket gives identical tokens."""
    cfg, params = model
    rep = Replica(_apply(cfg), device="cpu")
    rep.load(params, version=1)
    x = _prompts(4, seed=1)
    x[3] = x[0]
    out = rep.forward(x)
    np.testing.assert_array_equal(out[0], out[3])


def test_torch_replica_versioned_load(model):
    cfg, params = model
    rep = Replica(_apply(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="before load"):
        rep.forward(_prompts(1))
    assert rep.load(params, version=2)
    assert not rep.load(params, version=2)      # re-delivery: no-op
    assert not rep.load(params, version=1)      # stale: no-op
    assert rep.loads == 1 and rep.version == 2
    params2 = tl.init_params(cfg, torch.Generator().manual_seed(1))
    assert rep.load(params2, version=3)
    assert rep.params is params2 and rep.loads == 2


def test_torch_replica_routes_failures(model):
    """An application error fails its batch retryably and the loop keeps
    serving; a typed peer fault fails the batch as ReplicaFaulted and
    re-raises for the re-rendezvous."""
    cfg, params = model
    calls = {"n": 0}

    def flaky(p, x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("boom")
        if calls["n"] == 3:
            raise PeerFailureError("peer 1 died")
        return x[:, :1]

    rep = Replica(flaky, device="cpu")
    rep.load(params, version=1)
    b = ContinuousBatcher(max_batch=2, max_inflight=1)
    r1 = b.submit(_prompts(1)[0], deadline_ms=60000)
    stop = threading.Event()
    th = threading.Thread(target=rep.serve_loop, args=(b, stop), daemon=True)
    th.start()
    with pytest.raises(ForwardFailed):
        r1.wait(timeout=30)
    r2 = b.submit(_prompts(1)[0], deadline_ms=60000)
    assert r2.wait(timeout=30).shape == (1,)
    stop.set()
    th.join(timeout=30)
    r3 = b.submit(_prompts(1)[0], deadline_ms=60000)
    with pytest.raises(PeerFailureError):
        rep.serve_loop(b)
    with pytest.raises(ReplicaFaulted):
        r3.wait(timeout=5)


class _LatchingEngine:
    """An engine whose fault latches ``after`` seconds after it is made
    (never when ``after`` is None)."""

    def __init__(self, fault, after):
        self._fault = fault
        self._at = None if after is None else time.monotonic() + after

    @property
    def fault(self):
        if self._at is not None and time.monotonic() >= self._at:
            return self._fault
        return None


@pytest.mark.parametrize("latch", [0.2, None], ids=["latched", "never"])
@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_torch_replica_waits_for_the_engine_fault(monkeypatch, impl, latch):
    """A forward that fails with an untyped error while the engine's fault
    latches within ``fault_grace_s``: the batch fails retryably and the
    fault is re-raised.  With no fault in the grace window it is an
    application error, and the loop goes on.  The JAX replica and the
    port's, on the same stub engine."""
    if impl == "jax":
        from horovod_tpu import serve
        from horovod_tpu.common import basics
        from horovod_tpu.common.exceptions import PeerFailureError as Fault
    else:
        import horovod_tpu_torch.serve as serve
        from horovod_tpu_torch.common import basics
        Fault = PeerFailureError
    fault = Fault("peer 1 died")
    eng = _LatchingEngine(fault, latch)
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "_get_state",
                        lambda: types.SimpleNamespace(engine=eng))
    rep = serve.Replica(lambda p, x: x)

    def broken(batch):
        raise RuntimeError("the in-flight collective failed")
    rep.forward_batch = broken
    b = serve.ContinuousBatcher(max_batch=2, max_inflight=1)
    req = b.submit(_prompts(1)[0], deadline_ms=60000)
    if latch is not None:
        with pytest.raises(Fault) as info:
            rep.serve_loop(b, fault_grace_s=5.0)
        assert info.value is fault
        with pytest.raises(serve.ReplicaFaulted):
            req.wait(timeout=5)
    else:
        stop = threading.Event()
        stop.set()
        t0 = time.monotonic()
        assert rep.serve_loop(b, stop, fault_grace_s=0.3) == 0
        assert time.monotonic() - t0 >= 0.3
        with pytest.raises(serve.ForwardFailed):
            req.wait(timeout=5)


def test_torch_frontdoor_http_into_replica(model):
    """POST /v1/infer through the copied front door reaches the port's
    replica and returns the tokens a direct generate gives."""
    cfg, params = model
    rep = Replica(_apply(cfg), device="cpu")
    rep.load(params, version=1)
    b = ContinuousBatcher(max_batch=4, buckets=(1, 2, 4), max_inflight=1,
                          deadline_ms=60000)
    fd = FrontDoor(b, port=0, addr="127.0.0.1").start()
    stop = threading.Event()
    th = threading.Thread(target=rep.serve_loop, args=(b, stop), daemon=True)
    th.start()
    try:
        for p in _prompts(2, seed=3):
            req = urllib.request.Request(
                f"http://127.0.0.1:{fd.port}/v1/infer",
                data=json.dumps({"inputs": p.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            out = json.loads(urllib.request.urlopen(req, timeout=60).read())
            direct = tl.generate(params, torch.from_numpy(p[None]), N_NEW,
                                 cfg)
            assert out["outputs"] == direct[0].tolist()
        assert fd.stats()["responses_ok_total"] == 2
    finally:
        stop.set()
        th.join(timeout=30)
        fd.stop()
    assert not th.is_alive()


_BCAST_WORKER = textwrap.dedent("""
    import sys, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    r = hvd.rank()
    params = {"layers": [{"w": torch.full((3, 2), float(r + 1))}],
              "b": torch.arange(4, dtype=torch.float32) * (r + 1)}
    out = hvd.broadcast_parameters(params, root_rank=0)
    assert hvd.size() == 2
    assert torch.equal(out["layers"][0]["w"], torch.ones(3, 2))
    assert torch.equal(out["b"], torch.arange(4, dtype=torch.float32))
    hvd.shutdown()
    print("BCAST_OK", r)
""")


def test_torch_broadcast_parameters_two_process_gloo(tmp_path):
    script = tmp_path / "bcast.py"
    script.write_text(_BCAST_WORKER)
    with reserve_ports(2) as held:
        port, port2 = held.ports
        procs = []
        for r in range(2):
            env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                       HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                       HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                       HOROVOD_CONTROLLER_PORT=str(port),
                       HOROVOD_CONTROLLER_PORT2=str(port2))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), REPO], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=60)[0])
            finally:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"BCAST_OK {r}" in out, out


def test_torch_broadcast_parameters_single_process_is_identity():
    hvd.init(device="cpu")
    params = {"w": torch.ones(2)}
    assert hvd.broadcast_parameters(params) is params
    assert hvd.broadcast_optimizer_state(params) is params
