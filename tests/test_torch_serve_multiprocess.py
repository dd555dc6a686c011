"""The serving plane across processes on gloo (CPU), under the port's
launchers: the counterparts of ``tests/test_multiprocess.py:660-742``
(``tests/data/worker_serve.py`` and ``worker_serve_faults.py``), each on the
flat and the hierarchical control plane.

- ``--serve``: ``python -m horovod_tpu_torch.runner -np 2 --serve
  --serve-port P``.  Each rank reads ``serve`` and ``serve_port`` from its
  ``Config``; ``Replica.load`` fans rank 0's weights out (rank 1 starts
  from zeros and ends bitwise equal; the same version again runs no
  broadcast; version 2 re-broadcasts without a restart); a batch's rows
  are bitwise the rows served alone in the same bucket, and churn inside
  the bucket menu builds no new forward; the serving ``ScalePolicy`` goes
  hold → scale_out on a scripted ramp and scale_in on a collapse; then
  the worker side of ``--serve`` as the JAX workers build it
  (``ContinuousBatcher`` from the Config's knobs, ``FrontDoor`` on
  ``serve_port + rank``, ``serve_loop``) answers HTTP requests, bitwise
  equal across the ranks; last the drain: requests queued before it
  complete, new ones are refused (and 503 at the front door).
- The chaos scenario under the elastic driver with
  ``HVD_TPU_FAULT=replica_crash:1@3``: rank 1 dies inside its 3rd batch
  while 24 front-door requests are in flight; the survivor fails that
  batch retryably, keeps the queued ones, heals into a world of one, and
  every request ends with one 200, bitwise its reference: lost 0, retried
  4, requeued 8, availability 1.0, final size 1.
"""

import json
import os
import subprocess
import sys

import pytest

from horovod_tpu_torch.common.net import reserve_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMMON = r'''
import json, os, sys, threading, time, urllib.error, urllib.request
import numpy as np, torch
import horovod_tpu_torch as hvd


def apply_fn(params, x):
    # JSON carries the rows as float64: the same float32 values.
    return x.to(params["w"].dtype) @ params["w"] + params["b"]


def weights(seed):
    rng = np.random.RandomState(seed)
    return {"w": torch.from_numpy(rng.randn(16, 8).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(8).astype(np.float32))}


def zeros():
    return {"w": torch.zeros(16, 8), "b": torch.zeros(8)}
'''

SERVE_WORKER = _COMMON + r'''
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.elastic.autoscale import ScalePolicy
from horovod_tpu_torch.serve import (ContinuousBatcher, Draining, FrontDoor,
                                     Replica, parse_buckets)

hvd.init(device="cpu")
rank, world = hvd.rank(), hvd.size()
assert world == 2, world
cfg = Config.from_env()
assert cfg.serve is True and cfg.serve_port == int(sys.argv[1]), cfg

# Version-stamped fan-out: rank 1 starts from zeros.
rep = Replica(apply_fn, device="cpu")
assert rep.load(weights(1) if rank == 0 else zeros(), version=1) is True
for k, v in weights(1).items():
    assert torch.equal(rep.params[k], v), k
assert rep.load(weights(1), version=1) is False and rep.loads == 1
assert rep.load(weights(2) if rank == 0 else zeros(), version=2) is True
assert torch.equal(rep.params["w"], weights(2)["w"]) and rep.loads == 2

# A row's result is its own: bitwise the row alone in the same bucket.
x = np.random.RandomState(100 + rank).randn(8, 16).astype(np.float32)
batched = rep.forward(x)
seq = []
for i in range(8):
    alone = np.zeros_like(x)
    alone[0] = x[i]
    seq.append(rep.forward(alone)[0])
assert np.array_equal(batched, np.stack(seq))
misses = rep.cache.misses
for n in (3, 5, 7, 2, 6, 8):
    rep.forward(x[:n])
assert rep.cache.misses - misses <= 2, rep.cache.misses - misses

# The serving policy: a ramp scales out, a collapse scales in.
pol = ScalePolicy(min_np=1, max_np=4, persistence=2, cooldown_s=5.0,
                  idle_s=10.0, rate_high=100.0, idle_qps=5.0)
size, clock, actions = 2, 0.0, []
for rate in [80.0] * 2 + [350.0] * 3 + [1.0] * 8:
    clock += 6.0
    d = pol.observe({"request_rate": rate, "queue_depth": 0}, size=size,
                    now=clock)
    actions.append(d.action)
    if d.target_size is not None:
        size = d.target_size
    if d.action == "scale_in":
        break
assert "scale_out" in actions and "scale_in" in actions, actions

# The worker side of --serve: the Config's knobs, this rank's front door.
buckets = parse_buckets(cfg.serve_buckets, cfg.serve_max_batch)
assert buckets == (4,), buckets
batcher = ContinuousBatcher(cfg.serve_max_batch, buckets,
                            cfg.serve_deadline_ms,
                            cfg.serve_max_inflight or cfg.max_inflight,
                            cfg.serve_queue_depth)
door = FrontDoor(batcher, port=cfg.serve_port + rank).start()
assert door.port == cfg.serve_port + rank
stop = threading.Event()
loop = threading.Thread(target=rep.serve_loop, args=(batcher, stop),
                        daemon=True)
loop.start()
xs = np.random.RandomState(7).randn(8, 16).astype(np.float32)
answers = [None] * 8


def post(i):
    req = urllib.request.Request(
        f"http://127.0.0.1:{door.port}/v1/infer",
        data=json.dumps({"inputs": xs[i].tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        answers[i] = (r.status, json.loads(r.read())["outputs"])


clients = [threading.Thread(target=post, args=(i,)) for i in range(8)]
for c in clients:
    c.start()
for c in clients:
    c.join(60)
assert all(a is not None and a[0] == 200 for a in answers), answers
got = np.asarray([a[1] for a in answers], np.float32)
ref = []
for i in range(8):
    alone = np.zeros((4, 16), np.float32)
    alone[0] = xs[i]
    ref.append(rep.forward(alone)[0])
assert np.array_equal(got, np.stack(ref))
both = hvd.allgather_object(got.tobytes())
assert both[0] == both[1]
stats = door.stats()
assert stats["responses_ok_total"] == 8, stats
door.drain()
try:
    urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{door.port}/v1/infer",
        data=json.dumps({"inputs": xs[0].tolist()}).encode(),
        headers={"Content-Type": "application/json"}), timeout=30)
    raise AssertionError("a draining front door answered")
except urllib.error.HTTPError as exc:
    assert exc.code == 503, exc.code
stop.set()
loop.join(30)
door.stop()

# The drain with work in flight: queued before it, completed after it.
batcher = ContinuousBatcher(max_batch=4, deadline_ms=10000.0,
                            max_inflight=2)
inflight = [batcher.submit(x[i]) for i in range(8)]
batcher.drain()
try:
    batcher.submit(x[0])
    raise AssertionError("a draining batcher admitted new work")
except Draining:
    pass
assert rep.serve_loop(batcher) == 2
got = np.stack([r.wait(0.0) for r in inflight])
assert np.array_equal(got, np.concatenate([rep.forward(x[:4]),
                                           rep.forward(x[4:8])]))
hvd.barrier()
print(f"SERVE_OK rank={rank} loads={rep.loads} port={door.port} "
      f"p50={stats['latency_p50_ms']} p99={stats['latency_p99_ms']}",
      flush=True)
hvd.shutdown()
'''

FAULT_WORKER = _COMMON + r'''
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HostsUpdatedInterrupt)
from horovod_tpu_torch.serve import (CircuitBreaker, ContinuousBatcher,
                                     FrontDoor, Replica)

RESULT = sys.argv[1]
NREQ, BUCKET, DEADLINE_MS = 24, 4, 90000.0


class ProbedReplica(Replica):
    """A batch rides an allreduce of zeros: world-size invariant, but a
    dead peer now fails the batch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.probes = 0

    def forward_batch(self, batch):
        self.probes += 1
        probe = hvd.allreduce(torch.zeros(1), name=f"serve.sync.{self.probes}",
                              op=hvd.Sum)
        assert torch.equal(probe.reshape(1), torch.zeros(1))
        return super().forward_batch(batch)


hvd.init(device="cpu")
rank = hvd.rank()
assert hvd.size() == 2, hvd.size()
rep = ProbedReplica(apply_fn, device="cpu")
assert rep.load(weights(1) if rank == 0 else zeros(), version=1) is True
batcher = ContinuousBatcher(max_batch=BUCKET, buckets=(BUCKET,),
                            deadline_ms=DEADLINE_MS, max_inflight=1,
                            queue_depth=64)
door = FrontDoor(batcher, retries=4, hedge_ms=0.0,
                 breaker=CircuitBreaker(threshold=10000))
x = np.random.RandomState(7).randn(NREQ, 16).astype(np.float32)
ref = []
for i in range(NREQ):
    alone = np.zeros((BUCKET, 16), np.float32)
    alone[0] = x[i]
    ref.append(rep.forward(alone)[0])
ref = np.stack(ref)
outcomes = [None] * NREQ


def client(i):
    outcomes[i] = door.infer_detailed(x[i], deadline_ms=DEADLINE_MS,
                                      request_id=f"req-{i}")


threads = [threading.Thread(target=client, args=(i,), daemon=True)
           for i in range(NREQ)]
for t in threads:
    t.start()
t0 = time.monotonic()
while batcher.pending() < NREQ:
    assert time.monotonic() - t0 < 60, batcher.pending()
    time.sleep(0.005)
stop = threading.Event()


def watcher():
    for t in threads:
        t.join()
    stop.set()


threading.Thread(target=watcher, daemon=True).start()
faults, batches, t_fault, t_ready = [], 0, None, None
while True:
    try:
        batches += rep.serve_loop(batcher, stop=stop, poll_s=0.05,
                                  fault_grace_s=10.0)
        break
    except (HorovodInternalError, HostsUpdatedInterrupt) as verdict:
        t_fault = time.monotonic()
        faults.append([type(verdict).__name__,
                       list(getattr(verdict, "dead_ranks", []))])
        basics.shutdown()
        basics.init(device="cpu")
        assert rep.load(rep.params, version=rep.version) is False
        assert rep.loads == 1, rep.loads
        t_ready = time.monotonic()
for t in threads:
    t.join(timeout=120)
lost = sum(1 for o in outcomes if o is None)
assert lost == 0, lost
assert sorted({o["_code"] for o in outcomes}) == [200], outcomes
got = np.stack([np.asarray(o["outputs"], np.float32) for o in outcomes])
assert np.array_equal(got, ref)
retried = [o for o in outcomes if o["attempts"] > 1]
assert all(o["attempts"] == 2 for o in retried), retried
st = door.stats()
assert faults and st["replica_faults_total"] == 1, (faults, st)
tmp = RESULT + ".tmp"
with open(tmp, "w") as fh:
    json.dump({"ok": True, "lost": lost, "retried": len(retried),
               "batches": batches, "final_size": hvd.size(),
               "faults": faults, "requeued": st["requeued_total"],
               "retries_total": st["retries_total"],
               "quarantined": st["quarantined_total"],
               "responses_ok": st["responses_ok_total"],
               "availability": st["availability"],
               "recovery_s": round(t_ready - t_fault, 3)}, fh)
os.replace(tmp, RESULT)
print("SERVE_FAULTS_OK", flush=True)
hvd.shutdown()
'''


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("HVD_TPU_FAULT", "HOROVOD_TIMELINE"):
        env.pop(k, None)
    return env


@pytest.mark.parametrize("controller", ["flat", "hierarchical"])
def test_torch_serve_under_the_launcher(tmp_path, controller):
    worker = tmp_path / "serve_worker.py"
    worker.write_text(SERVE_WORKER)
    # Rank r's front door listens on P + r.
    with reserve_ports(2, consecutive=True) as held:
        port = held.ports[0]
        env = _env()
        env.update(HOROVOD_SERVE_BUCKETS="4", HOROVOD_SERVE_MAX_BATCH="4",
                   HOROVOD_SERVE_DEADLINE_MS="30000")
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
               "--serve", "--serve-port", str(port)]
        if controller == "hierarchical":
            cmd.append("--hierarchical-controller")
        cmd += [sys.executable, str(worker), str(port)]
        res = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                             capture_output=True, text=True, timeout=180)
    assert res.returncode == 0 and res.stdout.count("SERVE_OK") == 2, (
        f"rc={res.returncode}\nstdout:\n{res.stdout[-3000:]}\n"
        f"stderr:\n{res.stderr[-3000:]}")
    ports = sorted(int(w.split("=")[1]) for w in res.stdout.split()
                   if w.startswith("port="))
    assert ports == [port, port + 1]


@pytest.mark.parametrize("controller", ["flat", "hierarchical"])
def test_torch_serve_fault_recovery_under_the_elastic_driver(tmp_path,
                                                             controller):
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("localhost:1\n127.0.0.1:1\n")
    worker = tmp_path / "fault_worker.py"
    worker.write_text(FAULT_WORKER)
    result = tmp_path / "result.json"
    env = _env()
    env.update(HVD_TPU_FAULT="replica_crash:1@3",
               HOROVOD_ROUND_TIMEOUT_S="30")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "--host-discovery-script", f"cat {hosts}", "--min-np", "1",
           "--max-np", "2"]
    if controller == "hierarchical":
        cmd.append("--hierarchical-controller")
    cmd += [sys.executable, str(worker), str(result)]
    res = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0 and result.exists(), (
        f"rc={res.returncode}\nstdout:\n{res.stdout[-3000:]}\n"
        f"stderr:\n{res.stderr[-3000:]}")
    data = json.loads(result.read_text())
    assert data["ok"] and data["lost"] == 0, data
    assert data["retried"] == 4 and data["retries_total"] == 4, data
    assert data["requeued"] == 8, data
    assert data["quarantined"] == 0 and data["responses_ok"] == 24, data
    assert data["availability"] == 1.0, data
    assert data["final_size"] == 1, data
    assert data["faults"], data
    assert data["recovery_s"] < 60, data
