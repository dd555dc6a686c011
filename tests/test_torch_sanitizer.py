"""The port's runtime sanitizer (``horovod_tpu_torch/analysis/
runtime_sanitizer.py``, installed by the engine from ``HVD_TPU_SANITIZER``)
held against the JAX package's on the CPU.

- In process: on the same submissions (JAX entries hold the rank-stacked
  array, the port's this rank's tensor) the two sanitizers give the same
  tags, ledger digests and content hashes, bfloat16 included (the same
  bits), the same per-set sequence numbers and the same rollback; the
  stall wrapper reports the ledger tail (HVD302).
- One gloo launch of two ranks through the port's launcher, with
  ``HVD_TPU_SANITIZER=hash``, ``HVD_TPU_SANITIZER_TIMEOUT=2``, the monitor
  on and ``HVD_TPU_SANITIZER_STATIC_INDEX`` set, covers: the cached path
  (no full announce once warm, equal ledgers on both ranks), namespacing
  per process set (rank 1 alone on its set, the world's sequence still
  aligned) with the static index's annotation, two tensors
  submitted in opposite orders (a ``NegotiationError`` naming both ranks,
  both call sites and ``seq=0:``, then an exact control sum), divergent
  content through one site (caught by the hash), an HVD302 report quoting
  the peer's ledger, and a joined rank's sequence kept aligned.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu.analysis import runtime_sanitizer as jrs
from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops.engine import CollectiveType as JCT
from horovod_tpu_torch.analysis import runtime_sanitizer as rs
from horovod_tpu_torch.ops import collectives as TC
from horovod_tpu_torch.ops.engine import CollectiveType as TCT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _JaxEntry:
    def __init__(self, name, arr, ps=0):
        self.name, self.tensor = name, arr[None]      # rank-stacked
        self.ctype, self.reduce_op = JCT.ALLREDUCE, JC.ReduceOp.AVERAGE
        self.process_set_id = ps


class _PortEntry:
    def __init__(self, name, t, ps=0):
        self.name, self.tensor = name, t               # this rank's
        self.ctype, self.reduce_op = TCT.ALLREDUCE, TC.ReduceOp.AVERAGE
        self.process_set_id = ps


def _cases():
    import ml_dtypes
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 1 << 16, (3, 5)).astype(np.uint16)
    f32 = rng.randn(4, 2).astype(np.float32)
    i64 = rng.randint(-9, 9, (7,)).astype(np.int64)
    return [("bf16", bits.view(ml_dtypes.bfloat16),
             torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16), 0),
            ("f32", f32, torch.from_numpy(f32), 0),
            ("i64", i64, torch.from_numpy(i64), 1),
            ("f32b", f32 * 2, torch.from_numpy(f32 * 2), 1)]


def test_torch_sanitizer_tags_digests_and_hashes_match_jax():
    js = jrs.CollectiveSanitizer(content_hash=True)
    ts = rs.CollectiveSanitizer(content_hash=True)
    jents = [_JaxEntry(n, a, ps) for n, a, _, ps in _cases()]
    tents = [_PortEntry(n, t, ps) for n, _, t, ps in _cases()]
    js.observe(jents, site="train.py:7")
    ts.observe(tents, site="train.py:7")
    assert [e.sanitizer_tag for e in tents] == \
        [e.sanitizer_tag for e in jents]
    assert [e.sanitizer_tag.split(";")[0] for e in tents] == \
        ["seq=0:0", "seq=0:1", "seq=1:0", "seq=1:1"]
    assert all(";h=" in e.sanitizer_tag for e in tents)
    assert [(r.seq, r.name, r.digest, r.site, r.process_set)
            for r in ts.ledger] == \
        [(r.seq, r.name, r.digest, r.site, r.process_set) for r in js.ledger]
    assert ts.ledger[0].digest == "allreduce|bfloat16|(3, 5)|AVERAGE"
    assert ts.render_tail(process_set=1) == js.render_tail(process_set=1)
    # A rejected push rolls back alike.
    ts.rollback(tents[2:])
    js.rollback(jents[2:])
    assert dict(ts._seq) == dict(js._seq) == {0: 2, 1: 0}
    assert [r.name for r in ts.ledgers[1]] == []
    # Synthesized (joined) entries advance the counter, without a hash.
    ts.observe_synthesized(_PortEntry("j", torch.zeros(2)))
    js.observe_synthesized(_JaxEntry("j", np.zeros(2, np.float32)))
    assert tents[0].sanitizer_tag != "" and ts._seq[0] == js._seq[0] == 3
    assert ts.ledger[-1].site == js.ledger[-1].site == "<joined:synthesized>"


def test_torch_sanitizer_stall_wrapper_reports_the_ledger():
    from horovod_tpu_torch.ops.scheduler import StallInspector
    s = rs.CollectiveSanitizer()
    e = _PortEntry("stuck", torch.zeros(2))
    s.observe([e], site="train.py:3")
    e.enqueue_time = 0.0
    wrapped = rs.SanitizerStallInspector(StallInspector(60.0, 0.001), s,
                                         warn_after_s=0.001)
    wrapped.peer_ledger_source = lambda: "rank 1 last submissions: #0 x"
    with pytest.raises(RuntimeError, match="HVD302") as ei:
        wrapped.check([e])
    assert "stuck" in str(ei.value) and "rank 1 last" in str(ei.value)


def test_torch_engine_installs_the_sanitizer_from_the_env(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    hvd.shutdown()
    monkeypatch.setenv("HVD_TPU_SANITIZER", "1")
    hvd.init(device="cpu")
    try:
        eng = basics._get_state().engine
        assert isinstance(eng.sanitizer, rs.CollectiveSanitizer)
        assert isinstance(eng.stall, rs.SanitizerStallInspector)
        hvd.allreduce(torch.ones(3), name="san.one")
        rec = eng.sanitizer.ledger[-1]
        assert (rec.seq, rec.name, rec.digest) == \
            (0, "san.one", "allreduce|float32|(3,)|AVERAGE")
        assert rec.site.startswith("test_torch_sanitizer.py:")
    finally:
        hvd.shutdown()
    monkeypatch.delenv("HVD_TPU_SANITIZER")
    hvd.init(device="cpu")
    try:
        assert basics._get_state().engine.sanitizer is None
    finally:
        hvd.shutdown()


_WORKER = r'''
import json, logging, os, sys, time
sys.path.insert(0, sys.argv[1])
from horovod_tpu_torch.analysis.whole_package import build_static_index
idx = os.path.join(sys.argv[2], "index.%s.json" % os.environ["HOROVOD_RANK"])
with open(idx, "w") as fh:
    json.dump(build_static_index([os.path.abspath(__file__)]), fh)
os.environ["HVD_TPU_SANITIZER_STATIC_INDEX"] = idx
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.controller import NegotiationError
from horovod_tpu_torch.utils.logging import get_logger

hvd.init(device="cpu")
r = hvd.rank()
st = basics._get_state()
eng, ctl = st.engine, st.controller
san = eng.sanitizer
assert san is not None and san.content_hash and san.static_index
records = []
handler = logging.Handler()
handler.emit = lambda rec: records.append(rec.getMessage())
get_logger().addHandler(handler)
out = {}

# 1. The cached path: once warm, no full announce; equal ledgers.
def step(k):
    hs = [hvd.allreduce_async(torch.full((4,), float(k + i)),
                              name="grad.%d" % i, op=hvd.Sum)
          for i in range(3)]
    return [hvd.synchronize(h) for h in hs]

for k in range(2):
    step(k)
full = ctl.cache_stats.full_announces
for k in range(2, 6):
    step(k)
    time.sleep(0.1)
out["full_announces_warm"] = ctl.cache_stats.full_announces - full
mine = [(e.seq, e.name, e.digest) for e in san.tail(18)]
theirs = hvd.allgather_object(mine)
out["ledgers_equal"] = theirs[0] == theirs[1] and len(mine) == 18

# 2. Namespacing per process set, with the static index's annotation.
ps = hvd.add_process_set([1])
if r == 1:  # hvd-lint: disable=HVD101 (the set's only member)
    hvd.allreduce(torch.ones(2), name="ps.a", process_set=ps)  # hvd-lint: disable=HVD101
view = san.tail(4, process_set=ps.process_set_id)
out["ps_view"] = [(e.seq, e.name) for e in view]
out["world_seq"] = san._seq[0]
out["static"] = "[static: " in san.render_tail()

# 3. Opposite orders (deliberate): caught with both sites.
a = torch.ones(4, dtype=torch.bfloat16)
b = torch.full((4,), 2.0, dtype=torch.bfloat16)
try:
    if r == 0:  # hvd-lint: disable=HVD101 (deliberate divergence)
        h1 = hvd.allreduce_async(a, op=hvd.Sum)  # hvd-lint: disable=HVD101
        h2 = hvd.allreduce_async(b, op=hvd.Sum)  # hvd-lint: disable=HVD101
    else:
        h2 = hvd.allreduce_async(b, op=hvd.Sum)  # hvd-lint: disable=HVD101
        h1 = hvd.allreduce_async(a, op=hvd.Sum)  # hvd-lint: disable=HVD101
    hvd.synchronize(h1)
    hvd.synchronize(h2)
    out["swap"] = "missed"
except NegotiationError as e:
    m = str(e)
    out["swap"] = all(s in m for s in ("ranks [0]", "ranks [1]", "seq=0:",
                                       "site=w.py:"))
    out["swap_sites"] = sorted(set(
        p.split(";")[0] for p in m.split("site=")[1:]))
ctl_sum = hvd.allreduce(torch.full((3,), 1.5), name="control", op=hvd.Sum)
out["control"] = ctl_sum.tolist()

# 4. Divergent content through one site: the hash tells.
try:
    hvd.allreduce(torch.full((4,), 1.0 + r), name="hash.t", op=hvd.Sum)
    out["hash"] = "missed"
except NegotiationError as e:
    out["hash"] = "h=" in str(e) and "ranks [1]" in str(e)

# 5. A stall past HVD_TPU_SANITIZER_TIMEOUT: the report quotes the peer.
if r == 1:  # hvd-lint: disable=HVD108 (rank 1 lags on purpose)
    time.sleep(4.0)
res = hvd.allreduce(torch.ones(4), name="stall.t", op=hvd.Sum)
report = [m for m in records if "HVD302" in m and "stall.t" in m]
out["stall"] = bool(report) and "rank 1 last submissions" in report[0] \
    if r == 0 else True

# 6. A joined rank's sequence stays aligned.
if r == 0:  # hvd-lint: disable=HVD101 (rank 1 has joined)
    hvd.allreduce(torch.ones(2), name="alone", op=hvd.Sum)  # hvd-lint: disable=HVD101
hvd.join()
# (Hash mode compares the contributions: gather what must be equal.)
seqs = hvd.allgather_object(san._seq[0])
after = hvd.allreduce(torch.ones(2), name="after.join", op=hvd.Sum)
out["join"] = seqs[0] == seqs[1] and after.tolist() == [2.0, 2.0]
with open(os.path.join(sys.argv[2], "out.%d.json" % r), "w") as fh:
    json.dump(out, fh)
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sanitizer")
    (tmp / "w.py").write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env.update(PYTHONPATH=REPO, HVD_TPU_SANITIZER="hash",
               HVD_TPU_SANITIZER_TIMEOUT="2", HOROVOD_MONITOR="1",
               HOROVOD_MONITOR_INTERVAL="0.2")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--output-filename", str(tmp / "logs"), sys.executable,
         str(tmp / "w.py"), REPO, str(tmp)], env=env, cwd=str(tmp),
        timeout=180)
    logs = ""
    for r in range(2):
        for f in ("stdout", "stderr"):
            p = tmp / "logs" / f"rank.{r}" / f
            if p.exists():
                logs += p.read_text()[-3000:]
    assert proc.returncode == 0, logs
    import json
    return [json.loads((tmp / f"out.{r}.json").read_text())
            for r in range(2)], logs


def test_torch_sanitizer_two_ranks(world):
    outs, logs = world
    for r, o in enumerate(outs):
        assert o["full_announces_warm"] == 0, (r, o)
        assert o["ledgers_equal"], (r, o)
        assert o["ps_view"] == ([[0, "ps.a"]] if r else []), (r, o)
        assert o["world_seq"] == outs[0]["world_seq"], outs
        assert o["static"], (r, o)
        assert o["swap"] is True, (r, o, logs)
        assert len(o["swap_sites"]) == 2, (r, o)
        assert o["control"] == [3.0, 3.0, 3.0], (r, o)
        assert o["hash"] is True, (r, o)
        assert o["stall"] is True, (r, o, logs)
        assert o["join"] is True, (r, o)
