"""Elastic jobs end to end under the port's launcher, on gloo (CPU).

Each test runs ``python -m horovod_tpu_torch.runner
--host-discovery-script "cat <hosts>" --min-np 1 --max-np 2 --ckpt-dir
<dir>`` over a tiny Llama (float32), ``DistributedOptimizer(AdamW)`` under
``TorchState`` and ``@hvd.elastic.run``, with loopback host entries; the
workers change the host file themselves at fixed steps, so that every run
takes the same generations:

- a SIGKILL: generation 1 (2 ranks) loses rank 1 in a step's backward;
  the survivor restores its last commit and trains alone (generation 2);
  then a third host joins and restores from the survivor's shard server,
  with no disk read (generation 3);
- growth then shrinkage by the discovery file: 1 → 2 → 1 ranks;
- ``DistributedOptimizer(sharded=True)`` across a resize 2 → 1 → 2: each
  rank's re-sliced shard is ``load_sharded_saveable``'s of the committed
  saveable, the saveable's state equals a replicated optimizer's twin, and
  a step after the resize keeps the sharded and replicated parameters
  equal.

In every generation of two ranks the parameters (and AdamW's state) are
bitwise equal across the ranks after every step (checksums exchanged with
``allgather_object`` and compared again from the logs).  Exact
comparisons throughout.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import json, os, sys, time
import numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.optimizer import load_sharded_saveable

out, hosts, scenario = sys.argv[1:4]
me = os.environ["HOROVOD_HOSTNAME"]
log = open(os.path.join(out, me + ".jsonl"), "a")


def rec(**kw):
    log.write(json.dumps(kw) + "\n")
    log.flush()


def write_hosts(names):
    tmp = hosts + ".new"
    with open(tmp, "w") as fh:
        fh.write("".join(n + ":1\n" for n in names))
    os.replace(tmp, hosts)


def wait_for_update(state):
    t_end = time.time() + 60
    while time.time() < t_end:
        state.check_host_updates()
        time.sleep(0.05)
    raise RuntimeError("no host update")


def sums(ts):
    return [float(t.double().sum()) for t in ts]


hvd.init(device="cpu")
cfg = tl.tiny(dtype=torch.float32, max_seq=32)
params = tl.init_params(cfg, torch.Generator().manual_seed(1))
named = list(tl.named_parameters(params))
opt = hvd.DistributedOptimizer(
    torch.optim.AdamW([t for _, t in named], lr=1e-2),
    named_parameters=named, sharded=(scenario == "sharded"))
step_fn = tl.make_train_step(cfg, opt)
extra = {}
if scenario == "sharded":
    twin = tl.init_params(cfg, torch.Generator().manual_seed(1))
    tnamed = [(f"twin.{k}", v) for k, v in tl.named_parameters(twin)]
    topt = hvd.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in tnamed], lr=1e-2),
        named_parameters=tnamed)
    twin_step = tl.make_train_step(cfg, topt)
    extra = dict(twin=twin, twin_opt=topt)
state = hvd.elastic.TorchState(params=params, optimizer=opt, step=0,
                               **extra)
TOTAL = {"kill": 7, "grow_shrink": 6, "sharded": 3}[scenario]
COMMITS = {"kill": (1, 3, 5, 7), "grow_shrink": (2, 4, 6),
           "sharded": (1, 2, 3)}[scenario]


def die(grad):
    import signal
    rec(ev="kill")
    os.kill(os.getpid(), signal.SIGKILL)


@hvd.elastic.run
def train(state):
    size, rank = hvd.size(), hvd.rank()
    plane = state._stateplane
    rec(ev="enter", size=size, rank=rank, step=state.step,
        source=plane.last_restore_source, disk_reads=plane.disk_reads,
        epoch=plane.epoch)
    if scenario == "sharded" and size == 1:
        # Alone with a world-2 sharded optimizer: no step; a third host
        # brings the world back to 2.
        write_hosts(["127.0.0.1", "127.0.0.3"])
        wait_for_update(state)
    if scenario == "sharded" and size == 2 and state.step == 2:
        # This rank's shards are the committed saveable's re-slice, and
        # the saveable's gathered state is the replicated twin's.
        saved = state._saved_state["optimizer"]
        got = load_sharded_saveable(saved, rank, 2)
        mine = opt.state_dict()["buckets"]
        same = all(torch.equal(m["state"][i][k], g["state"][i][k])
                   for m, g in zip(mine, got.inner_states)
                   for i in m["state"] for k in ("exp_avg", "exp_avg_sq"))
        tsd = topt.state_dict()["state"]
        twin_ok = True
        for sd, idxs in zip(saved["inner_states"], saved["plan"]["buckets"]):
            for j, i in enumerate(idxs):
                for k in ("exp_avg", "exp_avg_sq"):
                    ref = tsd[i][k].reshape(-1)
                    full = torch.as_tensor(sd["state"][j][k]).reshape(-1)
                    twin_ok = twin_ok and torch.equal(full[:ref.numel()],
                                                      ref)
        rec(ev="reslice", rank=rank, same=same, twin=twin_ok,
            n=sum(len(m["state"]) for m in mine))
    while state.step < TOTAL:
        rs = np.random.RandomState(100 * state.step + rank)
        toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 17))
                                .astype(np.int64))
        if scenario == "kill" and me == "127.0.0.2" and state.step == 3:
            dict(named)["layers.0.wq"].register_hook(die)
        loss = float(step_fn(params, toks[:, :-1], toks[:, 1:]))
        if scenario == "sharded":
            twin_step(state.twin, toks[:, :-1], toks[:, 1:])
        state.step += 1
        s = sums([t for _, t in named])
        if scenario != "sharded":
            s += sums([v for st in opt.state_dict()["state"].values()
                       for v in st.values() if torch.is_tensor(v)])
        every = hvd.allgather_object(s) if size > 1 else [s]
        rec(ev="step", step=state.step, size=size, rank=rank, loss=loss,
            sums=s, same=all(x == s for x in every),
            twin_same=(scenario != "sharded" or all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    named, tl.named_parameters(state.twin)))))
        if state.step in COMMITS:
            state.commit()
            rec(ev="commit", step=state.step, size=size,
                epoch=plane.epoch, digest=plane.memory_state()[2])
        if scenario == "kill" and size == 1 and state.step == 5:
            write_hosts(["127.0.0.1", "127.0.0.2", "127.0.0.3"])
            wait_for_update(state)
        if scenario == "grow_shrink" and rank == 0:
            if size == 1 and state.step == 2:
                write_hosts(["127.0.0.1", "127.0.0.2"])
                wait_for_update(state)
            if size == 2 and state.step == 4:
                write_hosts(["127.0.0.1"])
        if scenario == "grow_shrink" and size == 2 and state.step == 4:
            wait_for_update(state)
        if scenario == "sharded" and size == 2 and state.step == 2:
            if rank == 0:
                write_hosts(["127.0.0.1"])
            wait_for_update(state)


train(state)
rec(ev="done", step=state.step)
hvd.shutdown()
'''


def _run(tmp_path, scenario, first_hosts):
    out = tmp_path / "out"
    out.mkdir()
    hosts = tmp_path / "hosts"
    hosts.write_text("".join(h + ":1\n" for h in first_hosts))
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("HVD_TPU_FAULT", None)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "--host-discovery-script", f"cat {hosts}", "--min-np", "1",
           "--max-np", "2", "--ckpt-dir", str(tmp_path / "ckpt"), "-v",
           "--output-filename", str(tmp_path / "logs"), sys.executable,
           str(worker), str(out), str(hosts), scenario]
    res = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    logs = {}
    for f in out.iterdir():
        logs[f.stem] = [json.loads(x) for x in f.read_text().splitlines()
                        if x.strip()]
    return res, logs


def _gens(events):
    gens = []
    for e in events:
        if e["ev"] == "enter":
            gens.append(dict(enter=e, steps=[]))
        elif e["ev"] == "step" and gens:
            gens[-1]["steps"].append(e)
    return gens


def _bitwise(logs, gen_steps):
    """Every two-rank step: equal across ranks (exchanged and logged)."""
    for hosts, steps in gen_steps:
        for s in steps:
            recs = [[e for e in logs[h] if e["ev"] == "step"
                     and e["step"] == s] for h in hosts]
            assert all(r and r[0]["same"] for r in recs), (s, recs)
            assert recs[0][0]["sums"] == recs[1][0]["sums"]


def _why(res, logs):
    return res.stderr[-3000:] + json.dumps(logs)[-3000:]


def test_torch_elastic_sigkill_restore_and_peer_join(tmp_path):
    res, logs = _run(tmp_path, "kill", ["127.0.0.1", "127.0.0.2"])
    assert res.returncode == 0, _why(res, logs)
    g = _gens(logs["127.0.0.1"])
    assert [x["enter"]["size"] for x in g] == [2, 1, 2]
    assert [[s["step"] for s in x["steps"]] for x in g] == \
        [[1, 2, 3], [4, 5], [6, 7]]
    # The survivor restored step 3's commit, from its own memory.
    assert g[1]["enter"]["step"] == 3
    # The joiner restored step 5's commit from the survivor's server.
    j = _gens(logs["127.0.0.3"])
    assert j[0]["enter"]["step"] == 5
    assert (j[0]["enter"]["source"], j[0]["enter"]["disk_reads"]) == \
        ("peer", 0)
    commit5 = [e for e in logs["127.0.0.1"] if e["ev"] == "commit"
               and e["step"] == 5][0]
    assert j[0]["enter"]["epoch"] == commit5["epoch"]
    assert any(e["ev"] == "kill" for e in logs["127.0.0.2"])
    assert "127.0.0.2:0 failed rc=-9" in res.stderr
    _bitwise(logs, [(("127.0.0.1", "127.0.0.2"), [1, 2, 3]),
                    (("127.0.0.1", "127.0.0.3"), [6, 7])])


def test_torch_elastic_grow_then_shrink_by_discovery(tmp_path):
    res, logs = _run(tmp_path, "grow_shrink", ["127.0.0.1"])
    assert res.returncode == 0, _why(res, logs)
    g = _gens(logs["127.0.0.1"])
    assert [x["enter"]["size"] for x in g] == [1, 2, 1]
    assert [[s["step"] for s in x["steps"]] for x in g] == \
        [[1, 2], [3, 4], [5, 6]]
    b = _gens(logs["127.0.0.2"])
    assert b[0]["enter"]["step"] == 2
    assert (b[0]["enter"]["source"], b[0]["enter"]["disk_reads"]) == \
        ("peer", 0)
    assert "failed rc" not in res.stderr
    _bitwise(logs, [(("127.0.0.1", "127.0.0.2"), [3, 4])])


def test_torch_elastic_sharded_optimizer_across_a_resize(tmp_path):
    res, logs = _run(tmp_path, "sharded", ["127.0.0.1", "127.0.0.2"])
    assert res.returncode == 0, _why(res, logs)
    g = _gens(logs["127.0.0.1"])
    assert [x["enter"]["size"] for x in g] == [2, 1, 2]
    assert [[s["step"] for s in x["steps"]] for x in g] == \
        [[1, 2], [], [3]]
    c = _gens(logs["127.0.0.3"])
    assert (c[0]["enter"]["source"], c[0]["enter"]["step"]) == ("peer", 2)
    for h in ("127.0.0.1", "127.0.0.3"):
        sl = [e for e in logs[h] if e["ev"] == "reslice"]
        assert sl and sl[-1]["same"] and sl[-1]["twin"] and sl[-1]["n"], \
            (h, sl)
    for h in logs:
        for e in logs[h]:
            if e["ev"] == "step":
                assert e["twin_same"], (h, e)
    _bitwise(logs, [(("127.0.0.1", "127.0.0.2"), [1, 2]),
                    (("127.0.0.1", "127.0.0.3"), [3])])
