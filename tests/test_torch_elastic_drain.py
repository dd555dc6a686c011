"""Drains, the autoscaler and the two-level control plane end to end under
the port, on gloo (CPU), with loopback host entries.

- The launcher with ``--hierarchical-controller --autoscale
  --monitor-port``: two workers train a few steps of a small
  ``DistributedOptimizer(AdamW)`` model under ``TorchState`` and
  ``@hvd.elastic.run``, commit, then idle; the driver's policy reads the
  idleness from rank 0's ``/health`` and scales in: commit request, cordon,
  DRAIN, the scale command.  The drained worker leaves cleanly and exits 0,
  the survivor re-forms alone (size 1) through the same host agent, the
  launcher's rc is 0.
- The API driver (``ElasticDriver`` with a ``HostDiscoveryScript``
  subclass whose notices come from a file) over hosts ``127.0.0.1:2`` and
  ``127.0.0.2:1``: a preemption notice for the second host drains it after
  an acked commit request; no rank sees a ``PeerFailureError``; the two
  survivors continue from their live state (no step lost) and one agent
  object serves host 0 in every generation; when the notice clears, the
  host is un-cordoned and a fresh worker there restores from a peer.
- A static ``-np 3`` launch with ``--hierarchical-controller`` on
  ``127.0.0.1:2,127.0.0.2:1``: allreduce (sum, average), allgather and
  broadcast results are bitwise equal to the flat control plane's, and
  host 0's agent carries its two ranks on the aggregate warm path.
"""

import json
import os
import subprocess
import sys

import numpy as np

from horovod_tpu_torch.common.net import free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import json, os, sys, time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics

out, scenario, notice, hosts = sys.argv[1:5]
me = os.environ["HOROVOD_HOSTNAME"]
ident = f"{me}.{os.environ['HOROVOD_LOCAL_RANK']}"
log = open(os.path.join(out, f"{ident}.{os.getpid()}.jsonl"), "a")


def rec(**kw):
    kw["t"] = time.time()
    log.write(json.dumps(kw) + "\n")
    log.flush()


def agent():
    a = basics._get_state().host_agent
    return None if a is None else dict(id=id(a), port=a.port,
                                       **vars(a.stats))


torch.manual_seed(0)
model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                            torch.nn.Linear(16, 2))
# Before init(): torch's first optimizer imports its compiler stack, which
# takes seconds on a loaded host, and from init() on the autoscaler reads
# a fleet with no dispatches as idle.
inner = torch.optim.AdamW(model.parameters(), lr=1e-2)
hvd.init(device="cpu")
opt = hvd.DistributedOptimizer(inner,
                               named_parameters=model.named_parameters())
state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0)
# A rollback (the wrapper's answer to HorovodInternalError) is recorded.
_restore = state.restore


def restore():
    rec(ev="rollback", step=state.step)
    return _restore()


state.restore = restore
# Each generation trains from the step it enters at to the next stop.
STOPS = {0: 3, 3: 5, 5: 7}


def checksum():
    return [float(p.double().sum()) for p in model.parameters()]


@hvd.elastic.run
def train(state):
    size, rank = hvd.size(), hvd.rank()
    plane = state._stateplane
    rec(ev="enter", size=size, rank=rank, step=state.step,
        sums=checksum(), agent=agent(), source=plane.last_restore_source,
        disk_reads=plane.disk_reads)
    total = STOPS[state.step]
    while state.step < total:
        g = torch.Generator().manual_seed(100 * state.step + rank)
        x, y = torch.randn(4, 8, generator=g), torch.randn(4, 2, generator=g)
        opt.zero_grad()
        torch.nn.functional.mse_loss(model(x), y).backward()
        opt.step()
        state.step += 1
        s = checksum()
        every = hvd.allgather_object(s) if size > 1 else [s]
        eng = basics._get_state().engine
        rec(ev="step", step=state.step, size=size, rank=rank, sums=s,
            same=all(e == s for e in every), disp=eng.pipeline_dispatches,
            cycles=eng.cycle_count)
        if state.step == 1:
            state.commit()
    if state.step == 7 or (state.step == 5 and scenario == "autoscale"):
        return "done"
    if scenario == "preempt" and rank == 0 and state.step == 3:
        with open(notice, "w") as fh:
            fh.write("127.0.0.2\n")
    if scenario == "preempt" and state.step == 5:
        # What a growth's sync hands every rank is the last commit.
        state.commit()
    if scenario == "preempt" and rank == 0 and state.step == 5:
        # The preempted machine's life: it leaves the discovered set (for
        # longer than the driver's flap grace), its notice clears, and it
        # comes back under the same address.
        with open(hosts) as fh:
            listed = fh.read()
        with open(hosts, "w") as fh:
            fh.write(listed.splitlines()[0] + "\n")
        with open(notice, "w") as fh:
            fh.write("")
        time.sleep(4)
        with open(hosts, "w") as fh:
            fh.write(listed)
    # Idle: only what the driver asks for (a commit request lands before
    # the drain that follows it).
    t_end = time.time() + 90
    probe = time.time() + 1
    while time.time() < t_end:
        if probe and time.time() > probe:
            eng = basics._get_state().engine
            rec(ev="idle", disp=eng.pipeline_dispatches,
                cycles=eng.cycle_count)
            probe = None
        if state.should_commit():
            # commit() ends with the update check: the drain may raise
            # from it.
            rec(ev="commit_on_request", step=state.step)
            state.commit()
        state.check_host_updates()
        time.sleep(0.05)
    raise RuntimeError("never drained")


res = train(state)
rec(ev="done", step=state.step, res=res, agent=agent(),
    initialized=hvd.is_initialized())
if hvd.is_initialized():
    hvd.shutdown()
'''

DRIVER = r'''
import json, sys
from horovod_tpu_torch.elastic.discovery import HostDiscoveryScript
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.runner.run import parse_args, tuning_env

hosts, notice, result, logs = sys.argv[1:5]
argv = sys.argv[5:]


class Notices(HostDiscoveryScript):
    def preemption_notices(self):
        try:
            with open(notice) as fh:
                return {ln.strip() for ln in fh if ln.strip()}
        except FileNotFoundError:
            return set()


args = parse_args(["--host-discovery-script", "x", "--min-np", "1",
                   "--max-np", "3", "--hierarchical-controller",
                   "--ckpt-dir", logs + "/ckpt", *argv])
d = ElasticDriver(Notices(f"cat {hosts}"), args.command, min_np=1, max_np=3,
                  env=tuning_env(args), output_filename=logs, verbose=1,
                  preempt_grace_s=30.0)
left = []
record_left = d.registry.record_left
d.registry.record_left = lambda i: (left.append(i), record_left(i))[1]
rc = d.run()
with open(result, "w") as fh:
    json.dump(dict(rc=rc, events=d.events, left=left,
                   blacklisted=[h for h in ("127.0.0.1", "127.0.0.2")
                                if d.registry.is_blacklisted(h)]), fh)
sys.exit(rc)
'''


def _logs(out):
    """Each worker process's records, by identity (``<host>.<local
    rank>``), in the order the processes started."""
    procs = {}
    for f in out.iterdir():
        recs = [json.loads(x) for x in f.read_text().splitlines()
                if x.strip()]
        procs.setdefault(f.name.rsplit(".", 2)[0], []).append(recs)
    return {i: [r for p in sorted(ps, key=lambda p: p[0]["t"]) for r in p]
            for i, ps in procs.items()}


def _stderr(logs_dir):
    text = ""
    for root, _, names in os.walk(logs_dir):
        for n in names:
            if n in ("stderr", "stdout"):
                with open(os.path.join(root, n)) as fh:
                    text += fh.read()
    return text


def _setup(tmp_path, slots0=1):
    out = tmp_path / "out"
    out.mkdir()
    hosts = tmp_path / "hosts"
    hosts.write_text(f"127.0.0.1:{slots0}\n127.0.0.2:1\n")
    (tmp_path / "worker.py").write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env["PYTHONPATH"] = REPO
    return out, hosts, env


def _no_fault_seen(logs, text):
    """No training function saw a fault: no rollback, no traceback.  (An
    idle host-mate of rank 0 may log an unattributed HVD303 warning when
    rank 0, which hosts the root and host 0's agent, re-rendezvouses
    first: its engine stops, nothing of it reaches the user.)"""
    assert not [e for recs in logs.values() for e in recs
                if e["ev"] == "rollback"]
    assert "Traceback" not in text and "PeerFailureError" not in text


def _check_gen1(logs, size):
    assert len(logs) == size, sorted(logs)
    for ident, recs in logs.items():
        enter = recs[0]
        assert enter["ev"] == "enter" and enter["size"] == size, recs
        steps = [e for e in recs if e["ev"] == "step" and e["step"] <= 3]
        assert [e["step"] for e in steps] == [1, 2, 3], (ident, recs)
        assert all(e["same"] for e in steps)
        # Every rank of generation 1 negotiates through its host's agent.
        if ident.endswith(".0"):
            assert enter["agent"]["generations"] == 1, enter


def test_torch_autoscale_scales_an_idle_fleet_in(tmp_path):
    out, hosts, env = _setup(tmp_path)
    mon, = free_ports(1)
    scaled = tmp_path / "scaled"
    env.update(HOROVOD_AUTOSCALE_IDLE_S="3", HOROVOD_AUTOSCALE_PERSISTENCE="2",
               HOROVOD_AUTOSCALE_COOLDOWN="1",
               HOROVOD_AUTOSCALE_STRAGGLER_FACTOR="50")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "--host-discovery-script", f"cat {hosts}", "--min-np", "1",
           "--max-np", "2", "--hierarchical-controller", "--autoscale",
           "--autoscale-interval", "0.5", "--monitor-port", str(mon),
           "--monitor-interval", "0.5", "--ckpt-dir", str(tmp_path / "ckpt"),
           "--commit-max-age-s", "600", "--scale-command",
           f'echo "$HVD_AUTOSCALE_ACTION $HVD_AUTOSCALE_HOST" >> {scaled}',
           "-v", "--output-filename", str(tmp_path / "logs"),
           sys.executable, str(tmp_path / "worker.py"), str(out), "autoscale",
           str(tmp_path / "notice"), str(hosts)]
    res = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=150)
    text = res.stderr + _stderr(tmp_path / "logs")
    assert res.returncode == 0, text[-6000:]
    logs = _logs(out)
    _check_gen1(logs, 2)
    assert "autoscale SCALE_IN: draining host 127.0.0.2" in text, text[-4000:]
    # Counted after the run, the drain over: one scale-in of 127.0.0.2, or
    # more where the drain outlived the 1 s cooldown and the policy decided
    # again (the reference driver does the same: ROADMAP queue 3), each
    # logged as a drain of the same host.
    lines = scaled.read_text().splitlines()
    assert lines and set(lines) == {"scale_in 127.0.0.2"}, lines
    assert text.count("autoscale SCALE_IN: draining host 127.0.0.2") \
        == len(lines), text[-4000:]
    drained, survivor = logs["127.0.0.2.0"], logs["127.0.0.1.0"]
    assert any(e["ev"] == "commit_on_request" for e in drained), drained
    assert drained[-1]["ev"] == "done" and drained[-1]["res"] is None
    assert not drained[-1]["initialized"]
    # The survivor re-formed alone (no control plane at size 1: its agent
    # keeps its port, its generation ended).
    enters = [e for e in survivor if e["ev"] == "enter"]
    assert [e["size"] for e in enters] == [2, 1], enters
    assert enters[1]["agent"]["port"] == enters[0]["agent"]["port"]
    assert survivor[-1]["res"] == "done" and survivor[-1]["step"] == 5
    # The idle detector's input, the engine's dispatched batches, moves
    # with every step and stands still through idle cycles.
    steps = [e for e in survivor if e["ev"] == "step" and e["size"] == 2]
    idle = [e for e in survivor if e["ev"] == "idle"][0]
    assert all(b["disp"] > a["disp"] for a, b in zip(steps, steps[1:]))
    assert idle["disp"] == steps[-1]["disp"]
    assert idle["cycles"] > steps[-1]["cycles"], (idle, steps[-1])
    _no_fault_seen(logs, text)


def test_torch_preemption_notice_drains_through_the_api_driver(tmp_path):
    out, hosts, env = _setup(tmp_path, slots0=2)
    notice = tmp_path / "notice"
    (tmp_path / "driver.py").write_text(DRIVER)
    result = tmp_path / "result.json"
    cmd = [sys.executable, str(tmp_path / "driver.py"), str(hosts),
           str(notice), str(result), str(tmp_path / "logs"), sys.executable,
           str(tmp_path / "worker.py"), str(out), "preempt", str(notice),
           str(hosts)]
    res = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=150)
    text = res.stderr + _stderr(tmp_path / "logs")
    assert res.returncode == 0, text[-6000:]
    r = json.loads(result.read_text())
    assert r["rc"] == 0 and r["blacklisted"] == []
    assert r["left"] == ["127.0.0.2:0"], r
    actions = [e["action"] for e in r["events"]]
    assert actions[:2] == ["preempt_drain", "commit_request"], actions
    assert r["events"][0]["host"] == "127.0.0.2"
    assert sorted(r["events"][1]["acked"]) == [
        "127.0.0.1:0", "127.0.0.1:1", "127.0.0.2:0"], r["events"]
    logs = _logs(out)
    _check_gen1(logs, 3)
    host1 = logs["127.0.0.2.0"]
    drained = host1[:[e["ev"] for e in host1].index("done") + 1]
    assert any(e["ev"] == "commit_on_request" for e in drained), drained
    assert drained[-1]["res"] is None and not drained[-1]["initialized"]
    for ident in ("127.0.0.1.0", "127.0.0.1.1"):
        survivor = logs[ident]
        enters = [e for e in survivor if e["ev"] == "enter"]
        assert [e["size"] for e in enters] == [3, 2, 3], enters
        # No restore: generation 2 starts from the live state.
        step3 = [e for e in survivor if e["ev"] == "step"
                 and e["step"] == 3][0]
        assert enters[1]["source"] is None
        assert enters[1]["sums"] == step3["sums"]
        # No step lost: generation 2 starts where generation 1 ended, with
        # the parameters it ended with.
        last = [e for e in survivor if e["ev"] == "step"
                and e["step"] <= 3][-1]
        assert enters[1]["step"] == last["step"] == 3
        assert [e["step"] for e in survivor if e["ev"] == "step"
                and e["size"] == 2] == [4, 5]
        assert all(e["same"] for e in survivor if e["ev"] == "step")
        assert survivor[-1]["res"] == "done" and survivor[-1]["step"] == 7
    # One agent object served host 0 in every generation.
    a0 = [e["agent"] for e in logs["127.0.0.1.0"] if e["ev"] == "enter"]
    assert len({a["id"] for a in a0}) == 1
    assert len({a["port"] for a in a0}) == 1
    assert [a["generations"] for a in a0] == [1, 2, 3], a0
    assert a0[1]["agg_rounds"] > 0, a0
    assert logs["127.0.0.1.1"][0]["agent"] is None
    # The drained host came back: a fresh worker restored from a peer.
    joiner = host1[len(drained):]
    back = joiner[0]
    assert back["size"] == 3 and back["step"] == 5, joiner
    assert back["source"] == "peer" and back["disk_reads"] == 0, back
    assert [e["step"] for e in joiner if e["ev"] == "step"][-2:] == [6, 7]
    assert joiner[-1]["res"] == "done"
    _no_fault_seen(logs, text)


STATIC = r'''
import json, sys, time
import numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics

hvd.init(device="cpu")
r = hvd.rank()
rng = np.random.default_rng(7 + r)
outs = {}
for i in range(6):
    x = torch.from_numpy(rng.standard_normal(1000 + 37 * i)
                         .astype(np.float32))
    outs[f"sum{i}"] = hvd.allreduce(x, name=f"s{i}", op=hvd.Sum)
    outs[f"avg{i}"] = hvd.allreduce(x, name=f"a{i}", op=hvd.Average)
outs["gather"] = hvd.allgather(torch.full((2, 3), float(r)))
outs["bcast"] = hvd.broadcast(torch.arange(5.0) * (r + 1), root_rank=2)
# The warm steady state: the same allreduce again and again, and idle
# rounds, whose frames are alike on host 0's two ranks.
for _ in range(20):
    hvd.allreduce(torch.ones(4), name="warm", op=hvd.Sum)
# The agent drops a rank that leaves: read whom it serves before the
# allreduce that every rank must join before any can shut down.
a = basics._get_state().host_agent
ranks = None if a is None else list(a.ranks)
hvd.allreduce(torch.ones(1), name="read", op=hvd.Sum)
time.sleep(0.5)
np.savez(sys.argv[1] + f".{r}.npz",
         **{k: v.numpy() for k, v in outs.items()})
stats = None
if a is not None:
    # The agent's thread goes on with idle rounds and counts a round
    # before it sends the round's uplink: read the counters between two
    # rounds (a round without its uplink would never read equal).
    for _ in range(2000):
        stats = dict(vars(a.stats))
        if stats["uplink_frames"] == stats["rounds"]:
            break
        time.sleep(0.001)
with open(sys.argv[1] + f".{r}.json", "w") as fh:
    json.dump(None if a is None else dict(ranks=ranks, **stats), fh)
hvd.shutdown()
'''


def test_torch_hierarchical_controller_static_launch_is_bitwise_flat(
        tmp_path):
    (tmp_path / "w.py").write_text(STATIC)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env["PYTHONPATH"] = REPO
    got = {}
    for mode, flags in (("flat", []), ("hier", ["--hierarchical-controller"])):
        base = str(tmp_path / mode)
        res = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "3",
             "-H", "127.0.0.1:2,127.0.0.2:1", *flags, "--output-filename",
             str(tmp_path / f"logs_{mode}"), sys.executable,
             str(tmp_path / "w.py"), base], cwd=str(tmp_path), env=env,
            capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr + _stderr(
            tmp_path / f"logs_{mode}")[-4000:]
        got[mode] = [(dict(np.load(f"{base}.{r}.npz")),
                      json.loads(open(f"{base}.{r}.json").read()))
                     for r in range(3)]
    for r in range(3):
        flat, hier = got["flat"][r][0], got["hier"][r][0]
        assert sorted(flat) == sorted(hier)
        for k in flat:
            assert flat[k].tobytes() == hier[k].tobytes(), (r, k)
        assert got["flat"][r][1] is None
    agents = [got["hier"][r][1] for r in range(3)]
    assert agents[1] is None                     # local rank 1: a client
    assert agents[0]["ranks"] == [0, 1] and agents[2]["ranks"] == [2]
    assert agents[0]["agg_rounds"] > 0, agents[0]
    assert agents[0]["uplink_frames"] == agents[0]["rounds"], agents[0]
