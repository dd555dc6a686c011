"""``init()`` after ``shutdown()`` in a static launcher world (CPU, gloo).

The JAX package keeps its ``jax.distributed`` client across
``shutdown()`` and re-initialises in the same launcher world; the port
keeps its ``torch.distributed`` world the same way
(``horovod_tpu_torch/common/basics.py``).  Each case launches worlds of
two ranks running ``tests/torch_reinit_worker.py``, each world under its
own timeout, so that a hang fails its case and does not stall the suite:

- the port's and the JAX package's worlds run the same
  seeded collectives through three generations (allreduce Sum and
  Average, allgather, broadcast, ragged alltoall, reducescatter, an
  allreduce on a process set added in the generation): every result equal
  in float32, exactly, and every auto-generated name;
- after each ``shutdown()`` as many process groups are alive as after
  the first, a mesh and a process set of generation 0 raise in
  generation 1, and an env naming another rank is refused;
- rank 0 held 2 s before each ``shutdown()`` while rank 1 re-inits at
  once (the race made certain), rank 1 held so while rank 0's coordinator
  closes under it, and ten times three worlds side by side with no hold;
- the two-level control plane (``--hierarchical-controller``) on one host
  and on two, its agents bound again each generation;
- a planted peer fault: the next ``init()`` raises within 10 s;
- a world that hangs (one rank of two started) reports its rank's stack;
- a rank whose control link died keeps the world when the peer's leave
  record is in the store or lands there within the wait, and not else;
- ``resnet_synthetic``, ``torch_mnist`` and ``llama_spmd`` in turn in one
  world, bitwise equal to each run alone in its own launch.

Worlds started together run side by side, each rank on one thread (a host
of 8 cores ran 8 ranks of 8 threads each, beside the rest of the suite).
A world killed at its timeout reports every rank's stacks, dumped by the
worker (``REINIT_TEST_STACKS_AFTER_S``) before the kill.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_example_runs import REPO, example_env

WORKER = os.path.join(REPO, "tests", "torch_reinit_worker.py")
# A world of two takes well under 20 s on its own; the limit only keeps a
# hung world from holding the suite.
WORLD_TIMEOUT_S = 120
# Each rank dumps its stacks this long after it started: before the kill.
STACKS_AFTER_S = WORLD_TIMEOUT_S - 20
GENS = 3
STAGGER_S = 2.0
EXAMPLES = ("resnet_synthetic", "torch_mnist", "llama_spmd")


def _port_cmd(out, *args, launcher_args=()):
    return [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
            *launcher_args, sys.executable, WORKER, "port", str(out), *args]


def _ref_cmd(out, *args):
    return [sys.executable, "-m", "horovod_tpu.runner.launch", "-np", "2",
            sys.executable, WORKER, "ref", str(out), *args]


def _run_all(worlds):
    """Start every ``{key: (cmd, env, out_dir)}`` world at once and wait
    for each under its timeout; ``{key: CompletedProcess}`` (rc None for a
    world that hung, after it was killed, with its ranks' stacks in
    ``stacks``).  Worlds run side by side get one thread a rank."""
    procs = {}
    for key, (cmd, env, out) in worlds.items():
        os.makedirs(out, exist_ok=True)
        env = dict(env, REINIT_TEST_STACKS_AFTER_S=str(STACKS_AFTER_S))
        if len(worlds) > 1:
            env.setdefault("OMP_NUM_THREADS", "1")
        procs[key] = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      start_new_session=True)
    done, deadline = {}, time.time() + WORLD_TIMEOUT_S
    for key, proc in procs.items():
        stacks = ""
        try:
            stdout, stderr = proc.communicate(
                timeout=max(1.0, deadline - time.time()))
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            stdout, stderr = proc.communicate()
            rc = None
            stacks = "".join(
                f"--- {f.name}\n{f.read_text()}"
                for f in sorted(pathlib.Path(worlds[key][2]).glob(
                    "stacks.rank*.txt")))
        done[key] = subprocess.CompletedProcess(proc.args, rc, stdout,
                                                stderr)
        done[key].stacks = stacks
    return done


def _ok(done):
    assert done.returncode == 0, (done.returncode, done.stdout[-3000:],
                                  done.stderr[-4000:], done.stacks)


def _load(out):
    """Each rank's results and record."""
    return [(dict(np.load(os.path.join(out, f"rank{r}.npz"))),
             json.load(open(os.path.join(out, f"rank{r}.json"))))
            for r in range(2)]


def _assert_equal_results(mine, theirs):
    for (a, _), (b, _) in zip(mine, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def ref_generations(tmp_path_factory):
    """The JAX package's world of three generations: ``[(results, record)]
    * 2``."""
    out = tmp_path_factory.mktemp("reinit_ref")
    done = _run_all({"ref": (_ref_cmd(out, "--gens", str(GENS)),
                             example_env(JAX_PLATFORMS="cpu"), out)})
    _ok(done["ref"])
    return _load(out)


@pytest.fixture(scope="module")
def port_generations(tmp_path_factory):
    """The port's world of three generations: ``[(results, record)] * 2``."""
    out = tmp_path_factory.mktemp("reinit_port")
    done = _run_all({"port": (_port_cmd(out, "--gens", str(GENS)),
                              example_env(), out)})
    _ok(done["port"])
    return _load(out)


def test_torch_reinit_results_equal_jax(port_generations, ref_generations):
    port, ref = port_generations, ref_generations
    assert len(port[0][0]) == GENS * 8
    _assert_equal_results(port, ref)


def test_torch_reinit_auto_names_equal_jax(port_generations,
                                           ref_generations):
    port, ref = port_generations, ref_generations
    for (_, a), (_, b) in zip(port, ref):
        assert len(a["names"]) == GENS and a["names"][0], a["names"]
        assert a["names"] == b["names"]
        # Every generation restarts the counters.
        assert a["names"][0] == a["names"][-1]


def test_torch_reinit_leaves_no_process_group(port_generations):
    for _, rec in port_generations:
        groups = rec["groups"]
        assert len(groups) == GENS and groups == [groups[0]] * GENS, groups
        # The kept world's default group alone.
        assert groups[0] == 1, groups


def test_torch_reinit_stale_mesh_and_set_raise(port_generations):
    for _, rec in port_generations:
        assert rec["stale"] == {"mesh": "RuntimeError",
                                "set": "ValueError"}, rec["stale"]


def test_torch_reinit_refuses_another_rank(port_generations):
    """The kept world is the one the env gave: an env naming another rank
    is refused."""
    for _, rec in port_generations:
        assert "a static world keeps its size and ranks" in rec["refused"], \
            rec["refused"]


@pytest.mark.parametrize("late", [0, 1], ids=["rank0-late", "rank1-late"])
def test_torch_reinit_staggered_shutdown(tmp_path, late, ref_generations):
    """One rank is still in the last generation, for 2 s, when the other
    calls ``init()`` again.  Rank 0 late: rank 1 meets its coordinator
    before it is bound again.  Rank 1 late: rank 0's coordinator closes
    under rank 1's idle engine, which must take that for rank 0's clean
    shutdown and keep the world."""
    done = _run_all({"port": (
        _port_cmd(tmp_path, "--gens", str(GENS)),
        example_env(REINIT_TEST_STAGGER_S=str(STAGGER_S),
                    REINIT_TEST_STAGGER_RANK=str(late)), tmp_path)})
    _ok(done["port"])
    _assert_equal_results(_load(tmp_path), ref_generations)


@pytest.mark.parametrize("launch", range(10))
def test_torch_reinit_repeated_launches(tmp_path, launch, ref_generations):
    """Three worlds side by side: the load under which a rank that left a
    group just made crashed its peer's ``new_group`` (generation 1's
    mesh, ``_port_stale``)."""
    outs = {f"port{i}": tmp_path / f"port{i}" for i in range(3)}
    done = _run_all({key: (_port_cmd(out, "--gens", "2"), example_env(), out)
                     for key, out in outs.items()})
    theirs = [({k: v for k, v in res.items() if k.startswith(("g0.", "g1."))},
               rec) for res, rec in ref_generations]
    for key, out in outs.items():
        _ok(done[key])
        _assert_equal_results(_load(out), theirs)


@pytest.mark.parametrize("hosts", ["localhost:2", "localhost:1,127.0.0.1:1"],
                         ids=["one-host", "two-hosts"])
def test_torch_reinit_hierarchical_controller(tmp_path, hosts,
                                              ref_generations):
    """Every rank's client goes through its host's agent, which the
    host's local rank 0 binds again in each generation."""
    done = _run_all({"port": (
        _port_cmd(tmp_path, "--gens", str(GENS),
                  launcher_args=("-H", hosts, "--hierarchical-controller")),
        example_env(), tmp_path)})
    _ok(done["port"])
    mine = _load(tmp_path)
    _assert_equal_results(mine, ref_generations)
    owners = [0] if hosts == "localhost:2" else [0, 1]
    for r, (_, rec) in enumerate(mine):
        assert rec["agent"] == [r in owners] * GENS, (r, rec["agent"])


def test_torch_reinit_after_peer_fault_raises(tmp_path):
    """A static world whose peer died cannot form again at its address:
    ``init()`` says so within 10 s instead of waiting for the dead peer."""
    from horovod_tpu_torch.common.net import free_ports
    p1, p2 = free_ports(2)
    worlds = {}
    for r in range(2):
        env = example_env(
            HOROVOD_RANK=str(r), HOROVOD_SIZE="2", HOROVOD_LOCAL_RANK="0",
            HOROVOD_LOCAL_SIZE="1", HOROVOD_CONTROLLER_ADDR="127.0.0.1",
            HOROVOD_CONTROLLER_PORT=str(p1),
            HOROVOD_CONTROLLER_PORT2=str(p2))
        worlds[r] = ([sys.executable, WORKER, "port", str(tmp_path),
                      "--fault"], env, tmp_path)
    done = _run_all(worlds)
    assert done[1].returncode == 13, done[1].stderr[-3000:]
    _ok(done[0])
    seen = json.load(open(tmp_path / "fault.json"))
    assert seen["allreduce"] == "PeerFailureError", seen
    assert seen["init"] == "RuntimeError", seen
    assert "cannot form again" in seen["message"], seen
    assert seen["init_s"] < 10.0, seen


def test_torch_reinit_hung_world_reports_its_stacks(tmp_path, monkeypatch):
    """A world killed at its timeout shows where each rank waited: here
    rank 0 of two, started alone, in the world's rendezvous."""
    from horovod_tpu_torch.common.net import free_ports
    monkeypatch.setattr(sys.modules[__name__], "WORLD_TIMEOUT_S", 25)
    monkeypatch.setattr(sys.modules[__name__], "STACKS_AFTER_S", 6)
    p1, p2 = free_ports(2)
    env = example_env(
        HOROVOD_RANK="0", HOROVOD_SIZE="2", HOROVOD_LOCAL_RANK="0",
        HOROVOD_LOCAL_SIZE="1", HOROVOD_CONTROLLER_ADDR="127.0.0.1",
        HOROVOD_CONTROLLER_PORT=str(p1), HOROVOD_CONTROLLER_PORT2=str(p2))
    done = _run_all({"alone": ([sys.executable, WORKER, "port",
                                str(tmp_path), "--gens", "1"], env,
                               tmp_path)})["alone"]
    assert done.returncode is None, (done.returncode, done.stderr[-3000:])
    assert done.stacks.startswith("--- stacks.rank0.txt"), done.stacks
    assert "init_process_group" in done.stacks, done.stacks


@pytest.fixture(scope="module")
def example_runs(tmp_path_factory):
    """The three examples in turn in one world, and each alone in a
    launch of its own, side by side: ``{key: out_dir}``."""
    root = tmp_path_factory.mktemp("reinit_examples")
    worlds = {"together": (_port_cmd(root / "together", "--examples",
                                     ",".join(EXAMPLES)),
                           example_env(), root / "together")}
    for name in EXAMPLES:
        worlds[name] = (_port_cmd(root / name, "--examples", name),
                        example_env(), root / name)
    done = _run_all(worlds)
    for key in done:
        _ok(done[key])
    return {key: root / key for key in done}


@pytest.mark.parametrize("name", EXAMPLES)
def test_torch_reinit_examples_in_one_world_match_alone(example_runs, name):
    for r in range(2):
        together = dict(np.load(example_runs["together"]
                                / f"{name}.rank{r}.npz"))
        alone = dict(np.load(example_runs[name] / f"{name}.rank{r}.npz"))
        assert sorted(together) == sorted(alone)
        assert len(together) > 2 and np.isfinite(together["losses"]).all()
        for k in together:
            np.testing.assert_array_equal(together[k], alone[k], err_msg=k)


@pytest.mark.parametrize("record_after_s", [0.0, 0.5, None],
                         ids=["recorded", "recorded-late", "never"])
def test_torch_reinit_clean_departure_waits_for_the_record(monkeypatch,
                                                           record_after_s):
    """A rank whose control link died takes it for a clean departure when
    the peer's leave record is in the world's store, or lands there within
    ``_LEAVE_WAIT_S`` (the peer may record after this rank looks); with no
    record it is a fault."""
    import threading
    from datetime import timedelta

    import torch.distributed as dist
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.net import free_ports
    port = free_ports(1)[0]
    store = dist.TCPStore("127.0.0.1", port, 2, True,
                          timeout=timedelta(seconds=10), wait_for_workers=False)
    # The peer records through a client of its own, as from its process.
    peer = dist.TCPStore("127.0.0.1", port, 2, False,
                         timeout=timedelta(seconds=10))
    monkeypatch.setattr(basics, "_default_store", lambda: store)
    monkeypatch.setattr(basics, "_LEAVE_WAIT_S", 2.0)
    monkeypatch.setattr(basics._world, "generations", 7)
    st = basics.GlobalState()
    st.rank = 1

    class Fault:
        dead_ranks = []

    if record_after_s is not None:
        threading.Timer(record_after_s, peer.set,
                        ("hvd/gen/7/left/0", "1")).start()
    t0 = time.time()
    clean = basics._fault_is_a_clean_departure(st, Fault())
    took = time.time() - t0
    assert clean == (record_after_s is not None)
    assert took < (record_after_s or 0.0) + 1.5 if clean else took >= 2.0
