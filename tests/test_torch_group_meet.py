"""A group made just before ``shutdown()`` or exit (CPU, gloo).

On gloo a rank can return from ``dist.new_group`` while a peer is still
connecting the group's pairs; if the rank then destroys the group or
exits, the peer's ``new_group`` fails (``Gloo connectFullMesh failed ...
Connection closed by peer``).  ``basics._new_generation_group`` therefore
returns only once every rank of the world has made the group: the ranks
meet in the world's store (``basics._meet``).

- Worlds of three ranks run ``tests/torch_reinit_worker.py --race``: each
  rank makes a mesh over the world and a process set of ranks 0 and 1,
  destroys both and exits at once, while rank 1 shares one core with six
  spinning processes (two such worlds side by side a case); every rank
  ends with rc 0.
- The same world with no rank held, static and under the elastic driver:
  two meets a rank (the mesh's group and the set's), keyed per
  generation (``hvd/gen/1``) and per rendezvous version
  (``hvd/elastic/<v>``).
- ``_meet`` on its own, threads standing for ranks: no rank returns
  before the last arrives, and the last, there the store's host, may end
  the store at once without failing a waiting rank.
"""

import json
import os
import sys
import threading
import time

import pytest

from test_torch_reinit import WORKER, _ok, _run_all
from torch_example_runs import example_env

NP = 3


def _race_cmd(out, *args, launcher_args=("-np", str(NP))):
    return [sys.executable, "-m", "horovod_tpu_torch.runner",
            *launcher_args, sys.executable, WORKER, "port", str(out),
            "--race", *args]


def _records(out):
    return [json.load(open(os.path.join(out, f"race.rank{r}.json")))
            for r in range(NP)]


@pytest.mark.parametrize("launch", range(4))
def test_torch_group_meet_held_rank_exits_at_once(tmp_path, launch):
    outs = {f"race{i}": tmp_path / f"race{i}" for i in range(2)}
    done = _run_all({key: (_race_cmd(out, "--held", "1"), example_env(), out)
                     for key, out in outs.items()})
    for key, out in outs.items():
        _ok(done[key])
        assert len(_records(out)) == NP


def _assert_two_meets(recs, prefix):
    for r, rec in enumerate(recs):
        assert rec["meets"] == 2, (r, rec)
        assert rec["prefix"] == prefix, (r, rec)
        assert 0.0 < rec["meet_s"] < 60.0, (r, rec)


def test_torch_group_meet_keys_a_static_world_per_generation(tmp_path):
    done = _run_all({"race": (_race_cmd(tmp_path, "--held", "-1"),
                              example_env(), tmp_path)})
    _ok(done["race"])
    _assert_two_meets(_records(tmp_path), "hvd/gen/1")


def test_torch_group_meet_keys_an_elastic_world_per_version(tmp_path):
    hosts = tmp_path / "hosts"
    hosts.write_text(f"127.0.0.1:{NP}\n")
    out = tmp_path / "out"
    env = {k: v for k, v in example_env().items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    cmd = _race_cmd(out, "--held", "-1", launcher_args=(
        "--host-discovery-script", f"cat {hosts}", "--min-np", str(NP),
        "--max-np", str(NP), "--ckpt-dir", str(tmp_path / "ckpt")))
    done = _run_all({"race": (cmd, env, out)})
    _ok(done["race"])
    recs = _records(out)
    prefixes = {rec["prefix"] for rec in recs}
    assert len(prefixes) == 1, recs
    prefix = prefixes.pop()
    assert prefix.startswith("hvd/elastic/") \
        and prefix.split("/")[-1].isdigit(), prefix
    _assert_two_meets(recs, prefix)


@pytest.mark.parametrize("host_last", [True, False],
                         ids=["store-host-last", "store-host-first"])
def test_torch_meet_returns_once_the_last_rank_arrives(monkeypatch,
                                                       host_last):
    """Three ranks arrive 0.3 s apart; none returns before the last has
    arrived.  The store's host ends the store as soon as its own meet
    returns: arriving last it must not leave a waiting rank without its
    wake-up."""
    from datetime import timedelta

    import torch.distributed as dist
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.net import reserve_ports
    with reserve_ports(1) as held:
        port, = held.ports
        local = threading.local()
        monkeypatch.setattr(basics, "_default_store", lambda: local.store)
        stores = [dist.TCPStore("127.0.0.1", port, 3, True,
                                timeout=timedelta(seconds=10),
                                wait_for_workers=False)]
        stores += [dist.TCPStore("127.0.0.1", port, 3, False,
                                 timeout=timedelta(seconds=10))
                   for _ in range(2)]
    order = [1, 2, 0] if host_last else [0, 1, 2]
    t0 = time.perf_counter()
    returned, errors = {}, []

    def rank(r, delay):
        local.store = stores[r]
        time.sleep(delay)
        try:
            basics._meet("hvd/test/meet", 3, r == 0)
            returned[r] = time.perf_counter() - t0
            if r == 0:
                # The store's host leaves at once.
                stores[0] = local.store = None
        except Exception as exc:  # noqa: BLE001 - the failure is reported
            errors.append((r, repr(exc)))

    threads = [threading.Thread(target=rank, args=(r, 0.3 * i))
               for i, r in enumerate(order)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not errors, errors
    assert sorted(returned) == [0, 1, 2], returned
    last = order[-1]
    assert all(returned[r] >= 0.6 for r in returned), returned
    # The last rank waited for nobody.
    assert returned[last] < 0.6 + 0.5, returned
