"""The port's churn harness (``horovod_tpu_torch/testing/churn.py``, a copy)
held to the JAX package's: the same ``parse_churn`` scripts of
``tests/test_churn.py``, flat and hierarchical, replayed by both
``ChurnRunner``s (each over its own package's native root, host agents and
state plane) agree on whether the fleet survived, the ranks that left,
the drained hosts, the abort and its attribution, each phase's world
(rounds and live ranks) and the events fired, and, for the rejoin verb,
the restore's source, epoch, disk reads and optimizer shard.  Times are
not compared.
"""

import pytest

from horovod_tpu.testing import churn as jchurn
from horovod_tpu.testing import faults as jfaults
from horovod_tpu_torch.testing import churn as pchurn
from horovod_tpu_torch.testing import faults as pfaults

PKGS = {"jax": (jchurn, jfaults), "torch": (pchurn, pfaults)}

# name: (ChurnRunner kwargs, script)
SCRIPTS = {
    "flat_leave_join": (dict(world=6, ranks_per_host=3, hier=False,
                             rounds=16, warm=3), "leave:5@5,join:*@10"),
    "hier_leave_join": (dict(world=6, ranks_per_host=3, hier=True,
                             rounds=16, warm=3), "leave:5@5,join:*@10"),
    "hier_preempt_then_agent_crash": (
        dict(world=8, ranks_per_host=4, hier=True, rounds=16, warm=3),
        "preempt_notice:1@5,agent_crash:1@8"),
    "hier_agent_crash_live_ranks": (
        dict(world=4, ranks_per_host=2, hier=True, rounds=12, warm=3),
        "agent_crash:1@5"),
    "flat_two_leaves": (dict(world=4, ranks_per_host=2, hier=False,
                             rounds=12, warm=3), "leave:1@3,leave:3@7"),
    "hier_preempt_notice_only": (
        dict(world=6, ranks_per_host=2, hier=True, rounds=12, warm=3),
        "preempt_notice:2@4"),
    "rejoin_restore_peer": (dict(world=4, ranks_per_host=2, rounds=14,
                                 warm=3), "leave:3@4,rejoin_restore:3@9"),
    "rejoin_restore_disk": (dict(world=4, ranks_per_host=2, rounds=14,
                                 warm=3, serve_state=False),
                            "leave:3@4,rejoin_restore:3@9"),
}

_RESTORE_KEYS = ("rank", "restore_source", "restore_epoch", "disk_reads",
                 "opt_shard_ok", "opt_shard_len")


def _outcome(pkg, name, tmp_path):
    churn, faults = PKGS[pkg]
    kwargs, script = SCRIPTS[name]
    kwargs = dict(kwargs)
    if name.startswith("rejoin"):
        d = tmp_path / pkg
        d.mkdir()
        kwargs["state_dir"] = str(d)
    world = kwargs.pop("world")
    rep = churn.ChurnRunner(world, script=faults.parse_churn(script),
                            **kwargs).run()
    fired = [{k: v for k, v in e.items()
              if k in ("verb", "target", "ranks", "live_ranks",
                       "restore_source")}
             for e in rep["events_fired"]]
    failed_ranks = sorted({r for r, _ in rep["failures"]})
    kinds = sorted({("abort" if "abort" in why else
                     "severed" if "severed" in why else why)
                    for _, why in rep["failures"]})
    return dict(
        survived=rep["survived"], aborted=rep["abort_reason"] is not None,
        left_ranks=rep["left_ranks"], drained_hosts=rep["drained_hosts"],
        hosts=rep["hosts"], state_epoch=rep["state_epoch"],
        phases=[(ph["rounds"], ph["live_ranks"]) for ph in rep["phases"]],
        fired=fired, failure_kinds=kinds, failed_ranks=failed_ranks,
        restores=[{k: r.get(k) for k in _RESTORE_KEYS}
                  for r in rep["restores"]],
        measured=bool(rep["root_us_post"]))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_torch_churn_runner_matches_jax(name, tmp_path):
    j = _outcome("jax", name, tmp_path)
    p = _outcome("torch", name, tmp_path)
    if name == "hier_agent_crash_live_ranks":
        # Which ranks see the typed abort and which the sever first is a
        # race in both packages: the attribution kinds are what is fixed.
        for out in (j, p):
            assert set(out.pop("failure_kinds")) <= {"abort", "severed"}
            out.pop("failed_ranks")
            out.pop("phases")
            out.pop("measured")
    assert p == j
    if name == "hier_preempt_then_agent_crash":
        assert p["survived"] and p["left_ranks"] == [4, 5, 6, 7]
        assert p["drained_hosts"] == [1]
    if name == "hier_agent_crash_live_ranks":
        assert not p["survived"] and p["aborted"]
    if name == "rejoin_restore_peer":
        assert p["restores"][0]["restore_source"] == "peer"
        assert p["restores"][0]["disk_reads"] == 0
        assert p["restores"][0]["opt_shard_ok"] is True


def test_torch_churn_grammar_is_the_jax_grammar():
    """The copied ``faults`` grammar parses (and rejects) what the JAX one
    does, and the runner validates a script against its world alike."""
    for text in ("join:*@8,leave:1@3,preempt_notice:1@3",
                 "agent_crash:1@7,rejoin_restore:2@9", ""):
        assert [vars(e) if hasattr(e, "__dict__") else e._asdict()
                for e in pfaults.parse_churn(text)] == \
            [vars(e) if hasattr(e, "__dict__") else e._asdict()
             for e in jfaults.parse_churn(text)]
    for bad_kwargs, script in (
            (dict(world=4, ranks_per_host=2, hier=False, rounds=10),
             "agent_crash:0@5"),
            (dict(world=4, ranks_per_host=2, hier=True, rounds=10),
             "preempt_notice:5@5"),
            (dict(world=4, rounds=10), "rejoin_restore:1@5")):
        for churn, faults in PKGS.values():
            kw = dict(bad_kwargs)
            world = kw.pop("world")
            with pytest.raises(ValueError):
                churn.ChurnRunner(world, script=faults.parse_churn(script),
                                  **kw)


def test_torch_churn_names_its_origin():
    first = open(pchurn.__file__).readline()
    assert first.startswith("# Copied from horovod_tpu/testing/churn.py:1-")
    src = open(pchurn.__file__).read()
    assert "import jax" not in src and "from horovod_tpu." not in src
