"""The port's autoscaler and drains (``horovod_tpu_torch/elastic/
autoscale.py``, a copy, and the autoscale and drain code of the port's
``elastic/driver.py``) held to the JAX package's on the same inputs.

- ``ScalePolicy``: the scripted summary sequences of
  ``tests/test_autoscale.py`` (persistence and cooldown, null trends, a
  straggler and an unstable one, idleness and ``min_np``, unobserved load,
  preemption outranking the signals, the stale-state guard on and off, the
  serving signals) and seeded random walks go through both packages'
  policies; every decision matches field for field (action, reason,
  target, evict rank, hosts), and so do ``stale_holds`` and ``decisions``.
- ``ElasticDriver``: both drivers, each with a notices-capable
  ``FixedHostDiscovery`` subclass, stub processes and a scripted
  ``autoscale_source``, give the same events (timestamps dropped), cordons,
  drains, registry states, ``_reap_exits`` classification table,
  ``_host_removable`` on multi-slot hosts, scale command env and grace
  fallback; the preemption drain reaches each package's own notification
  manager with a COMMIT (acked) and a DRAIN.
- The launcher forwards the six flags of this surface and refuses none of
  them.

Every comparison here is exact.
"""

import os
import socket
import time

import numpy as np
import pytest

from horovod_tpu.elastic import autoscale as jscale
from horovod_tpu.elastic import discovery as jdisc
from horovod_tpu.elastic import driver as jdriver
from horovod_tpu.elastic import registration as jreg
from horovod_tpu.elastic import worker as jworker
from horovod_tpu.runner import run as jrun
from horovod_tpu_torch.common.config import Config as PConfig
from horovod_tpu_torch.elastic import autoscale as pscale
from horovod_tpu_torch.elastic import discovery as pdisc
from horovod_tpu_torch.elastic import driver as pdriver
from horovod_tpu_torch.elastic import registration as preg
from horovod_tpu_torch.elastic import worker as pworker
from horovod_tpu_torch.runner import run as prun

PKGS = {
    "jax": dict(scale=jscale, disc=jdisc, driver=jdriver, reg=jreg,
                worker=jworker),
    "torch": dict(scale=pscale, disc=pdisc, driver=pdriver, reg=preg,
                  worker=pworker),
}


def _summary(spread=None, slowest=None, per_rank=None, q=0, q_trend=None,
             progress_total=None, commit_age=None, rate=None, p99=None):
    s = {"cycle_us_spread": spread, "slowest_rank": slowest,
         "per_rank_cycle_us": per_rank or {}, "queue_depth": q,
         "queue_depth_trend": q_trend, "progress_total": progress_total,
         "last_commit_age_s": commit_age}
    if rate is not None:
        s["request_rate"] = rate
    if p99 is not None:
        s["latency_p99_ms"] = p99
    return s


# ------------------------------------------------------------ ScalePolicy
# Each scenario: the policy's knobs and a list of (summary, size, now,
# preempt_hosts) observations, from tests/test_autoscale.py's cases.
_SLOW = {0: 100.0, 1: 100.0, 2: 900.0}


def _scale_out():
    obs = [(_summary(q=50, q_trend=10.0, progress_total=i), 2, 1000.0 + i,
            ()) for i in range(3)]
    obs += [(_summary(q=500, q_trend=99.0, progress_total=4), 3, 1010.0, ()),
            (_summary(q=50, q_trend=10.0, progress_total=5), 3, 1040.0, ())]
    return dict(min_np=2, max_np=8, queue_trend_up=4.0, persistence=3,
                cooldown_s=30.0), obs


def _null_trends():
    return dict(min_np=1, max_np=8, persistence=1, cooldown_s=0.0), [
        (_summary(q=0, q_trend=None, progress_total=None), 2, 100.0 + i, ())
        for i in range(5)]


def _straggler():
    return dict(min_np=1, straggler_factor=3.0, persistence=3,
                cooldown_s=30.0), [
        (_summary(spread=800, slowest=2, per_rank=_SLOW, progress_total=i),
         3, 1000.0 + i, ()) for i in range(4)]


def _unstable_straggler():
    obs = []
    for i, slow in enumerate((0, 1, 2, 0, 1, 2)):
        per_rank = {r: (500.0 if r == slow else 100.0) for r in range(3)}
        obs.append((_summary(spread=400, slowest=slow, per_rank=per_rank,
                             progress_total=i), 3, 100.0 + i, ()))
    return dict(min_np=1, straggler_factor=2.0, persistence=2,
                cooldown_s=0.0), obs


def _idle_scale_in():
    obs = [(_summary(q=0, progress_total=i), 3, 1000.0 + 5 * i, ())
           for i in range(5)]
    obs += [(_summary(q=0, progress_total=4), 3, 1030.0, ()),
            (_summary(q=0, progress_total=4), 3, 1045.0, ()),
            (_summary(q=0, progress_total=4), 2, 1100.0, ())]
    return dict(min_np=2, persistence=1, cooldown_s=0.0, idle_s=10.0), obs


def _idle_at_min_np():
    return dict(min_np=2, cooldown_s=0.0, idle_s=1.0), [
        (_summary(q=0, progress_total=1), 2, 1000.0, ()),
        (_summary(q=0, progress_total=1), 2, 1100.0, ())]


def _unobserved_load():
    obs = [(_summary(q=None, progress_total=None), 3, 100.0 + 10.0 * i, ())
           for i in range(20)]
    obs += [(_summary(q=0, progress_total=7), 3, 400.0 + 10.0 * i, ())
            for i in range(3)]
    return dict(min_np=1, persistence=1, cooldown_s=0.0, idle_s=5.0), obs


def _preempt():
    evicty = _summary(slowest=1, per_rank={0: 100.0, 1: 1000.0, 2: 100.0},
                      q=50, progress_total=1)
    return dict(min_np=1, max_np=8, queue_high=1.0, persistence=1,
                straggler_factor=2.0, cooldown_s=30.0), [
        (evicty, 3, 100.0, ("hostB",)),
        (_summary(q=50, progress_total=2), 3, 101.0, ()),
        (_summary(q=50, progress_total=3), 3, 102.0, ("hostC", "hostA")),
        (evicty, 3, 200.0, ())]


def _stale_evict():
    obs = [(_summary(spread=800, slowest=2, per_rank=_SLOW,
                     progress_total=i, commit_age=60.0), 3, 1000.0 + i, ())
           for i in range(4)]
    obs.append((_summary(spread=800, slowest=2, per_rank=_SLOW,
                         progress_total=9, commit_age=1.0), 3, 1010.0, ()))
    return dict(min_np=1, straggler_factor=3.0, persistence=2,
                cooldown_s=0.0, commit_max_age_s=10.0), obs


def _stale_scale_in():
    obs = [(_summary(q=0, progress_total=7, commit_age=60.0), 3,
            1000.0 + 10 * i, ()) for i in range(3)]
    obs.append((_summary(q=0, progress_total=7, commit_age=2.0), 3, 1030.0,
                ()))
    return dict(min_np=1, persistence=1, cooldown_s=0.0, idle_s=5.0,
                commit_max_age_s=10.0), obs


def _stale_guard_off():
    return dict(min_np=1, straggler_factor=3.0, persistence=1,
                cooldown_s=0.0), [
        (_summary(spread=800, slowest=2, per_rank=_SLOW, progress_total=1,
                  commit_age=1e9), 3, 1000.0, ())]


def _stale_age_unknown():
    return dict(min_np=1, straggler_factor=3.0, persistence=1,
                cooldown_s=0.0, commit_max_age_s=10.0), [
        (_summary(spread=800, slowest=2, per_rank=_SLOW, progress_total=1,
                  commit_age=None), 3, 1000.0, ())]


def _preempt_over_stale():
    return dict(min_np=1, commit_max_age_s=1.0), [
        (_summary(commit_age=1e9), 3, 100.0, ("hostB",))]


def _serving():
    obs = [(_summary(q=0, progress_total=1, rate=90.0 + 10 * i, p99=40.0),
            2, 100.0 + i, ()) for i in range(4)]
    obs += [(_summary(q=0, progress_total=1, rate=10.0, p99=400.0), 3,
             200.0 + i, ()) for i in range(3)]
    obs += [(_summary(q=0, progress_total=1, rate=0.1, p99=1.0), 3,
             300.0 + 10 * i, ()) for i in range(4)]
    return dict(min_np=1, max_np=4, persistence=2, cooldown_s=5.0,
                idle_s=5.0, rate_high=20.0, latency_target_ms=100.0,
                idle_qps=1.0), obs


def _random_walk(seed):
    def make():
        rng = np.random.default_rng(seed)
        obs, now, size, progress = [], 1000.0, 4, 0
        for _ in range(60):
            now += float(rng.uniform(0.5, 8.0))
            if rng.random() < 0.6:
                progress += 1
            per_rank = {r: float(rng.choice([100.0, 120.0, 700.0]))
                        for r in range(size)}
            slowest = max(per_rank, key=per_rank.get)
            q = int(rng.choice([0, 0, 3, 40]))
            summary = _summary(
                spread=per_rank[slowest] - min(per_rank.values()),
                slowest=slowest, per_rank=per_rank, q=q,
                q_trend=(None if rng.random() < 0.2
                         else float(rng.normal(2.0, 4.0))),
                progress_total=None if rng.random() < 0.1 else progress,
                commit_age=float(rng.choice([1.0, 30.0, 90.0])))
            notices = ("hostX",) if rng.random() < 0.05 else ()
            obs.append((summary, size, now, notices))
            size = int(np.clip(size + rng.integers(-1, 2), 1, 6))
        return dict(min_np=2, max_np=6, persistence=2, cooldown_s=6.0,
                    idle_s=12.0, straggler_factor=3.0, queue_high=16.0,
                    queue_trend_up=4.0, commit_max_age_s=60.0), obs
    return make


POLICY_SCENARIOS = {
    "scale_out": _scale_out, "null_trends": _null_trends,
    "straggler": _straggler, "unstable_straggler": _unstable_straggler,
    "idle_scale_in": _idle_scale_in, "idle_at_min_np": _idle_at_min_np,
    "unobserved_load": _unobserved_load, "preempt": _preempt,
    "stale_evict": _stale_evict, "stale_scale_in": _stale_scale_in,
    "stale_guard_off": _stale_guard_off,
    "stale_age_unknown": _stale_age_unknown,
    "preempt_over_stale": _preempt_over_stale, "serving": _serving,
    **{f"random_{s}": _random_walk(s) for s in range(4)},
}


def _run_policy(mod, make):
    kwargs, obs = make()
    p = mod.ScalePolicy(**kwargs)
    out = []
    for summary, size, now, notices in obs:
        d = p.observe(dict(summary), size, now=now, preempt_hosts=notices)
        out.append((d.action, d.reason, d.target_size, d.evict_rank,
                    d.hosts, d.is_hold))
    return out, p.stale_holds, p.decisions


@pytest.mark.parametrize("name", sorted(POLICY_SCENARIOS))
def test_torch_scale_policy_decides_as_jax(name):
    """Every observation of the scenario gives the JAX package's decision,
    field for field, and the policies' counters agree."""
    make = POLICY_SCENARIOS[name]
    j = _run_policy(jscale, make)
    p = _run_policy(pscale, make)
    assert p == j
    if not name.startswith(("null", "unobserved", "unstable", "idle_at")):
        assert any(not d[5] for d in p[0]), p    # the scenario decides


def test_torch_scale_policy_action_names_match_jax():
    for name in ("HOLD", "SCALE_OUT", "SCALE_IN", "EVICT", "PREEMPT"):
        assert getattr(pscale, name) == getattr(jscale, name)
    d = pscale.ScaleDecision(pscale.EVICT, reason="r", evict_rank=2)
    assert not d.is_hold and pscale.ScaleDecision(pscale.HOLD).is_hold
    with pytest.raises(Exception):
        d.action = pscale.HOLD                  # frozen, as in JAX


# ----------------------------------------------------------------- driver
class _Proc:
    """A stub worker process: alive until ``exit``; ``terminate`` ends it
    with -15 and is recorded."""

    def __init__(self, rc=None):
        self._rc = rc
        self.pid = 0
        self.terminated = False

    def poll(self):
        return self._rc

    def terminate(self):
        self.terminated = True
        self._rc = -15

    def kill(self):
        self.terminate()

    def wait(self, timeout=None):
        return self._rc

    def exit(self, rc=0):
        self._rc = rc


def _notice_discovery(pkg, hosts, notices=()):
    disc = PKGS[pkg]["disc"]

    class Notices(disc.FixedHostDiscovery):
        def __init__(self):
            super().__init__([disc.DiscoveredHost(h, s) for h, s in hosts])
            self.notices = set(notices)

        def preemption_notices(self):
            return set(self.notices)

    return Notices()


def _events(d):
    return [{k: v for k, v in e.items() if k != "ts"} for e in d.events]


def _registry(d, identities):
    return {i: (d.registry.state_of(i),
                d.registry.is_blacklisted(i.rsplit(":", 1)[0]))
            for i in identities}


def _scripted(decisions):
    it = iter(decisions)

    class Policy:
        min_np = 1

        def observe(self, summary, size, now=None, preempt_hosts=()):
            return next(it)

    return Policy()


def _assign(d, layout):
    """``layout``: [(hostname, slots)] → the driver's assignment table."""
    d._assigned, rank = {}, 0
    for host, slots in layout:
        for lr in range(slots):
            d._assigned[f"{host}:{lr}"] = {"rank": rank, "hostname": host}
            rank += 1


def _reap_table(pkg):
    """Each (rc, marked draining, marked released) exit through
    ``_reap_exits``: (re-form, job success, registry state, blacklisted,
    first failure rc)."""
    mods = PKGS[pkg]
    d = mods["driver"].ElasticDriver(mods["disc"].FixedHostDiscovery([]),
                                     ["true"], min_np=1)
    table = {}
    try:
        for rc in (0, 1, -15):
            for draining in (False, True):
                for released in (False, True):
                    d.registry = mods["reg"].WorkerStateRegistry()
                    d._success.clear()
                    d._first_failure_rc = 0
                    d._draining.clear()
                    d._released.clear()
                    d._assigned = {"hostA:0": {"rank": 0,
                                               "hostname": "hostA"}}
                    d._procs["hostA:0"] = _Proc(rc)
                    if draining:
                        d._draining.add("hostA:0")
                    if released:
                        d._released.add("hostA:0")
                    changed = d._reap_exits()
                    table[(rc, draining, released)] = (
                        changed, d._success.is_set(),
                        d.registry.state_of("hostA:0"),
                        d.registry.is_blacklisted("hostA"),
                        d._first_failure_rc, sorted(d._draining),
                        sorted(d._released))
    finally:
        d.rendezvous.stop()
    return table


def test_torch_reap_exits_classify_as_jax():
    """The whole classification table: a drained exit is LEFT and re-forms
    the world, a released one is LEFT silently, rc 0 is success, any
    other rc blacklists."""
    j, p = _reap_table("jax"), _reap_table("torch")
    assert p == j
    assert p[(0, True, False)][:4] == (True, False, jreg.LEFT, False)
    assert p[(0, False, False)][:4] == (False, True, jreg.SUCCESS, False)
    assert p[(1, False, False)][3:5] == (True, 1)


def _host_removable(pkg):
    d = PKGS[pkg]["driver"].ElasticDriver(
        PKGS[pkg]["disc"].FixedHostDiscovery([]), ["true"], min_np=3)
    try:
        out = {}
        for layout in ([("hostA", 2), ("hostB", 2)],
                       [("hostA", 2), ("hostB", 1), ("hostC", 1)],
                       [("hostA", 1), ("hostB", 3)]):
            _assign(d, layout)
            out[str(layout)] = {h: d._host_removable(h) for h, _ in layout}
        return out
    finally:
        d.rendezvous.stop()


def test_torch_host_removable_matches_jax():
    """min_np at host granularity on multi-slot hosts."""
    assert _host_removable("torch") == _host_removable("jax")


def _autoscale_run(pkg, tmp, decisions, layout, min_np=1, procs=()):
    """One scripted ``_autoscale_step`` per decision, with a scale command
    that records its env."""
    mods = PKGS[pkg]
    log = tmp / f"scale.{pkg}"
    cmd = (f'echo "$HVD_AUTOSCALE_ACTION|${{HVD_AUTOSCALE_TARGET:-}}|'
           f'${{HVD_AUTOSCALE_HOST:-}}" >> {log}')
    d = mods["driver"].ElasticDriver(
        mods["disc"].FixedHostDiscovery([]), ["true"], min_np=min_np,
        autoscale_policy=_scripted(decisions),
        autoscale_source=lambda: {"any": "summary"}, scale_command=cmd)
    try:
        _assign(d, layout)
        stubs = {i: _Proc() for i in procs}
        d._procs.update(stubs)
        for _ in decisions:
            d._autoscale_step()
        return dict(events=_events(d), cordoned=sorted(d._cordoned),
                    draining=sorted(d._draining),
                    terminated=sorted(i for i, p in stubs.items()
                                      if p.terminated),
                    reap=d._reap_exits(),
                    registry=_registry(d, d._assigned),
                    scale=(log.read_text().splitlines() if log.exists()
                           else []))
    finally:
        d.rendezvous.stop()


def _decisions(pkg):
    s = PKGS[pkg]["scale"]
    return {
        "evict": ([s.ScaleDecision(s.EVICT, reason="monitor attribution: "
                                   "rank 1 slowest", evict_rank=1),
                   s.ScaleDecision(s.HOLD)],
                  [("hostA", 1), ("hostB", 1)], 1, ("hostB:0",)),
        "scale_in": ([s.ScaleDecision(s.SCALE_IN, reason="idle 30s",
                                      target_size=3)],
                     [("hostA", 2), ("hostB", 1), ("hostC", 1)], 1, ()),
        "scale_out": ([s.ScaleDecision(s.SCALE_OUT, reason="queue",
                                       target_size=3)],
                      [("hostA", 1), ("hostB", 1)], 1, ()),
        "min_np_guard": ([s.ScaleDecision(s.SCALE_IN, reason="idle",
                                          target_size=3),
                          s.ScaleDecision(s.EVICT, reason="attribution",
                                          evict_rank=2)],
                         [("hostA", 2), ("hostB", 2)], 3, ()),
        "evict_unknown_rank": ([s.ScaleDecision(s.EVICT, reason="gone",
                                                evict_rank=9)],
                               [("hostA", 1), ("hostB", 1)], 1, ()),
        # A second scale-in decided while the first one's drain still runs
        # (its host still assigned): the reference drains the same host
        # again and runs the scale command again, and so does the port.
        "scale_in_during_drain": ([s.ScaleDecision(s.SCALE_IN, reason="idle",
                                                   target_size=1)] * 2,
                                  [("hostA", 1), ("hostB", 1)], 1, ()),
    }


@pytest.mark.parametrize("name", ["evict", "scale_in", "scale_out",
                                  "min_np_guard", "evict_unknown_rank",
                                  "scale_in_during_drain"])
def test_torch_autoscale_step_executes_as_jax(name, tmp_path):
    """One scripted decision sequence through both drivers: the same
    events (commit requests with their acks, the decision with its host
    or identity), cordons, drains, terminations (the unreachable
    fallback), re-form verdict, registry states and scale command env."""
    outs = {}
    for pkg in ("jax", "torch"):
        decisions, layout, min_np, procs = _decisions(pkg)[name]
        outs[pkg] = _autoscale_run(pkg, tmp_path, decisions, layout,
                                   min_np=min_np, procs=procs)
    assert outs["torch"] == outs["jax"]
    if name == "scale_in":
        assert outs["torch"]["scale"] == ["scale_in|3|hostC"]
        assert outs["torch"]["cordoned"] == ["hostC"]
    if name == "scale_in_during_drain":
        assert outs["torch"]["scale"] == ["scale_in|1|hostB"] * 2
        assert [e["action"] for e in outs["torch"]["events"]
                if e["action"] == "scale_in"] == ["scale_in"] * 2
    if name == "evict":
        assert outs["torch"]["terminated"] == ["hostB:0"]
        assert outs["torch"]["registry"]["hostB:0"] == (jreg.LEFT, False)


def _preempt_drain(pkg, grace):
    """A notice for an assigned host whose worker listens (each package's
    own notification manager): the drain pings, cordon, deadline and
    LEFT classification; then the notice clears and re-arms, and an
    unassigned host's notice only cordons."""
    mods = PKGS[pkg]
    disc = _notice_discovery(pkg, [("127.0.0.1", 1), ("127.0.0.2", 1)],
                             notices=["127.0.0.2"])
    d = mods["driver"].ElasticDriver(disc, ["true"], min_np=1,
                                     preempt_grace_s=grace)
    mgr = mods["worker"].WorkerNotificationManager()
    try:
        _assign(d, [("127.0.0.1", 1), ("127.0.0.2", 1)])
        proc, other = _Proc(), _Proc()
        d._procs.update({"127.0.0.2:0": proc, "127.0.0.1:0": other})
        d.rendezvous._notify_ports["127.0.0.2:0"] = mgr._service.port
        d._check_preemption()
        first = dict(cordoned=sorted(d._cordoned),
                     draining=sorted(d._draining),
                     deadlines=sorted(d._drain_deadlines))
        deadline = time.monotonic() + 5
        committed = drained = False
        while time.monotonic() < deadline and not (committed and drained):
            committed = committed or mgr.consume_commit_request()
            if not drained:
                try:
                    mgr.raise_if_updated()
                except Exception as exc:  # noqa: BLE001
                    drained = type(exc).__name__ == "DrainRequested"
            time.sleep(0.02)
        d._check_preemption()               # handled once
        proc.exit(0)
        reap = d._reap_exits()
        reg = _registry(d, ["127.0.0.2:0"])
        disc.notices.clear()
        d._check_preemption()
        released = sorted(d._cordoned)
        disc.notices.add("hostZ")
        d._check_preemption()
        zed = sorted(d._cordoned)
        return dict(events=_events(d), first=first, committed=committed,
                    drained=drained, reap=reap, registry=reg,
                    released=released, zed=zed,
                    success=d._success.is_set(), other=other.terminated)
    finally:
        mgr._service.stop()
        d.rendezvous.stop()


@pytest.mark.parametrize("grace", [2.0, 60.0])
def test_torch_preempt_drain_matches_jax(grace):
    """The preemption drain, driver side, in both packages: the commit
    request acked by the doomed host's worker, the ``preempt_drain`` event
    with its reason, the cordon, the drain with its deadline, the clean
    exit classified LEFT without a blacklist, the cordon released when the
    notice clears, and an unassigned host's notice only cordoning."""
    j = _preempt_drain("jax", grace)
    p = _preempt_drain("torch", grace)
    for out in (j, p):
        acks = [e for e in out["events"] if e["action"] == "commit_request"]
        # Only the doomed worker registered a notification port.
        assert acks[0]["acks"] == {"127.0.0.2:0": True}, acks
    assert p == j
    assert p["committed"] and p["drained"] and p["reap"] is True
    assert p["registry"] == {"127.0.0.2:0": (jreg.LEFT, False)}
    assert p["first"] == {"cordoned": ["127.0.0.2"],
                          "draining": ["127.0.0.2:0"],
                          "deadlines": ["127.0.0.2:0"]}
    assert p["released"] == [] and p["zed"] == ["hostZ"]
    assert [e["action"] for e in p["events"]] == ["preempt_drain",
                                                  "commit_request"]


def _grace_fallback(pkg):
    mods = PKGS[pkg]
    disc = _notice_discovery(pkg, [("hostA", 1), ("hostB", 1)],
                             notices=["hostB"])
    d = mods["driver"].ElasticDriver(disc, ["true"], min_np=1,
                                     preempt_grace_s=0.0)
    d2 = mods["driver"].ElasticDriver(_notice_discovery(pkg, [("hostC", 1)]),
                                      ["true"], min_np=1,
                                      preempt_grace_s=0.0)
    try:
        _assign(d, [("hostA", 1), ("hostB", 1)])
        proc = _Proc()
        d._procs["hostB:0"] = proc
        d._check_preemption()               # no port: terminate at once
        out = dict(terminated=proc.terminated, draining=sorted(d._draining),
                   reap=d._reap_exits(), registry=_registry(d, ["hostB:0"]))
        proc2 = _Proc()
        d2._procs["hostC:0"] = proc2
        d2._draining.add("hostC:0")
        d2._drain_deadlines["hostC:0"] = time.monotonic() - 1.0
        d2._enforce_drain_deadlines()
        out.update(wedged=proc2.terminated,
                   deadlines=sorted(d2._drain_deadlines),
                   events=[e["action"] for e in _events(d)])
        return out
    finally:
        d.rendezvous.stop()
        d2.rendezvous.stop()


def test_torch_grace_fallback_matches_jax():
    """An unreachable doomed worker is terminated at once and a drained
    one past its deadline is terminated by the enforcement, both still
    departures (LEFT, no blacklist), as in the JAX driver."""
    j, p = _grace_fallback("jax"), _grace_fallback("torch")
    assert p == j
    assert p["terminated"] and p["wedged"] and p["reap"] is True
    assert p["registry"] == {"hostB:0": (jreg.LEFT, False)}


def _first_generation_notice(pkg):
    mods = PKGS[pkg]
    disc = _notice_discovery(pkg, [("hostA", 1), ("hostB", 1)],
                             notices=["hostB"])
    d = mods["driver"].ElasticDriver(disc, ["true"], min_np=1)
    try:
        d._check_preemption()
        hosts = disc.find_available_hosts_and_slots()
        return (sorted(d._cordoned), sorted(d._preempt_cordoned),
                [h.hostname for h in d.active_hosts(hosts)], _events(d))
    finally:
        d.rendezvous.stop()


def test_torch_notice_before_assignment_cordons_as_jax():
    """A notice standing before the first generation cordons the host (no
    drain event) and the host is left out of the active hosts."""
    p = _first_generation_notice("torch")
    assert p == _first_generation_notice("jax")
    assert p[0] == ["hostB"] and p[2] == ["hostA"] and p[3] == []


def test_torch_script_discovery_posts_no_notices():
    """The script and fixed sources report no preemption notices, in
    both packages."""
    for disc in (jdisc, pdisc):
        assert disc.HostDiscoveryScript("echo a:1").preemption_notices() \
            == set()
        assert disc.FixedHostDiscovery([]).preemption_notices() == set()


def test_torch_default_autoscale_source_reads_rank0_health():
    """The default source polls rank 0's ``/health`` at the forwarded
    monitor port; without a port or an assignment it holds (None)."""
    import http.server
    import json
    import threading

    body = json.dumps({"queue_depth": 0, "progress_total": 5}).encode()

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200 if self.path == "/health" else 404)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        got = {}
        for pkg in ("jax", "torch"):
            mods = PKGS[pkg]
            d = mods["driver"].ElasticDriver(
                mods["disc"].FixedHostDiscovery([]), ["true"], min_np=1,
                env={"HOROVOD_MONITOR_PORT": str(srv.server_port)})
            try:
                assert d._default_autoscale_source() is None
                d._assigned = {"127.0.0.1:0": {
                    "rank": 0, "hostname": "127.0.0.1",
                    "controller_addr": "127.0.0.1"}}
                got[pkg] = d._default_autoscale_source()
            finally:
                d.rendezvous.stop()
        assert got["torch"] == got["jax"] == json.loads(body)
    finally:
        srv.shutdown()
        srv.server_close()


# --------------------------------------------------------------- launcher
SIX = {
    "--autoscale": ([], None),
    "--autoscale-interval": (["2.5"], None),
    "--scale-command": (["echo hi"], None),
    "--preempt-grace-s": (["7"], None),
    "--commit-max-age-s": (["30"], ("HOROVOD_COMMIT_MAX_AGE_S", "30.0")),
    "--hierarchical-controller": ([], ("HOROVOD_HIERARCHICAL_CONTROLLER",
                                       "1")),
}


@pytest.mark.parametrize("flag", sorted(SIX))
def test_torch_runner_forwards_the_drain_and_agent_flags(flag):
    """Each flag parses on the port's launcher as on the JAX launcher (no
    refusal), and what it forwards to the workers' env is the JAX
    launcher's."""
    value, env = SIX[flag]
    assert flag not in prun.NOT_PORTED
    argv = ["--host-discovery-script", "cat h", flag, *value, "python",
            "t.py"]
    p, j = prun.parse_args(argv), jrun.parse_args(argv)
    dest = prun._dest(flag)
    assert getattr(p, dest) == getattr(j, dest) not in (None, False)
    pe, je = prun.tuning_env(p), jrun.tuning_env(j)
    if env is not None:
        assert pe[env[0]] == je[env[0]] == env[1]
    else:
        assert not {k for k in pe if "AUTOSCALE" in k or "PREEMPT" in k}


def test_torch_run_elastic_builds_the_policy_as_jax(monkeypatch):
    """``run_elastic`` builds the driver's policy from the launcher's env
    table exactly as the JAX one does, and hands the autoscale, scale
    command and grace arguments through."""
    knobs = {"HOROVOD_AUTOSCALE_IDLE_S": "4", "HOROVOD_AUTOSCALE_PERSISTENCE":
             "2", "HOROVOD_AUTOSCALE_COOLDOWN": "3",
             "HOROVOD_AUTOSCALE_STRAGGLER_FACTOR": "50",
             "HOROVOD_AUTOSCALE_INTERVAL": "1.5"}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    seen = {}
    for name, run, drv in (("jax", jrun, jdriver), ("torch", prun, pdriver)):
        class Fake:
            def __init__(self, discovery, command, **kw):
                seen[name] = kw
                self.rendezvous = type("R", (), {"stop": lambda s: None})()

            def run(self):
                return 0

        monkeypatch.setattr(drv, "ElasticDriver", Fake)
        args = run.parse_args(["--host-discovery-script", "cat h",
                               "--min-np", "1", "--max-np", "3",
                               "--autoscale", "--monitor-port", "9",
                               "--scale-command", "true",
                               "--preempt-grace-s", "0", "python", "t.py"])
        assert drv.run_elastic(args) == 0
    for kw in seen.values():
        pol = kw.pop("autoscale_policy")
        kw["policy"] = {k: v for k, v in vars(pol).items()}
        kw["env"] = {k: v for k, v in kw["env"].items()
                     if k.startswith("HOROVOD_") and "COORD" not in k}
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["preempt_grace_s"] == 0.0
    assert seen["torch"]["autoscale_interval_s"] == 1.5
    assert seen["torch"]["policy"]["idle_s"] == 4.0


def test_torch_config_drain_fields_match_jax(monkeypatch):
    """The config fields of this surface have the JAX defaults and parse
    the same env."""
    from horovod_tpu.common.config import Config as JConfig
    names = ("hierarchical_controller", "agent_port", "preempt_grace_s",
             "commit_max_age_s", "autoscale", "autoscale_interval_s",
             "autoscale_queue_high", "autoscale_queue_trend",
             "autoscale_straggler_factor", "autoscale_persistence",
             "autoscale_cooldown_s", "autoscale_idle_s",
             "autoscale_rate_high", "autoscale_latency_target_ms",
             "autoscale_idle_qps")
    for k in list(os.environ):
        if k.startswith("HOROVOD_"):
            monkeypatch.delenv(k)
    pick = lambda c: tuple(getattr(c, n) for n in names)  # noqa: E731
    assert pick(PConfig.from_env()) == pick(JConfig.from_env())
    for var, val in (("HIERARCHICAL_CONTROLLER", "1"), ("AGENT_PORT", "71"),
                     ("PREEMPT_GRACE_S", "2.5"), ("COMMIT_MAX_AGE_S", "9"),
                     ("AUTOSCALE", "yes"), ("AUTOSCALE_IDLE_S", "4"),
                     ("AUTOSCALE_PERSISTENCE", "2"),
                     ("AUTOSCALE_RATE_HIGH", "3.5")):
        monkeypatch.setenv(f"HOROVOD_{var}", val)
    assert pick(PConfig.from_env()) == pick(JConfig.from_env())
    assert PConfig.from_env().agent_port == 71


def test_torch_commit_ping_ack_recorded_as_jax():
    """``_request_commit_all`` against a listening and a dead worker: the
    same acks and event in both packages."""
    outs = {}
    for pkg in ("jax", "torch"):
        mods = PKGS[pkg]
        mgr = mods["worker"].WorkerNotificationManager()
        d = mods["driver"].ElasticDriver(
            mods["disc"].FixedHostDiscovery([]), ["true"], min_np=1)
        try:
            d._procs.update({"127.0.0.1:0": _Proc(), "127.0.0.1:9": _Proc()})
            d.rendezvous._notify_ports["127.0.0.1:0"] = mgr._service.port
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                dead = s.getsockname()[1]
            d.rendezvous._notify_ports["127.0.0.1:9"] = dead
            acks = d._request_commit_all(wait_s=2.0)
            outs[pkg] = (acks, _events(d), mgr.consume_commit_request())
        finally:
            mgr._service.stop()
            d.rendezvous.stop()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == {"127.0.0.1:0": True, "127.0.0.1:9": False}
