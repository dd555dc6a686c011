"""The port's per-host agent (``horovod_tpu_torch/common/host_agent.py``, a
copy) held to the JAX package's and to ``tests/test_host_agent.py``.

- ``split_rank_frame`` parses every client frame shape (warm bitvector,
  announces, sanitizer tags, MON1, FLT1 and ZRT7 sections, truncated and
  garbage frames) as the JAX one does.
- The port's agent and the JAX agent fed the same round of rank frames
  build byte-identical uplinks, with the same accounting: the synchronized
  warm aggregate, the per-rank path, MON1 dedup, ZRT7 confirms, a LEAVE.
- Live worlds over the port's native root (``common/native.py``): port
  ``TCPController``s through port agents, and JAX controllers through port
  agents, negotiate as the flat plane does (the same verdict order on
  every rank) and collapse the warm steady state to one fixed-size uplink
  per host per round, in the same counts as JAX agents in the same world.
- One port agent serves consecutive generations (grown and shrunk rank
  sets, a fresh root each time), a local rank's clean LEAVE shrinks the
  host's uplink instead of killing it, and an agent's death ends the
  other host's rounds with a typed ``PeerFailureError`` naming every rank
  of the dead host.
"""

import struct
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu.common import host_agent as jagent
from horovod_tpu.common.controller import TCPController as JController
from horovod_tpu_torch.common import host_agent as pagent
from horovod_tpu_torch.common.controller import TCPController as PController
from horovod_tpu_torch.common.exceptions import (
    HorovodInternalError, PeerFailureError,
)
from horovod_tpu_torch.common.net import free_ports

AGENTS = {"jax": jagent, "torch": pagent}


class PE:
    """A port entry: this rank's own tensor."""

    def __init__(self, name, shape=(4,)):
        self.name = name
        self.tensor = torch.zeros(shape)


class JE:
    """A JAX entry: the stacked ``[world, *S]`` array."""

    def __init__(self, name, shape=(4,)):
        self.name = name
        self.tensor = np.zeros((2,) + tuple(shape), np.float32)


CTLS = {"torch": (PController, PE), "jax": (JController, JE)}


# ------------------------------------------------------------- frames
def _ann(name, digest=b"d", group=b"", datadep=b"", tag=b""):
    out = struct.pack("<H", 1)
    for f in (name, digest, group, datadep, tag):
        out += struct.pack("<H", len(f)) + f
    return out


def _frame(anns=(), bits=b"\x05", tags=(), trailing=()):
    out = struct.pack("<I", len(anns)) + b"".join(anns)
    out += struct.pack("<I", len(bits)) + bits
    out += struct.pack("<I", len(tags))
    for slot, t in tags:
        out += struct.pack("<IH", slot, len(t)) + t
    for magic, payload in trailing:
        out += struct.pack("<II", magic, len(payload)) + payload
    return out


MON, FLT, ZRT = 0x314E4F4D, 0x31544C46, 0x3754525A
LEAVE = struct.pack("<II", 0xFFFFFFFE, 0x3645564C)

FRAMES = {
    "warm": _frame(),
    "empty_bits": _frame(bits=b""),
    "announces": _frame(anns=[_ann(b"grad.0"), _ann(b"grad.1", tag=b"t")]),
    "tags": _frame(tags=[(3, b"abc"), (9, b"")]),
    "mon_flt": _frame(trailing=[(MON, b"abc"), (FLT, b"")]),
    "zrt": _frame(trailing=[(ZRT, b"\x01")]),
    "truncated": _frame(trailing=[(MON, b"abc")])[:-2],
    "garbage": b"\x07\x00",
    "leave": LEAVE,
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_torch_split_rank_frame_matches_jax(name):
    data = FRAMES[name]
    p = pagent.split_rank_frame(data)
    assert p == jagent.split_rank_frame(data)
    if name == "mon_flt":
        assert p[3] == [(MON, b"abc"), (FLT, b"")]
    if name in ("truncated", "garbage"):
        assert p is None


def test_torch_split_rank_frame_random_frames_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        anns = [_ann(bytes(rng.integers(97, 122, rng.integers(0, 9),
                                        dtype=np.uint8)))
                for _ in range(rng.integers(0, 3))]
        bits = bytes(rng.integers(0, 255, rng.integers(0, 5), np.uint8))
        tags = [(int(rng.integers(0, 99)), b"x" * int(rng.integers(0, 4)))
                for _ in range(rng.integers(0, 2))]
        trailing = [(int(rng.choice([MON, FLT, ZRT])),
                     b"y" * int(rng.integers(0, 4)))
                    for _ in range(rng.integers(0, 3))]
        data = _frame(anns, bits, tags, trailing)
        cut = data[:int(rng.integers(0, len(data) + 1))]
        for d in (data, cut):
            assert pagent.split_rank_frame(d) == jagent.split_rank_frame(d)


# Each round: {rank: frame} from the host's local ranks.
ROUNDS = {
    "warm_aggregate": {0: FRAMES["warm"], 1: FRAMES["warm"],
                       2: FRAMES["warm"]},
    "asymmetric_bits": {0: _frame(bits=b"\x05"), 1: _frame(bits=b"\x04"),
                        2: _frame(bits=b"\x05")},
    "announce": {0: FRAMES["announces"], 1: FRAMES["warm"],
                 2: FRAMES["warm"]},
    "mon_dedup": {r: _frame(trailing=[(MON, b"blob%d" % r)])
                  for r in range(3)},
    "zrt_confirms": {r: FRAMES["zrt"] for r in range(3)},
    "flt_forces_per_rank": {0: FRAMES["mon_flt"], 1: FRAMES["warm"],
                            2: FRAMES["warm"]},
    "opaque": {0: FRAMES["garbage"], 1: FRAMES["warm"], 2: FRAMES["warm"]},
    "leave": {0: FRAMES["warm"], 1: LEAVE, 2: FRAMES["warm"]},
    "partial_host": {0: FRAMES["warm"], 1: FRAMES["warm"]},
}


def _uplink(mod, frames):
    a = mod.HostAgent(0, "127.0.0.1", 1, [0, 1, 2], host_index=1)
    try:
        up = a._build_uplink(dict(frames))
        return up, vars(a.stats)
    finally:
        a._lsock.close()


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_torch_agent_uplink_is_byte_identical(name):
    """One round of the same rank frames: the same uplink bytes and the
    same accounting in both agents."""
    p = _uplink(pagent, ROUNDS[name])
    assert p == _uplink(jagent, ROUNDS[name])
    up, stats = p
    assert struct.unpack_from("<I", up)[0] == 0x35505548      # HUP5
    assert stats["agg_rounds"] == int(name in ("warm_aggregate",
                                               "mon_dedup", "zrt_confirms"))
    if name == "mon_dedup":
        assert stats["mon_blobs_forwarded"] == 3


# ---------------------------------------------------------- live worlds
def _steps(ctl, make_entries, n_steps, max_rounds=30):
    orders = []
    for _ in range(n_steps):
        entries = list(make_entries())
        got = []
        for _round in range(max_rounds):
            if not entries:
                break
            ready, errs = ctl.negotiate(entries)
            assert not errs, errs
            got += [e.name for e in ready]
            entries = [e for e in entries if e.name not in set(got)]
        assert not entries, f"never became ready: {[e.name for e in entries]}"
        orders.append(tuple(got))
    return orders


def run_hier(hosts, fn, agents="torch", ctls="torch", round_timeout_s=0.0,
             expect_errors=False):
    """``fn(ctl, rank, E)`` on every rank of a world of simulated hosts:
    each host gets a real agent of package ``agents``, every rank a
    controller of package ``ctls``; rank 0 hosts the native root."""
    world = sum(len(h) for h in hosts)
    root_port, = free_ports(1)
    mod = AGENTS[agents]
    ags = [mod.HostAgent(0, "127.0.0.1", root_port, ranks, host_index=i,
                         connect_timeout_ms=20000).start()
           for i, ranks in enumerate(hosts)]
    agent_of = {r: a for a, ranks in zip(ags, hosts) for r in ranks}
    cls, entry = CTLS[ctls]
    results, errors = {}, {}
    all_done = threading.Event()

    def worker(rank):
        ctl = cls("127.0.0.1", agent_of[rank].port, rank=rank, world=world,
                  stall_warn_s=60.0, round_timeout_s=round_timeout_s,
                  server_port=root_port if rank == 0 else None)
        try:
            results[rank] = fn(ctl, rank, entry)
        except Exception as exc:  # noqa: BLE001 - surfaced by the assert
            errors[rank] = exc
        finally:
            if len(results) + len(errors) == world:
                all_done.set()
            all_done.wait(timeout=30)
            ctl.shutdown()

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for h in hosts for r in h if r != 0]
    for t in threads:
        t.start()
    worker(0)
    for t in threads:
        t.join(timeout=30)
    for a in ags:
        a.stop()
    if not expect_errors:
        assert not errors, errors
        assert len(results) == world, sorted(results)
    return results, errors, ags


def _warm_world(agents, ctls):
    names = [f"g.{i}" for i in range(8)]

    def fn(ctl, rank, E):
        mk = lambda: [E(n) for n in names]            # noqa: E731
        warm = _steps(ctl, mk, 2)
        return warm + _steps(ctl, mk, 5)

    results, _, ags = run_hier([[0, 1], [2, 3]], fn, agents=agents,
                               ctls=ctls)
    return results, [vars(a.stats) for a in ags], [a.error for a in ags]


@pytest.mark.parametrize("ctls", ["torch", "jax"])
def test_torch_agent_world_negotiates_as_flat(ctls):
    """Four ranks on two hosts behind the port's agents: every rank gets
    the same verdict order, and after warm-up every round costs the root
    one fixed-size uplink per host; JAX agents in the same world give the
    same orders and the same aggregate counts."""
    p_res, p_stats, p_err = _warm_world("torch", ctls)
    j_res, j_stats, _ = _warm_world("jax", ctls)
    assert p_res[0] == p_res[1] == p_res[2] == p_res[3] == j_res[0]
    assert p_err == [None, None]
    for st in p_stats:
        assert st["uplink_frames"] == st["rounds"], st
        assert st["agg_rounds"] >= 5, st
        assert 0 < st["last_agg_uplink_len"] <= 40, st
    keys = ("agg_rounds", "last_agg_uplink_len", "generations")
    assert [{k: s[k] for k in keys} for s in p_stats] == \
        [{k: s[k] for k in keys} for s in j_stats]


def test_torch_agent_serves_generations():
    """One port agent, three generations on one listen port: two ranks,
    then three (grown), then one (shrunk), each against a fresh native
    root; cumulative stats, ``generations == 3``, the warm aggregate in
    the multi-rank ones."""
    ports = free_ports(3)
    agent = pagent.HostAgent(0, "127.0.0.1", ports[0], [0, 1], host_index=0,
                             connect_timeout_ms=20000).start()
    stable = agent.port

    def generation(world, root_port):
        results, errors = {}, {}
        all_done = threading.Event()

        def worker(rank):
            ctl = PController("127.0.0.1", stable, rank=rank, world=world,
                              stall_warn_s=60.0,
                              server_port=root_port if rank == 0 else None)
            try:
                results[rank] = _steps(ctl, lambda: [PE("g")], 3)
                assert ctl.leave() is True
            except Exception as exc:  # noqa: BLE001
                errors[rank] = exc
            finally:
                if len(results) + len(errors) == world:
                    all_done.set()
                all_done.wait(timeout=20)
                ctl.shutdown()

        threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                   for r in range(1, world)]
        for t in threads:
            t.start()
        worker(0)
        for t in threads:
            t.join(timeout=20)
        assert not errors, errors
        assert len({tuple(o) for o in results.values()}) == 1, results

    generation(2, ports[0])
    agent.end_generation()
    agg1 = agent.stats.agg_rounds
    agent.new_generation("127.0.0.1", ports[1], [0, 1, 2], host_index=0)
    assert agent.port == stable
    generation(3, ports[1])
    agent.end_generation()
    agg2 = agent.stats.agg_rounds
    agent.new_generation("127.0.0.1", ports[2], [0], host_index=0)
    assert agent.ranks == [0]
    generation(1, ports[2])
    agent.stop()
    assert agent.stats.generations == 3, vars(agent.stats)
    assert 0 < agg1 < agg2, vars(agent.stats)
    assert agent.error is None, agent.error


def test_torch_agent_leave_shrinks_the_uplink():
    """A local rank's clean LEAVE through the port's agent: the agent
    forwards exactly one LEAVE, retires the rank, the survivors (its
    host-mate included) see it in ``left_ranks`` and go on negotiating
    warm over the shrunk host."""
    leave_done = threading.Event()

    def fn(ctl, rank, E):
        _steps(ctl, lambda: [E("warm")], 3)
        assert ctl.peer_leave_proto
        if rank == 3:
            assert ctl.leave() is True
            leave_done.set()
            return "left"
        assert leave_done.wait(10)
        for _ in range(500):
            ctl.negotiate([])
            if ctl.left_ranks:
                break
            time.sleep(0.005)
        assert ctl.left_ranks == [3], (rank, ctl.left_ranks)
        _steps(ctl, lambda: [E("after.leave")], 3)
        return "survived"

    results, _, ags = run_hier([[0, 1], [2, 3]], fn)
    assert results == {0: "survived", 1: "survived", 2: "survived",
                       3: "left"}
    a1 = ags[1]
    assert a1.stats.leaves_forwarded == 1, vars(a1.stats)
    assert 3 not in a1._reported_dead
    assert a1.ranks == [2]
    assert a1.stats.agg_rounds > 0, vars(a1.stats)


@pytest.mark.parametrize("ctls", ["torch", "jax"])
def test_torch_agent_death_is_attributed_to_its_host(ctls):
    """Killing host 1's port agent: rank 0 gets a typed HVD303
    ``PeerFailureError`` naming both of host 1's ranks, within the round
    deadline."""
    killed = threading.Event()
    holder = []

    def fn(ctl, rank, E):
        _steps(ctl, lambda: [E("t")], 1)
        if rank in (1, 2, 3):
            killed.wait(15)
            try:
                for _ in range(50):
                    ctl.negotiate([E("t2")])
                    time.sleep(0.05)
                return "no error"
            except (PeerFailureError, HorovodInternalError) as exc:
                return ("died", type(exc).__name__)
            except Exception as exc:  # noqa: BLE001 - the JAX types
                return ("died", type(exc).__name__)
        time.sleep(0.3)
        holder[0].kill()
        killed.set()
        t0 = time.monotonic()
        try:
            for _ in range(50):
                ctl.negotiate([E("t2")])
                time.sleep(0.05)
            return "no error"
        except Exception as exc:  # noqa: BLE001 - checked below
            return (type(exc).__name__, sorted(exc.dead_ranks),
                    "HVD303" in str(exc), time.monotonic() - t0)

    orig = pagent.HostAgent.start

    def start(self):
        if self.host_index == 1:
            holder.append(self)
        return orig(self)

    pagent.HostAgent.start = start
    try:
        results, _, _ = run_hier([[0, 1], [2, 3]], fn, ctls=ctls,
                                 round_timeout_s=2.0, expect_errors=True)
    finally:
        pagent.HostAgent.start = orig
    kind, dead, hvd303, dt = results[0]
    assert kind == "PeerFailureError" and dead == [2, 3], results
    assert hvd303 and dt < 10.0, results
    assert results[1][0] == "died", results


def test_torch_agent_names_its_origin():
    import inspect
    src = inspect.getsource(pagent)
    assert open(pagent.__file__).readline().startswith(
        "# Copied from horovod_tpu/common/host_agent.py:1-")
    assert "import jax" not in src and "horovod_tpu." not in src
