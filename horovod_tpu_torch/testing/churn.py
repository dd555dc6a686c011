# Copied from horovod_tpu/testing/churn.py:1-579 (issue references dropped
# from the comments); it runs over the port's coordinator
# (common/native.py), host agent and state plane.
"""Churn-scenario runner: scripted membership change against the REAL
native control plane.

Where :mod:`horovod_tpu_torch.testing.faults` injects ONE failure at a named
protocol point, this module replays a whole churn SCRIPT — clean LEAVEs,
join epochs, agent death, preemption-notice drains
(:func:`~.faults.parse_churn` grammar) — against a running
``horovod_tpu_torch/csrc/coordinator.cc`` root, flat (one connection per
rank) or hierarchical (ranks behind real per-host
:class:`~..common.host_agent.HostAgent` aggregators).  The simulated
ranks speak raw warm-path frames (the steady-state floor: no full
announces, empty bitvector, no tags), so what is measured is pure
control-plane service — the same world the ``negotiation_scaling`` bench
drives, now with churn injected mid-run.

Execution model: the measured rounds are split into PHASES at each
scripted event's round.  Rank threads free-run the rounds inside a phase
(lock-step with the server, no artificial gates on the hot path); between
phases the main thread applies the due events deterministically — marks
leavers/joiners (their next round frame is the LEAVE / join announce),
kills agents, expands a preemption notice into the host's drain.  Every
phase reports its own wall-per-round and the root's own service time
(``hvdtpu_server_stats`` deltas), so a slope can be read ACROSS the churn,
not just before it.

A typed ABORT (or an unexplained sever) observed by any rank ends the run
with ``survived=False`` and the abort's attribution — which is itself a
valid scenario outcome: ``agent_crash`` on a host with live ranks is
DEFINED to abort with host-granular attribution, and the tests pin both
directions.
"""

from __future__ import annotations

import ctypes
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence

from .faults import ChurnEvent, _HOST_VERBS
from ..utils.logging import get_logger

log = get_logger()

_LEAVE_WIRE = struct.pack("<I", 8) + struct.pack(
    "<II", 0xFFFFFFFE, 0x3645564C)
_ABORT_ESCAPE = 0xFFFFFFFF

# The 12-byte steady-state warm frame: n_full=0, empty bitvector, n_tag=0.
_WARM_PAYLOAD = struct.pack("<III", 0, 0, 0)
_WARM_WIRE = struct.pack("<I", len(_WARM_PAYLOAD)) + _WARM_PAYLOAD
# Round-1 frame: the warm core plus the LVE6 + FLT1 capability ads (the
# client contract keeps FLT1 LAST — the server's abort-path salvage reads
# the final 8 bytes).  Without the LVE6 ad the server would IGNORE every
# scripted LEAVE (it only honors one when all survivors latched v6) and
# the leaver's socket close would sever the fleet.
_CAP_PAYLOAD = (_WARM_PAYLOAD
                + struct.pack("<II", 0x3645564C, 0)      # LVE6 ad
                + struct.pack("<II", 0x31544C46, 0))     # FLT1 ad
_CAP_WIRE = struct.pack("<I", len(_CAP_PAYLOAD)) + _CAP_PAYLOAD


def _join_wire() -> bytes:
    """A full-announce frame carrying only the reserved join name."""
    payload = struct.pack("<I", 1)       # n_announce
    payload += struct.pack("<H", 0)      # required (0 = world)
    for field in (b"\x1f__join__", b"", b"-1", b"-1", b""):
        payload += struct.pack("<H", len(field)) + field
    payload += struct.pack("<II", 0, 0)  # empty bitvector + n_tag
    return struct.pack("<I", len(payload)) + payload


_JOIN_WIRE = _join_wire()


def _read_frame(sock: socket.socket) -> Optional[bytes]:
    buf = b""
    while len(buf) < 4:
        c = sock.recv(4 - len(buf))
        if not c:
            return None
        buf += c
    (n,) = struct.unpack("<I", buf)
    data = b""
    while len(data) < n:
        c = sock.recv(min(n - len(data), 65536))
        if not c:
            return None
        data += c
    return data


class ChurnRunner:
    """Replay one churn script against a fresh native root server.

    ``world`` simulated ranks, grouped ``ranks_per_host`` to a host
    (hosts are the targets of the host verbs; required whenever the
    script names one).  ``hier=True`` puts a real :class:`HostAgent` in
    front of every host's ranks — the scale-out control plane under
    churn.  ``rounds`` measured rounds after ``warm`` warmup rounds;
    events' ``at_round`` index into the measured range.
    """

    def __init__(self, world: int, ranks_per_host: int = 0,
                 hier: bool = False, rounds: int = 30, warm: int = 5,
                 script: Sequence[ChurnEvent] = (),
                 connect_timeout_ms: int = 30000,
                 round_deadline_ms: int = 0,
                 state_dir: Optional[str] = None,
                 serve_state: bool = True):
        if world < 2:
            raise ValueError("ChurnRunner needs world >= 2")
        if hier and ranks_per_host <= 0:
            raise ValueError("hier=True needs ranks_per_host > 0")
        self.world = int(world)
        self.hier = bool(hier)
        self.rounds = int(rounds)
        # At least one warm round: it carries the LVE6/FLT1 capability
        # ads, without which the server degrades every LEAVE to a sever.
        self.warm = max(1, int(warm))
        self.script = sorted(script, key=lambda e: e.at_round)
        self.connect_timeout_ms = int(connect_timeout_ms)
        self.round_deadline_ms = int(round_deadline_ms)
        rph = int(ranks_per_host) if ranks_per_host else 0
        if any(e.verb in _HOST_VERBS for e in self.script) and rph <= 0:
            raise ValueError("host-targeted churn verbs need ranks_per_host")
        self.hosts: List[List[int]] = (
            [list(range(i, min(world, i + rph)))
             for i in range(0, world, rph)] if rph > 0 else
            [[r] for r in range(world)])
        for e in self.script:
            if e.at_round > self.rounds:
                raise ValueError(
                    f"churn event {e} beyond the run ({self.rounds} rounds)")
            if e.verb in _HOST_VERBS and int(e.target) >= len(self.hosts):
                raise ValueError(f"churn event {e}: no host {e.target}")
            if e.verb in ("leave", "rejoin_restore") \
                    and int(e.target) >= world:
                raise ValueError(f"churn event {e}: no rank {e.target}")
            if e.verb == "agent_crash" and not self.hier:
                raise ValueError("agent_crash needs hier=True (no agents "
                                 "exist on the flat plane)")
        # Resilient state plane: rejoin_restore replays a
        # replacement rank's state recovery against the survivors' shard
        # servers / the shared manifest directory.  The target must have
        # departed in an EARLIER event, or there is nothing to rejoin.
        self._needs_state = any(e.verb == "rejoin_restore"
                                for e in self.script)
        for e in self.script:
            if e.verb != "rejoin_restore":
                continue
            r = int(e.target)
            departed = any(
                (p.verb == "leave" and int(p.target) == r)
                or (p.verb == "preempt_notice"
                    and r in self.hosts[int(p.target)])
                for p in self.script if p.at_round < e.at_round)
            if not departed:
                raise ValueError(
                    f"churn event {e}: rank {r} never departed before "
                    f"its rejoin_restore (add a leave/preempt first)")
        self.state_dir = state_dir
        self.serve_state = bool(serve_state)
        self._planes: List = []
        # Phases: [warm] + measured segments split at each event round.
        bounds = sorted({e.at_round for e in self.script})
        self._phases: List[dict] = []
        if self.warm:
            self._phases.append({"rounds": self.warm, "events": [],
                                 "measured": False})
        prev = 1
        for b in bounds:
            if b > prev:
                self._phases.append({"rounds": b - prev, "events": [],
                                     "measured": True})
            self._phases.append(
                {"rounds": 0, "measured": True,
                 "events": [e for e in self.script if e.at_round == b]})
            prev = b
        if self.rounds + 1 > prev:
            self._phases.append({"rounds": self.rounds + 1 - prev,
                                 "events": [], "measured": True})
        # Merge each zero-round event marker into the phase that follows
        # it (events fire BEFORE that phase's first round).
        merged: List[dict] = []
        pending_events: List[ChurnEvent] = []
        for ph in self._phases:
            if ph["rounds"] == 0:
                pending_events.extend(ph["events"])
                continue
            ph["events"] = pending_events + ph["events"]
            pending_events = []
            merged.append(ph)
        if pending_events:
            # Events scheduled after the final round: give them a
            # zero-length tail phase is meaningless — fire after last
            # phase instead (recorded, mostly for leave-at-end scripts).
            merged.append({"rounds": 1, "events": pending_events,
                           "measured": True})
        self._phases = merged

        # Runtime state.
        self._directives: List[Dict[int, str]] = [
            {} for _ in self._phases]
        self._go = [threading.Event() for _ in self._phases]
        self._done_lock = threading.Lock()
        self._done_count = [0] * len(self._phases)
        self._done_cv = threading.Condition(self._done_lock)
        self._abort = threading.Event()
        self._stop = threading.Event()
        self._left: set = set()
        self._dead: set = set()
        self.failures: List[tuple] = []
        self.abort_reason: Optional[str] = None
        self.events_fired: List[dict] = []
        self.drained_hosts: List[int] = []
        # State-plane runtime (rejoin_restore scripts only).
        self._state_left: set = set()
        self._state_epoch = 0
        self.restores: List[dict] = []

    # ------------------------------------------------------------- threads
    def _done(self, phase: int) -> None:
        with self._done_cv:
            self._done_count[phase] += 1
            self._done_cv.notify_all()

    def _fail(self, rank: int, why: str, abort: bool = False) -> None:
        self.failures.append((rank, why))
        self._dead.add(rank)
        if abort and not self._abort.is_set():
            self.abort_reason = self.abort_reason or why
            self._abort.set()

    def _rank_loop(self, rank: int, connect_port: int) -> None:
        sock = None
        try:
            deadline = time.monotonic() + self.connect_timeout_ms / 1000.0
            while time.monotonic() < deadline and not self._stop.is_set():
                try:
                    sock = socket.create_connection(
                        ("127.0.0.1", connect_port), timeout=5)
                    break
                except OSError:
                    time.sleep(0.02)
            if sock is None:
                self._fail(rank, "never connected", abort=True)
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(struct.pack("<I", rank))
            first_send = True
            for p, phase in enumerate(self._phases):
                if not self._go[p].wait(timeout=120):
                    self._fail(rank, f"phase {p} gate timeout", abort=True)
                    return
                if self._stop.is_set() or self._abort.is_set():
                    return
                d = self._directives[p].get(rank, "")
                if d == "leave":
                    # The LEAVE is this rank's round frame for the phase's
                    # first round; no response is owed to a leaver.  The
                    # brief linger lets the frame land before the EOF.
                    sock.sendall(_LEAVE_WIRE)
                    self._left.add(rank)
                    time.sleep(0.05)
                    sock.close()
                    sock = None
                    self._done(p)
                    return
                for i in range(phase["rounds"]):
                    if i == 0 and d == "join":
                        wire = _JOIN_WIRE
                    elif first_send:
                        wire = _CAP_WIRE
                    else:
                        wire = _WARM_WIRE
                    first_send = False
                    sock.sendall(wire)
                    resp = _read_frame(sock)
                    if resp is None:
                        self._fail(rank, "severed by the control plane",
                                   abort=True)
                        self._done(p)
                        return
                    if len(resp) >= 4 and struct.unpack_from(
                            "<I", resp)[0] == _ABORT_ESCAPE:
                        self._fail(rank, f"typed abort: {resp[8:64]!r}",
                                   abort=True)
                        self._done(p)
                        return
                self._done(p)
        except OSError as exc:
            self._fail(rank, repr(exc), abort=True)
            with self._done_cv:
                self._done_cv.notify_all()
        finally:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    # --------------------------------------------------------- state plane
    def _synthetic_state(self, epoch: int) -> dict:
        """Deterministic per-epoch state every live rank holds identically
        (the bitwise-restore assertion compares against exactly this).

        Includes a sharded-optimizer saveable in the exact
        rank-invariant marker form ``JaxState.save`` emits for a
        ``DistributedOptimizer(sharded=True)`` state, so rejoin_restore
        also proves a re-joiner re-slices exactly its own 1/N optimizer
        shard from the recovered commit."""
        import numpy as np
        return {"step": epoch,
                "params": (np.arange(512, dtype=np.float32)
                           * float(epoch)),
                "opt": {"__hvd_sharded_opt__": 1, "world": self.world,
                        "plan": {},
                        "inner_states": [
                            {"mu": np.arange(self.world * 64,
                                             dtype=np.float32)
                             + float(epoch),
                             "count": np.int32(epoch)}]}}

    def _state_setup(self) -> None:
        import tempfile

        from ..elastic.stateplane import StatePlane
        if self.state_dir is None:
            self.state_dir = tempfile.mkdtemp(prefix="hvd_churn_state_")
        self._planes = [StatePlane(self.state_dir, rank=r, world=self.world,
                                   serve=self.serve_state)
                        for r in range(self.world)]
        self._advance_state_epoch()          # epoch 1: the disk baseline

    def _advance_state_epoch(self) -> None:
        """Every live rank commits the next epoch (inline durable write;
        the wire fleet is untouched) — the survivors' state moving on
        past a departure, which is what makes a later rejoiner's PEER
        path strictly newer than its own last epoch.  Survivors re-shard
        over the SHRUNK world, exactly like the real re-rendezvous
        (elastic_bootstrap re-assigns rank/world): without it, every
        post-departure epoch would be missing the leaver's shard and
        never complete on disk."""
        self._state_epoch += 1
        state = self._synthetic_state(self._state_epoch)
        live = [r for r, plane in enumerate(self._planes)
                if plane is not None and r not in self._state_left
                and r not in self._dead]
        for i, r in enumerate(live):
            plane = self._planes[r]
            plane.rank, plane.world = i, len(live)
            plane.commit(state=state, epoch=self._state_epoch)

    def _state_depart(self, rank: int) -> None:
        if not self._planes:
            return
        self._state_left.add(rank)
        plane = self._planes[rank]
        if plane is not None:
            plane.close()        # a departed rank serves no shards

    def _rejoin_restore(self, rank: int) -> dict:
        """A fresh replacement rank's state recovery: reset the plane
        (epoch -1, empty memory — a new process knows nothing) and
        restore peer-first from the live survivors' shard servers, disk
        manifest as the fallback.  Returns the assertion record."""
        from ..elastic.stateplane import StatePlane
        old = self._planes[rank]
        if old is not None:
            old.close()
        plane = StatePlane(self.state_dir, rank=rank, world=self.world,
                           serve=self.serve_state)
        self._planes[rank] = plane
        peers = [("127.0.0.1", p.server.port)
                 for i, p in enumerate(self._planes)
                 if p is not None and i != rank and p.server is not None
                 and i not in self._state_left and i not in self._dead]
        try:
            data, epoch, source = plane.restore(peers=peers)
            rec = {"restore_source": source, "restore_epoch": epoch,
                   "disk_reads": plane.disk_reads,
                   "peer_shards": plane.peer_shards_fetched}
            # Shard-native optimizer restore: the recovered
            # sharded-optimizer saveable must yield exactly this rank's
            # own 1/N slice under the pad+slice convention.
            opt = data.get("opt") if isinstance(data, dict) else None
            if isinstance(opt, dict) and opt.get("__hvd_sharded_opt__"):
                import numpy as np

                from ..elastic.stateplane import shard_slice_array
                full = np.asarray(opt["inner_states"][0]["mu"])
                got = shard_slice_array(full, rank, int(opt["world"]))
                want = np.arange(self.world * 64, dtype=np.float32)
                want = want + float(epoch)
                per = want.size // int(opt["world"])
                rec["opt_shard_ok"] = bool(
                    np.array_equal(got, want[rank * per:(rank + 1) * per]))
                rec["opt_shard_len"] = int(got.size)
        except FileNotFoundError as exc:
            rec = {"restore_source": None, "restore_error": str(exc)}
        else:
            self._state_left.discard(rank)
        self.restores.append(dict(rec, rank=rank))
        return rec

    # -------------------------------------------------------------- events
    def _apply_events(self, phase_idx: int, events: List[ChurnEvent],
                      agents: list) -> None:
        directives = self._directives[phase_idx]
        for e in events:
            rec = {"verb": e.verb, "target": e.target,
                   "at_round": e.at_round}
            if e.verb == "leave":
                r = int(e.target)
                if r not in self._left and r not in self._dead:
                    directives[r] = "leave"
                    self._state_depart(r)
                    if self._planes:
                        self._advance_state_epoch()
            elif e.verb == "rejoin_restore":
                rec.update(self._rejoin_restore(int(e.target)))
            elif e.verb == "join":
                targets = ([int(e.target)] if e.target != "*" else
                           [r for r in range(self.world)
                            if r not in self._left and r not in self._dead])
                for r in targets:
                    if directives.get(r) != "leave":
                        directives[r] = "join"
                rec["ranks"] = targets
            elif e.verb == "preempt_notice":
                # The driver's DRAIN → clean LEAVE path, compressed to the
                # wire: every live rank of the host departs this phase.
                h = int(e.target)
                self.drained_hosts.append(h)
                drained = []
                for r in self.hosts[h]:
                    if r not in self._left and r not in self._dead:
                        directives[r] = "leave"
                        drained.append(r)
                        self._state_depart(r)
                if drained and self._planes:
                    self._advance_state_epoch()
                rec["ranks"] = drained
            elif e.verb == "agent_crash":
                h = int(e.target)
                if agents and h < len(agents):
                    agents[h].kill()
                    rec["live_ranks"] = [
                        r for r in self.hosts[h]
                        if r not in self._left and r not in self._dead]
            self.events_fired.append(rec)

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        from ..common.host_agent import HostAgent
        from ..common.native import load as _load
        from ..common.net import reserve_ports

        lib = _load()
        if self._needs_state and not self._planes:
            self._state_setup()
        with reserve_ports(1) as held:
            (port,) = held.ports
            server = lib.hvdtpu_server_start(
                port, self.world, ctypes.c_double(600.0), 2048,
                self.round_deadline_ms, 0, 0)
        if not server:
            raise RuntimeError(f"churn server failed to start on {port}")
        agents: List[HostAgent] = []
        connect_port = {r: port for r in range(self.world)}
        if self.hier:
            agents = [HostAgent(0, "127.0.0.1", port, ranks, host_index=j,
                                connect_timeout_ms=self.connect_timeout_ms
                                ).start()
                      for j, ranks in enumerate(self.hosts)]
            for a, ranks in zip(agents, self.hosts):
                for r in ranks:
                    connect_port[r] = a.port
        threads = [threading.Thread(target=self._rank_loop,
                                    args=(r, connect_port[r]), daemon=True)
                   for r in range(self.world)]
        stats = (ctypes.c_double * 2)()

        def server_totals():
            """(rounds_served, total_service_us) — per-phase deltas give
            the root's own service time across the churn."""
            if lib.hvdtpu_server_stats(server, stats) != 0:
                return 0.0, 0.0
            return float(stats[0]), float(stats[0]) * float(stats[1])

        phase_reports: List[dict] = []
        try:
            for t in threads:
                t.start()
            for p, phase in enumerate(self._phases):
                if self._abort.is_set():
                    break
                self._apply_events(p, phase["events"], agents)
                # Leavers count as participants: they play the phase's
                # first round (their LEAVE frame) and signal done.
                live = [r for r in range(self.world)
                        if r not in self._left and r not in self._dead]
                participants = len(live)
                if participants <= 1:
                    break   # a 1-rank fleet has nothing to negotiate with
                r0, ns0 = server_totals()
                t0 = time.perf_counter()
                self._go[p].set()
                deadline = time.monotonic() + 120
                with self._done_cv:
                    while (self._done_count[p] < participants
                           and not self._abort.is_set()):
                        if time.monotonic() > deadline:
                            self.abort_reason = (self.abort_reason
                                                 or f"phase {p} timed out")
                            self._abort.set()
                            break
                        self._done_cv.wait(timeout=0.5)
                wall = time.perf_counter() - t0
                r1, ns1 = server_totals()
                if phase["measured"] and phase["rounds"] > 0 \
                        and not self._abort.is_set():
                    phase_reports.append({
                        "rounds": phase["rounds"],
                        "live_ranks": participants,
                        "wall_us_per_round": round(
                            wall / phase["rounds"] * 1e6, 1),
                        "root_us": round((ns1 - ns0) / (r1 - r0), 1)
                        if r1 > r0 else None,
                    })
        finally:
            self._stop.set()
            self._abort.set()         # release any rank blocked in a gate
            for ev in self._go:
                ev.set()
            for t in threads:
                t.join(timeout=15)
            for a in agents:
                try:
                    a.stop()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
            for p in self._planes:
                try:
                    if p is not None:
                        p.close()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
            lib.hvdtpu_server_stop(server)
        survived = self.abort_reason is None
        measured = [ph for ph in phase_reports if ph["root_us"] is not None]
        return {
            "world": self.world,
            "hier": self.hier,
            "hosts": len(self.hosts),
            "rounds": self.rounds,
            "survived": survived,
            "abort_reason": self.abort_reason,
            "left_ranks": sorted(self._left),
            "drained_hosts": sorted(set(self.drained_hosts)),
            "restores": self.restores,
            "state_epoch": self._state_epoch if self._planes else None,
            "events_fired": self.events_fired,
            "failures": self.failures[:8],
            "phases": phase_reports,
            "root_us_pre": measured[0]["root_us"] if measured else None,
            "root_us_post": measured[-1]["root_us"] if measured else None,
            "wall_us_per_round": round(
                sum(ph["wall_us_per_round"] * ph["rounds"]
                    for ph in phase_reports)
                / max(1, sum(ph["rounds"] for ph in phase_reports)), 1)
            if phase_reports else None,
            "root_us": round(
                sum((ph["root_us"] or 0.0) * ph["rounds"] for ph in measured)
                / max(1, sum(ph["rounds"] for ph in measured)), 1)
            if measured else None,
        }
