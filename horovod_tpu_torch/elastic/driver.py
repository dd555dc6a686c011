# Copied from horovod_tpu/elastic/driver.py:1-983, with _worker_env (:258-270)
# on the port's platform_worker_env and run_elastic (:909-983) on the port's
# tuning_env, and without the TPU metadata discovery; issue references are
# dropped from the comments.
"""The elastic driver: discovery polling, rank assignment, worker lifecycle.

Parity: reference ``horovod/runner/elastic/driver.py`` (``ElasticDriver``)
wired into ``horovodrun --min-np/--max-np --host-discovery-script``
(SURVEY.md §2b P10, §3.4): poll the discovery script, maintain the worker
registry and host blacklist, assign ranks, publish versioned rendezvous
generations, notify running workers of host changes, spawn/terminate worker
processes, and decide job success/failure against ``--min-np``.

TPU mapping (SURVEY.md §5): a "host" is a TPU-VM worker; discovery's
production source is the metadata service + preemption notices; losing a
host invalidates the ICI mesh, so a generation change means the surviving
workers tear the NCCL world down and re-form it (see
``worker.teardown_distributed``).
"""

from __future__ import annotations

import os
import socket
import subprocess
import threading
import time
from typing import Dict, List, Optional

from .discovery import DiscoveredHost, HostDiscovery, HostDiscoveryScript
from .registration import WorkerStateRegistry
from .rendezvous import RendezvousServer
from ..utils.logging import get_logger

log = get_logger()


from ..common.net import is_local_host, remote_ports  # noqa: E402
from ..common.net import reserve_ports  # noqa: E402


class ElasticDriver:
    # When True, every generation change kills and respawns ALL workers —
    # even survivors — instead of only replacing exited ones.  The process
    # path keeps this False (surviving workers re-rank in place by
    # long-polling the versioned rendezvous); executors whose workers are
    # one-shot closures with env baked at spawn (Ray actors) set it True
    # because their workers cannot pick up a new world without a restart.
    respawn_on_generation = False

    def __init__(self, discovery: HostDiscovery, command: List[str],
                 min_np: int, max_np: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None,
                 discovery_interval_s: float = 1.0,
                 start_timeout_s: float = 600.0,
                 rendezvous_addr: Optional[str] = None,
                 output_filename: Optional[str] = None,
                 verbose: int = 0,
                 discovery_grace_s: Optional[float] = None,
                 autoscale_policy=None,
                 autoscale_interval_s: float = 5.0,
                 autoscale_source=None,
                 scale_command: Optional[str] = None,
                 preempt_grace_s: float = 30.0):
        self.discovery = discovery
        self.command = command
        self.min_np = min_np
        self.max_np = max_np
        self.extra_env = dict(env or {})
        self.discovery_interval_s = discovery_interval_s
        self.start_timeout_s = start_timeout_s
        self.output_filename = output_filename
        self.verbose = verbose
        # Discovery-flap debounce: a host must stay MISSING from discovery
        # for this long before the driver drops it from the world.  One
        # bad poll (script hiccup, metadata blip) must not churn rank
        # assignments — appearing hosts still join immediately.  Default:
        # two polls' worth.
        self.discovery_grace_s = (2.0 * discovery_interval_s
                                  if discovery_grace_s is None
                                  else max(0.0, float(discovery_grace_s)))
        # Closed-loop autoscaling (docs/elastic.md): a ScalePolicy consumes
        # summaries from `autoscale_source` (default: rank 0's monitor
        # /health endpoint) and this driver executes the decisions —
        # scale_out through the operator's `scale_command`, evict/scale_in
        # through the drain pipeline (DRAIN ping → worker finishes its
        # batch → clean LEAVE → exit 0 → cordoned host leaves the world).
        self.autoscale_policy = autoscale_policy
        self.autoscale_interval_s = max(0.5, float(autoscale_interval_s))
        self._autoscale_source = autoscale_source
        self.scale_command = scale_command
        self.events: List[dict] = []    # executed decisions, for operators
                                        # and the scenario acceptance test
        # Preemption-driven drains: a discovery preemption
        # notice gets the DRAIN → clean LEAVE → cordon path, grace-bounded
        # — a worker still alive past preempt_grace_s is terminated (the
        # legacy sever), still classified as a departure.
        self.preempt_grace_s = max(0.0, float(preempt_grace_s))
        # Hosts cordoned BECAUSE of a preemption notice: released when the
        # notice clears (recreated preemptible hardware under the same
        # address must be able to rejoin), unlike evict cordons, which
        # persist.  Doubles as the handled-once marker: a cordoned host is
        # never re-drained while its notice stands.
        self._preempt_cordoned: set = set()
        self._drain_deadlines: Dict[str, float] = {}
        # Hierarchical control plane × elastic: when the worker
        # env arms HOROVOD_HIERARCHICAL_CONTROLLER, the driver allocates
        # ONE stable agent port per host — reused across generations, so
        # the generation-surviving HostAgent keeps its listen socket —
        # and ships it with every assignment.
        raw_hier = (self.extra_env.get("HOROVOD_HIERARCHICAL_CONTROLLER")
                    or os.environ.get("HVD_TPU_HIERARCHICAL_CONTROLLER")
                    or os.environ.get("HOROVOD_HIERARCHICAL_CONTROLLER")
                    or "")
        # The launcher's own environment counts too: workers inherit it
        # through _worker_env, so the driver must allocate stable agent
        # ports whenever the workers will run hierarchical — not only
        # when the CLI flag put the knob into extra_env.
        self._hier = str(raw_hier).strip().lower() in (
            "1", "true", "yes", "on")
        self._agent_ports: Dict[str, int] = {}
        # The live generation's local ports, held until the next
        # generation replaces it (``_held``), and those of the assignments
        # computed last, held until published or dropped (``_drawn``): a
        # launch beside this driver cannot draw them before the ranks and
        # agents bind them.
        self._held = reserve_ports(0)
        self._drawn = reserve_ports(0)

        self.registry = WorkerStateRegistry()
        self.rendezvous = RendezvousServer()
        # Explicit address wins; otherwise picked per generation: loopback
        # for all-local worlds, a routable driver address once any worker
        # is remote (a remote worker long-polling ITS OWN loopback for
        # assignments would hang until the start timeout).
        self._rdv_addr_explicit = rendezvous_addr
        self._rdv_addr = rendezvous_addr or "127.0.0.1"
        self._procs: Dict[str, subprocess.Popen] = {}
        self._hosts: List[DiscoveredHost] = []
        self._assigned: Dict[str, dict] = {}
        # Identities the driver itself terminated (host removed / shrunk):
        # their nonzero exit must not blacklist the host as a failure.
        self._released: set = set()
        # Identities the autoscaler asked to drain: their exit 0 is a
        # clean departure (record_left), never the job-success signal.
        self._draining: set = set()
        # Hosts the autoscaler retired (straggler evict / scale-in):
        # excluded from assignment like the blacklist, but clean — an
        # operator scale-out may un-cordon by naming them again through
        # `scale_command` + discovery.
        self._cordoned: set = set()
        # Discovery-flap debounce state: hostname -> (last_seen_monotonic,
        # last_known_slots).
        self._last_seen: Dict[str, tuple] = {}
        self._out_files: Dict[str, tuple] = {}  # identity -> open log files
        self._success = threading.Event()
        self._first_failure_rc = 0

    # ----------------------------------------------------------- assignment
    def active_hosts(self, discovered: List[DiscoveredHost]) -> List[DiscoveredHost]:
        return [h for h in discovered
                if not self.registry.is_blacklisted(h.hostname)
                and h.hostname not in self._cordoned]

    def _effective_hosts(self, discovered: List[DiscoveredHost],
                         now: float) -> List[DiscoveredHost]:
        """Discovery-flap debounce: the discovered set, plus hosts that
        vanished less than ``discovery_grace_s`` ago (kept at their last
        known slot count, in their original order — rank assignments must
        not churn when a host misses ONE poll and returns).  New hosts
        join immediately; blacklist/cordon filtering happens in
        ``active_hosts`` as usual."""
        for h in discovered:
            self._last_seen[h.hostname] = (now, h.slots)
        present = {h.hostname for h in discovered}
        out = list(discovered)
        for name, (seen, slots) in list(self._last_seen.items()):
            if name in present:
                continue
            if now - seen <= self.discovery_grace_s:
                out.append(DiscoveredHost(name, slots))
            else:
                del self._last_seen[name]
        # Deterministic order: the ORIGINAL first-seen order is what keeps
        # assignments stable across flaps (a host re-listed after its
        # one-poll absence must land back on its old ranks); hosts with no
        # previous position — the whole first generation, and any batch of
        # newcomers — keep their DISCOVERY order, preserving the
        # documented hostfile-order rank/coordinator placement.
        order = {h.hostname: i for i, h in enumerate(self._hosts)}
        base = len(order)
        disc_pos = {h.hostname: i for i, h in enumerate(discovered)}
        out.sort(key=lambda h: order.get(
            h.hostname, base + disc_pos.get(h.hostname, 0)))
        return out

    def compute_assignments(self, hosts: List[DiscoveredHost]) -> Dict[str, dict]:
        """Identity → assignment for one generation.  Rank order follows
        host order then local rank (the reference's hostfile-order rule);
        host 0 carries the coordinator."""
        slots = [(h.hostname, lr) for h in hosts for lr in range(h.slots)]
        if self.max_np is not None:
            slots = slots[:self.max_np]
        if len(slots) < self.min_np:
            return {}
        size = len(slots)
        hosts_in_use = []
        for hn, _ in slots:
            if hn not in hosts_in_use:
                hosts_in_use.append(hn)
        local_sizes = {hn: sum(1 for h, _ in slots if h == hn)
                       for hn in hosts_in_use}
        coord_host = ("127.0.0.1" if hosts_in_use[0] in ("localhost",
                                                         "127.0.0.1")
                      else hosts_in_use[0])
        # The controller binds on host 0, not on the driver: bind-probing is
        # only meaningful when they are the same machine.  For a remote host
        # 0 pick from a high range instead (seeded by generation so retries
        # move on); a collision there surfaces as a worker failure and the
        # next generation picks different ports.
        # Hierarchical control plane: one STABLE agent port per host,
        # allocated on the host's first generation and reused for every
        # later one — the generation-surviving HostAgent holds the listen
        # socket across re-rendezvous, so the port must never churn.
        # New LOCAL agent ports are drawn in the SAME reservation as the
        # controller ports, which holds them until the generation is
        # replaced.  (Already-cached agent ports can't collide: their
        # agents still hold the listeners, so a draw skips them.)
        new_local_agents = []
        if self._hier:
            for hn in hosts_in_use:
                if hn not in self._agent_ports:
                    if is_local_host(hn):
                        new_local_agents.append(hn)
                    else:
                        (ap,) = remote_ports(
                            1, 7919 + len(self._agent_ports))
                        self._agent_ports[hn] = ap
        local_coord = is_local_host(coord_host)
        self._drawn.release()
        self._drawn = reserve_ports(2 * local_coord + len(new_local_agents))
        ports = self._drawn.ports
        if local_coord:
            p1, p2 = ports[0], ports[1]
        else:
            p1, p2 = remote_ports(2, self.rendezvous.version + 1)
        for hn, ap in zip(new_local_agents, ports[2 * local_coord:]):
            self._agent_ports[hn] = ap
        assignments = {}
        for rank, (hn, lr) in enumerate(slots):
            assignments[f"{hn}:{lr}"] = {
                "rank": rank, "size": size,
                "local_rank": lr, "local_size": local_sizes[hn],
                "cross_rank": hosts_in_use.index(hn),
                "cross_size": len(hosts_in_use),
                "controller_addr": coord_host,
                "controller_port": p1, "controller_port2": p2,
                "hostname": hn,
            }
            if self._hier:
                assignments[f"{hn}:{lr}"]["agent_port"] = \
                    self._agent_ports[hn]
        return assignments

    # ------------------------------------------------------------ lifecycle
    def _worker_env(self, identity: str, hostname: str, local_rank: int):
        from ..runner.run import HostSpec, platform_worker_env
        env = dict(os.environ)
        env.update(self.extra_env)
        # An elastic worker's env is fixed at its spawn while its host
        # index changes between generations: the card's variables are
        # keyed on the host entry's name (platform_worker_env's elastic
        # form), which every generation keeps.
        env.update(platform_worker_env([HostSpec(hostname, 1)], 0, env,
                                       elastic=True))
        env.update({
            "HOROVOD_ELASTIC": "1",
            "HOROVOD_HOSTNAME": hostname,
            "HOROVOD_LOCAL_RANK": str(local_rank),
            "HOROVOD_RENDEZVOUS_ADDR": self._rdv_addr,
            "HOROVOD_RENDEZVOUS_PORT": str(self.rendezvous.port),
        })
        return env

    def _spawn(self, identity: str, assignment: dict):
        hostname = assignment["hostname"]
        env = self._worker_env(identity, hostname, assignment["local_rank"])
        stdout = stderr = None
        if self.output_filename:
            d = os.path.join(self.output_filename, identity.replace(":", "."))
            os.makedirs(d, exist_ok=True)
            # Append so respawns across generations extend one log; handles
            # are tracked and closed when the process is reaped.
            stdout = open(os.path.join(d, "stdout"), "a")
            stderr = open(os.path.join(d, "stderr"), "a")
            self._close_out_files(identity)
            self._out_files[identity] = (stdout, stderr)
        if is_local_host(hostname):
            # is_local_host (not a literal tuple): loopback aliases like
            # 127.0.0.2 — how tests and single-box deployments model
            # multi-host worlds — must spawn locally, not through ssh.
            proc = subprocess.Popen(self.command, env=env,
                                    stdout=stdout, stderr=stderr)
        else:
            from ..runner.run import ssh_command
            hvd_env = {k: v for k, v in env.items()
                       if k.startswith("HOROVOD_")}
            cmd = ssh_command(hostname, hvd_env, self.command)
            proc = subprocess.Popen(cmd, env=dict(os.environ),
                                    stdout=stdout, stderr=stderr)
        self._procs[identity] = proc
        self.registry.record_ready(identity)
        if self.verbose:
            log.warning("elastic driver: spawned %s (pid %s)", identity,
                        proc.pid)

    def _notify_workers(self, version: int):
        from ..common.net import retry_with_backoff
        ports = self.rendezvous.notification_ports()
        for identity, port in ports.items():
            if identity not in self._procs:
                continue
            host = identity.rsplit(":", 1)[0]
            addr = "127.0.0.1" if is_local_host(host) else host

            def _ping(addr=addr, port=port):
                # Per-attempt timeout sized so ALL attempts + backoff stay
                # inside the old single-attempt 5s budget: the notify loop
                # is serial, and it runs during exactly the host-failure
                # events that make workers unreachable — one dead worker
                # must not stall the re-rendezvous rollout for the rest.
                with socket.create_connection((addr, port), timeout=1.5) as s:
                    s.sendall(f"HOSTS_UPDATED {version}\n".encode())

            # Bounded retries with backoff + jitter: a worker mid-GC /
            # briefly partitioned must still learn about the host change
            # (a single 5s attempt used to warn-and-drop, leaving the
            # worker training against a dead generation until its next
            # commit raced the rendezvous).  Still best-effort after the
            # final attempt — the versioned rendezvous long-poll is the
            # correctness backstop; the ping is the latency optimization.
            try:
                retry_with_backoff(
                    _ping, retries=2, base_ms=200.0, max_ms=2000.0,
                    on_retry=lambda a, exc, d: log.info(
                        "elastic driver: notify %s attempt %d failed (%s);"
                        " retrying in %.1fs", identity, a + 1, exc, d))
            except OSError as exc:
                log.warning("elastic driver: notify %s failed after "
                            "retries: %s", identity, exc)

    # Assignment fields that define the world LAYOUT — everything except
    # the per-generation controller ports (freshly bind-probed each call,
    # so they always differ even when nothing else does).
    _LAYOUT_KEYS = ("rank", "size", "local_rank", "local_size",
                    "cross_rank", "cross_size", "hostname", "agent_port")

    def _same_layout(self, assignments: Dict[str, dict]) -> bool:
        def layout(table):
            return {i: tuple(a.get(k) for k in self._LAYOUT_KEYS)
                    for i, a in table.items()}
        return bool(self._assigned) and \
            layout(assignments) == layout(self._assigned)

    def _new_generation(self, hosts: List[DiscoveredHost]) -> bool:
        assignments = self.compute_assignments(hosts)
        drawn, self._drawn = self._drawn, reserve_ports(0)
        if not assignments:
            drawn.release()
            return False
        if self._same_layout(assignments):
            drawn.release()
            # No-op regeneration guard: the active membership
            # and rank layout are IDENTICAL to the live generation — the
            # only delta would be freshly-allocated controller ports.
            # Re-publishing forces every healthy worker through a full
            # teardown/re-init for nothing, and the sub-second
            # back-to-back generations it produces are exactly what
            # strands a joining rank on a superseded init barrier (e.g.
            # a cordoned host aging past the discovery-grace window
            # right after its drain already re-formed the world).  Keep
            # the live generation; just respawn any exited identities
            # into it.
            for identity, a in self._assigned.items():
                proc = self._procs.get(identity)
                if proc is None or proc.poll() is not None:
                    self._spawn(identity, a)
            return True
        self._assigned = assignments
        self._held.release()
        self._held = drawn
        if self._rdv_addr_explicit is None:
            from ..common.net import routable_addr
            self._rdv_addr = ("127.0.0.1"
                              if all(is_local_host(h.hostname) for h in hosts)
                              else routable_addr())
        version = self.rendezvous.publish(assignments)
        if self.verbose:
            log.warning("elastic driver: generation %s over %s", version,
                        sorted(assignments))
        # Terminate workers no longer assigned (removed/blacklisted hosts).
        for identity, proc in list(self._procs.items()):
            if identity not in assignments:
                self._released.add(identity)
                if proc.poll() is None:
                    proc.terminate()
        # Publish BEFORE notifying so a resetting worker always finds the
        # new generation waiting.
        self._notify_workers(version)
        for identity, a in assignments.items():
            proc = self._procs.get(identity)
            if (proc is not None and proc.poll() is None
                    and self.respawn_on_generation):
                # Replace the live worker: drop it from the table first so
                # its forced exit is never reaped as a host failure.
                del self._procs[identity]
                proc.terminate()
                proc = None
            if proc is None or proc.poll() is not None:
                self._spawn(identity, a)
        return True

    # ------------------------------------------------------------ main loop
    def run(self) -> int:
        deadline = time.monotonic() + self.start_timeout_s
        while True:
            try:
                discovered = self.discovery.find_available_hosts_and_slots()
            except Exception as exc:  # noqa: BLE001 - one bad poll must not
                # kill the driver (script timeout, malformed slots line, ...)
                log.warning("elastic driver: discovery failed: %s", exc)
                discovered = []
            # Effective = flap-debounced; blacklist/cordon applied at use.
            self._hosts = self._effective_hosts(discovered, time.monotonic())
            # Preemption notices gate the FIRST generation too: a host
            # with an active notice is cordoned (nothing is assigned yet,
            # so this is the cordon-only path) rather than knowingly
            # handed workers that would need an immediate drain.
            self._check_preemption()
            if self._new_generation(self.active_hosts(self._hosts)):
                break
            if time.monotonic() > deadline:
                log.warning("elastic driver: needed min_np=%s slots within "
                            "start timeout; giving up", self.min_np)
                self._shutdown_workers()
                return 1
            time.sleep(self.discovery_interval_s)

        last_poll = time.monotonic()
        last_autoscale = time.monotonic()
        while True:
            # 1. process exits
            changed = self._reap_exits()

            # 2. success: training completed on some rank; drain the rest
            if self._success.is_set():
                t_end = time.monotonic() + 30
                while self._procs and time.monotonic() < t_end:
                    for identity, proc in list(self._procs.items()):
                        if proc.poll() is not None:
                            del self._procs[identity]
                    time.sleep(0.1)
                self._shutdown_workers()
                return 0

            # 3. discovery poll (flap-debounced: a host must stay missing
            # past discovery_grace_s before it drops out of the world, so
            # one bad poll never churns rank assignments)
            if time.monotonic() - last_poll >= self.discovery_interval_s:
                last_poll = time.monotonic()
                try:
                    discovered = self.discovery.find_available_hosts_and_slots()
                    effective = self._effective_hosts(discovered,
                                                      time.monotonic())
                    if ([(h.hostname, h.slots) for h in effective]
                            != [(h.hostname, h.slots) for h in self._hosts]):
                        self._hosts = effective
                        changed = True
                except Exception as exc:  # noqa: BLE001 - transient poll
                    log.warning("elastic driver: discovery failed: %s", exc)
                # 3a. preemption notices: an imminently-
                # preempted host gets the proactive DRAIN → clean LEAVE →
                # cordon path — never a dead-peer verdict — handled on
                # every poll, with or without the autoscale policy
                # (hardware loss does not wait for an autoscale interval).
                self._check_preemption()

            # 3b. drain-grace enforcement: a drained worker that outlived
            # its deadline is terminated (the legacy sever fallback) —
            # still marked DRAINING, so the reap classifies it LEFT.
            self._enforce_drain_deadlines()

            # 3c. closed-loop autoscaling: consume monitor summaries, let
            # the policy decide, execute (docs/elastic.md).  Decisions
            # mutate the world only through the same discovery/cordon/
            # drain paths the rest of this loop already handles.
            if (self.autoscale_policy is not None
                    and time.monotonic() - last_autoscale
                    >= self.autoscale_interval_s):
                last_autoscale = time.monotonic()
                self._autoscale_step()

            # 4. re-form the world if needed.  The blacklist is re-applied
            # HERE so a failure-triggered regeneration excludes the host
            # that just failed, not only at discovery-poll boundaries.
            if changed:
                active = self.active_hosts(self._hosts)
                if not self._new_generation(active):
                    log.warning(
                        "elastic driver: %s slots < min_np=%s; aborting",
                        sum(h.slots for h in active), self.min_np)
                    self._shutdown_workers()
                    return self._first_failure_rc or 1

            time.sleep(0.05)

    def _reap_exits(self) -> bool:
        """Reap exited workers and classify each exit — the decision table
        the clean-exit tests pin (docs/elastic.md "Drain semantics"):

        - released (driver terminated it: host removed/shrunk) → LEFT;
        - draining (autoscale drain → clean LEAVE → exit) → LEFT: never
          the job-success signal, never a blacklisting failure — the host
          stays eligible for a later scale-out; triggers regeneration;
        - rc == 0 otherwise → SUCCESS (training completed somewhere);
        - rc != 0 → FAILURE: blacklist the host, trigger regeneration.

        Returns True when the world must re-form."""
        changed = False
        for identity, proc in list(self._procs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del self._procs[identity]
            self._close_out_files(identity)
            # A departed rank's shard server is gone with it: prune its
            # rendezvous state record so later peer restores don't burn
            # a connect timeout per corpse.
            self.rendezvous.drop_state(identity)
            if identity in self._released:
                self._released.discard(identity)
                self.registry.record_left(identity)
                continue
            if identity in self._draining:
                self._draining.discard(identity)
                self.registry.record_left(identity)
                if rc != 0:
                    log.warning("elastic driver: drained worker %s exited "
                                "rc=%s (expected 0)", identity, rc)
                changed = True
            elif rc == 0:
                self.registry.record_success(identity)
                if identity in self._assigned:
                    self._success.set()
            else:
                self.registry.record_failure(identity)
                if self.verbose:
                    log.warning("elastic driver: %s failed rc=%s",
                                identity, rc)
                if not self._success.is_set():
                    self._first_failure_rc = self._first_failure_rc or rc
                    changed = True
        return changed

    # ------------------------------------------------------- autoscaling
    def _default_autoscale_source(self):
        """Poll rank 0's monitor ``/health`` (which carries the
        ``RankAggregator.summary()`` fields — spread, trends, queue depth,
        cycle counters) for the policy's observation record.  Needs
        ``HOROVOD_MONITOR_PORT`` forwarded to the workers; returns None —
        a hold — when the exporter is not up (e.g. mid-re-rendezvous)."""
        import json
        import urllib.request
        port = int(self.extra_env.get("HOROVOD_MONITOR_PORT", "0") or 0)
        if port <= 0 or not self._assigned:
            return None
        a = next((a for a in self._assigned.values() if a["rank"] == 0),
                 None)
        if a is None:
            return None
        host = a["controller_addr"]
        with urllib.request.urlopen(f"http://{host}:{port}/health",
                                    timeout=2.0) as r:
            return json.loads(r.read().decode())

    def drain_worker(self, identity: str) -> bool:
        """Ask one worker to drain: finish its batch, send the clean
        LEAVE, exit 0 (``DRAIN`` verb on the notification channel —
        the worker-side handler raises ``DrainRequested`` from the next
        ``state.commit()``).  The identity's exit is then classified as a
        departure, never a failure.  Best-effort: False when the worker
        has no registered notification port or the ping failed."""
        if identity in self._draining:
            return True
        port = self.rendezvous.notification_ports().get(identity)
        if port is None:
            log.warning("elastic driver: cannot drain %s (no notification "
                        "port registered)", identity)
            return False
        host = identity.rsplit(":", 1)[0]
        addr = "127.0.0.1" if is_local_host(host) else host
        try:
            with socket.create_connection((addr, port), timeout=2.0) as s:
                s.sendall(b"DRAIN\n")
        except OSError as exc:
            log.warning("elastic driver: drain ping to %s failed: %s",
                        identity, exc)
            return False
        self._draining.add(identity)
        return True

    def cordon(self, hostname: str) -> None:
        """Retire a host from assignment (clean — unlike the blacklist,
        the record carries no failure; discovery dropping the host, or an
        operator re-adding capacity elsewhere, is the durable state)."""
        self._cordoned.add(hostname)

    # ------------------------------------------------- preemption drains
    def _request_commit_all(self, wait_s: float = 2.0) -> Dict[str, bool]:
        """Checkpoint pacing: ask every live worker to commit
        its elastic state NOW — sent immediately before an imminent
        scale/preemption decision executes, so the last commit predates
        the world change by milliseconds instead of a timer period.
        Best-effort, and fanned out in PARALLEL with a bounded wait: on
        the preemption path every second counts against the grace
        window, so one unreachable worker must not serialize the rest.
        The workers' own commit cadence is the backstop.

        Workers now ACK the ping, the per-worker acks
        are recorded in the event log (``action: commit_request``), and
        the dict is returned so the preempt drain can WAIT (grace-
        bounded) for the doomed host's ack before cordoning — previously
        nothing recorded whether any worker ever saw the request, and a
        drain could race its own in-flight snapshot ping."""
        acks: Dict[str, bool] = {}

        def _ping(identity, addr, port):
            try:
                with socket.create_connection((addr, port),
                                              timeout=1.0) as s:
                    s.sendall(b"COMMIT\n")
                    s.settimeout(max(0.5, wait_s))
                    # Read to the newline (bounded): a single recv can
                    # legally return a partial segment of "ACK\n", and a
                    # false-negative ack here cordons a host early on the
                    # exact path built to make acks truthful.
                    buf = b""
                    while b"\n" not in buf and len(buf) < 64:
                        c = s.recv(8)
                        if not c:
                            break
                        buf += c
                    if buf.startswith(b"ACK"):
                        acks[identity] = True
            except OSError:
                pass

        pings = []
        for identity, port in self.rendezvous.notification_ports().items():
            if identity not in self._procs:
                continue
            acks[identity] = False
            host = identity.rsplit(":", 1)[0]
            addr = "127.0.0.1" if is_local_host(host) else host
            t = threading.Thread(target=_ping, args=(identity, addr, port),
                                 daemon=True)
            t.start()
            pings.append(t)
        deadline = time.monotonic() + max(0.5, wait_s)
        for t in pings:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self.events.append({"action": "commit_request",
                            "acks": dict(acks),
                            "acked": sorted(i for i, ok in acks.items()
                                            if ok),
                            "ts": time.time()})
        return acks

    def _check_preemption(self) -> None:
        """Consume the discovery source's preemption notices.  A noticed
        ASSIGNED host is drained proactively — commit request → cordon →
        DRAIN pings with a ``preempt_grace_s`` deadline — so the
        departure takes the clean-LEAVE path before the hardware
        disappears.  A noticed host OUTSIDE the current assignment is
        cordoned too (a scale-out must never place workers on doomed
        hardware).  Preemption cordons are RELEASED when their notice
        clears: recreated preemptible hardware under the same address —
        the normal TPU preemption lifecycle — rejoins the world, and a
        later notice re-triggers the drain."""
        try:
            notices = set(self.discovery.preemption_notices())
        except Exception as exc:  # noqa: BLE001 - transient, like discovery
            log.warning("elastic driver: preemption poll failed: %s", exc)
            return
        for host in sorted(self._preempt_cordoned - notices):
            self._preempt_cordoned.discard(host)
            self._cordoned.discard(host)
            log.warning("elastic driver: preemption notice for %s "
                        "cleared; host un-cordoned", host)
        assigned_hosts = {a["hostname"] for a in self._assigned.values()}
        for host in sorted(notices):
            if host in self._cordoned:
                continue           # already handled (or evict-cordoned)
            self._preempt_cordoned.add(host)
            if host in assigned_hosts:
                self._preempt_drain(host)
            else:
                # Not in this world (yet): cordon only, so the doomed
                # host can't be assigned while the notice stands.
                self.cordon(host)
                log.warning("elastic driver: preemption notice for "
                            "unassigned host %s; cordoned", host)

    def _preempt_drain(self, host: str) -> None:
        """Execute one preemption drain.  The policy (when attached) is
        the decision source of record — a notice outranks its
        queue/straggler signals and opens its cooldown window — but the
        drain itself never waits on autoscaling being enabled.  min_np is
        deliberately NOT a guard here: the hardware is going away either
        way, and an orderly departure that later under-runs min_np still
        beats a mid-collective crash with a dead-peer verdict."""
        reason = f"preemption notice for host {host} (discovery)"
        if self.autoscale_policy is not None:
            try:
                decision = self.autoscale_policy.observe(
                    {}, size=len(self._assigned), preempt_hosts=(host,))
                if getattr(decision, "action", "") == "preempt":
                    reason = decision.reason
            except Exception:  # noqa: BLE001 - policy bookkeeping is
                pass           # advisory; the drain happens regardless
        log.warning("elastic driver: PREEMPT drain of host %s (%s)",
                    host, reason)
        self.events.append({"action": "preempt_drain", "host": host,
                            "reason": reason, "ts": time.time()})
        # Commit first (checkpoint pacing), then cordon so the clean exit
        # regenerates a world that excludes the host, then drain.  The
        # commit fan-out WAITS — bounded to a slice of the grace window —
        # for the workers' acks before the cordon: a
        # drain must not race an in-flight snapshot request, and a
        # missing ack is logged so the operator can see WHO never got the
        # pacing ping (its restore point is one timer period older).
        wait_s = (min(5.0, max(1.0, self.preempt_grace_s / 4.0))
                  if self.preempt_grace_s > 0 else 1.0)
        acks = self._request_commit_all(wait_s=wait_s)
        missing = sorted(i for i, ok in acks.items() if not ok)
        if missing:
            log.warning(
                "elastic driver: preempt drain of %s proceeding without "
                "commit acks from %s (waited %.1fs); their restore point "
                "is their last periodic commit", host, missing, wait_s)
        self.cordon(host)
        deadline = time.monotonic() + self.preempt_grace_s
        for identity, a in list(self._assigned.items()):
            if a["hostname"] != host:
                continue
            if self.drain_worker(identity):
                self._drain_deadlines[identity] = deadline
            else:
                # Unreachable worker: the termination fallback, marked
                # DRAINING so the reap still classifies it LEFT and
                # triggers the regeneration.
                proc = self._procs.get(identity)
                if proc is not None and proc.poll() is None:
                    self._draining.add(identity)
                    proc.terminate()

    def _enforce_drain_deadlines(self) -> None:
        """The grace fallback: a drained worker still alive past its
        deadline is terminated — the legacy sever path — but stays
        classified as a departure (DRAINING → LEFT), never a blacklist."""
        if not self._drain_deadlines:
            return
        now = time.monotonic()
        for identity, deadline in list(self._drain_deadlines.items()):
            proc = self._procs.get(identity)
            if proc is None or proc.poll() is not None:
                self._drain_deadlines.pop(identity, None)
                continue
            if now >= deadline:
                self._drain_deadlines.pop(identity, None)
                log.warning(
                    "elastic driver: drain grace (%.0fs) expired for %s; "
                    "falling back to termination", self.preempt_grace_s,
                    identity)
                proc.terminate()

    def _run_scale_command(self, action: str, decision,
                           host: Optional[str] = None) -> None:
        """Invoke the operator's capacity hook (``--scale-command``): a
        shell command receiving the decision through HVD_AUTOSCALE_*
        env — the cloud-agnostic seam where a deployment resizes its
        instance group / TPU slice pool.  Discovery is still the source
        of truth: the command changes what the discovery script reports,
        the driver reacts as it would to any host change."""
        if not self.scale_command:
            return
        env = dict(os.environ)
        env["HVD_AUTOSCALE_ACTION"] = action
        if decision.target_size is not None:
            env["HVD_AUTOSCALE_TARGET"] = str(decision.target_size)
        if host is not None:
            env["HVD_AUTOSCALE_HOST"] = host
        try:
            out = subprocess.run(self.scale_command, shell=True, env=env,
                                 capture_output=True, text=True, timeout=60)
            if out.returncode != 0:
                log.warning("elastic driver: scale command rc=%s: %s",
                            out.returncode, (out.stderr or "").strip())
        except Exception as exc:  # noqa: BLE001 - capacity hook is
            # best-effort; the policy retries after its cooldown
            log.warning("elastic driver: scale command failed: %s", exc)

    def _autoscale_step(self) -> None:
        """One observe→decide→execute turn of the autoscaler."""
        try:
            src = self._autoscale_source or self._default_autoscale_source
            summary = src()
        except Exception as exc:  # noqa: BLE001 - telemetry outage = hold
            log.info("elastic driver: autoscale source unavailable: %s",
                     exc)
            return
        if not summary:
            return
        decision = self.autoscale_policy.observe(summary,
                                                 size=len(self._assigned))
        if decision.is_hold:
            return
        # Checkpoint pacing: a non-hold decision is about to
        # change the world — ask every worker to commit NOW, not at its
        # next timer tick, so the restore point predates the change.
        self._request_commit_all()
        event = {"action": decision.action, "reason": decision.reason,
                 "target_size": decision.target_size,
                 "evict_rank": decision.evict_rank, "ts": time.time()}
        if decision.action == "evict":
            identity = next(
                (i for i, a in self._assigned.items()
                 if a["rank"] == decision.evict_rank), None)
            if identity is None or identity in self._draining:
                return
            host = self._assigned[identity]["hostname"]
            if not self._host_removable(host):
                log.warning(
                    "elastic driver: autoscale EVICT of %s skipped — "
                    "retiring host %s would drop below min_np=%s",
                    identity, host, self.min_np)
                return
            event["identity"], event["host"] = identity, host
            log.warning("elastic driver: autoscale EVICT %s (%s)",
                        identity, decision.reason)
            # Cordon first, then drain: when the worker's clean exit
            # triggers the regeneration, the host is already excluded.
            self.cordon(host)
            if not self.drain_worker(identity):
                # Unreachable worker: fall back to termination.  Marked
                # DRAINING (not released) so the reap classifies it as a
                # departure AND triggers the regeneration — a released
                # exit is silently skipped, which would leave the
                # survivors waiting on a generation that never forms.
                proc = self._procs.get(identity)
                if proc is not None and proc.poll() is None:
                    self._draining.add(identity)
                    proc.terminate()
            self._run_scale_command("evict", decision, host=host)
        elif decision.action == "scale_out":
            log.warning("elastic driver: autoscale SCALE_OUT -> %s (%s)",
                        decision.target_size, decision.reason)
            self._run_scale_command("scale_out", decision)
        elif decision.action == "scale_in":
            # Retire the LAST host of the current generation that does
            # not carry the coordinator (host 0 must survive a shrink).
            order: List[str] = []
            for a in sorted(self._assigned.values(),
                            key=lambda a: a["rank"]):
                if a["hostname"] not in order:
                    order.append(a["hostname"])
            victims = [h for h in order[1:] if self._host_removable(h)]
            if not victims:
                return
            host = victims[-1]
            event["host"] = host
            log.warning("elastic driver: autoscale SCALE_IN: draining "
                        "host %s (%s)", host, decision.reason)
            self.cordon(host)
            for identity, a in self._assigned.items():
                if a["hostname"] == host:
                    self.drain_worker(identity)
            self._run_scale_command("scale_in", decision, host=host)
        self.events.append(event)

    def _host_removable(self, host: str) -> bool:
        """min_np at HOST granularity: the policy approves scale-in/evict
        from rank counts, but retiring a host removes ALL its slots —
        on multi-slot hosts that can undershoot min_np and the driver
        would abort the whole job at the next regeneration.  A host is
        removable only if the surviving assignment still covers min_np."""
        remaining = sum(1 for a in self._assigned.values()
                        if a["hostname"] != host)
        return remaining >= self.min_np

    def _close_out_files(self, identity: str):
        for fh in self._out_files.pop(identity, ()):
            try:
                fh.close()
            except OSError:  # pragma: no cover
                pass

    def _shutdown_workers(self):
        # Snapshot: tests (and operators) may call this from another
        # thread while the run loop's reap is still mutating the table.
        procs = list(self._procs.values())
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        t_end = time.monotonic() + 10
        for proc in procs:
            while proc.poll() is None and time.monotonic() < t_end:
                time.sleep(0.05)
            if proc.poll() is None:
                proc.kill()
        self._procs.clear()
        for identity in list(self._out_files):
            self._close_out_files(identity)
        self._held.release()
        self.rendezvous.stop()


def run_elastic(args) -> int:
    """``python -m horovod_tpu_torch.runner --host-discovery-script`` entry
    (reference: ``_run_elastic``)."""
    min_np = args.min_np or args.np or 1
    max_np = args.max_np
    discovery = HostDiscoveryScript(args.host_discovery_script,
                                    default_slots=args.slots_per_host or 1)
    # One knob table for every launch path: tuning_env covers the fusion/
    # cycle/pipeline/stall/monitor/autotune/checkpoint/controller flags, so
    # a knob can never work on the static path and silently vanish on the
    # elastic one.
    from ..runner.run import tuning_env
    extra_env = tuning_env(args)
    # Trace/timeline filenames travel as the BASE: ranks are assigned at
    # rendezvous, so elastic workers apply the shared per-rank suffix
    # (utils.timeline.per_rank_filename) in elastic_bootstrap — the same
    # <base>.<rank> names every other launch path produces.
    if getattr(args, "timeline_filename", None):
        extra_env["HOROVOD_TIMELINE"] = args.timeline_filename
    if getattr(args, "trace_filename", None):
        extra_env["HOROVOD_TRACE"] = args.trace_filename
    # Closed-loop autoscaling (docs/elastic.md): the policy lives in the
    # DRIVER process, parameterized from the same HOROVOD_AUTOSCALE_*
    # env table Config documents (the launcher's env, not the workers').
    from ..common.config import Config
    cfg = Config.from_env()
    autoscale_on = cfg.autoscale or getattr(args, "autoscale", False)
    policy = None
    if autoscale_on:
        from .autoscale import ScalePolicy
        policy = ScalePolicy(
            min_np=min_np, max_np=max_np,
            queue_high=cfg.autoscale_queue_high,
            queue_trend_up=cfg.autoscale_queue_trend,
            straggler_factor=cfg.autoscale_straggler_factor,
            persistence=cfg.autoscale_persistence,
            cooldown_s=cfg.autoscale_cooldown_s,
            idle_s=cfg.autoscale_idle_s,
            commit_max_age_s=cfg.commit_max_age_s,
            rate_high=cfg.autoscale_rate_high,
            latency_target_ms=cfg.autoscale_latency_target_ms,
            idle_qps=cfg.autoscale_idle_qps)
        if not extra_env.get("HOROVOD_MONITOR_PORT"):
            log.warning(
                "autoscale enabled without --monitor-port: the driver has "
                "no monitor endpoint to observe, so the policy will hold "
                "forever; pass --monitor-port to close the loop")
    driver = ElasticDriver(
        discovery, args.command, min_np=min_np, max_np=max_np,
        env=extra_env, start_timeout_s=args.start_timeout,
        output_filename=args.output_filename, verbose=args.verbose,
        autoscale_policy=policy,
        autoscale_interval_s=(getattr(args, "autoscale_interval", None)
                              or cfg.autoscale_interval_s),
        scale_command=getattr(args, "scale_command", None),
        # `is not None`, not `or`: an explicit --preempt-grace-s 0
        # (terminate immediately) is a valid setting, not an unset one.
        preempt_grace_s=(getattr(args, "preempt_grace_s", None)
                         if getattr(args, "preempt_grace_s", None)
                         is not None else cfg.preempt_grace_s))
    try:
        return driver.run()
    finally:
        try:
            driver.rendezvous.stop()
        except Exception:  # noqa: BLE001 - already stopped
            pass
