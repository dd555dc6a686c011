# Copied from horovod_tpu/elastic/driver.py:1-983, with _worker_env (:258-270)
# on the port's platform_worker_env and run_elastic (:909-983) on the port's
# tuning_env, without the TPU metadata discovery, and without the autoscaler
# and the preemption drains (:548-881 and the state and loop steps only they
# use; their flags are refused, ROADMAP queue 1 item 6b).
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


from ..common.net import free_ports as _free_ports  # noqa: E402
from ..common.net import is_local_host, remote_ports  # noqa: E402


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
                 discovery_grace_s: Optional[float] = None):
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
        # Hierarchical control plane × elastic (ISSUE 12): when the worker
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
        # Discovery-flap debounce state: hostname -> (last_seen_monotonic,
        # last_known_slots).
        self._last_seen: Dict[str, tuple] = {}
        self._out_files: Dict[str, tuple] = {}  # identity -> open log files
        self._success = threading.Event()
        self._first_failure_rc = 0

    # ----------------------------------------------------------- assignment
    def active_hosts(self, discovered: List[DiscoveredHost]) -> List[DiscoveredHost]:
        return [h for h in discovered
                if not self.registry.is_blacklisted(h.hostname)]

    def _effective_hosts(self, discovered: List[DiscoveredHost],
                         now: float) -> List[DiscoveredHost]:
        """Discovery-flap debounce: the discovered set, plus hosts that
        vanished less than ``discovery_grace_s`` ago (kept at their last
        known slot count, in their original order — rank assignments must
        not churn when a host misses ONE poll and returns).  New hosts
        join immediately; blacklist filtering happens in
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
        # New LOCAL agent ports are allocated in the SAME free_ports call
        # as the controller ports: probing them separately would close
        # the controller probes first, and the kernel may hand the agent
        # the just-freed controller port — a same-process EADDRINUSE on
        # the rank-0 host.  (Already-cached agent ports can't collide:
        # their agents still hold the listeners, so free_ports skips
        # them.)
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
        if is_local_host(coord_host):
            ports = _free_ports(2 + len(new_local_agents))
            p1, p2 = ports[0], ports[1]
            for hn, ap in zip(new_local_agents, ports[2:]):
                self._agent_ports[hn] = ap
        else:
            p1, p2 = remote_ports(2, self.rendezvous.version + 1)
            for hn in new_local_agents:
                (ap,) = _free_ports(1)
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
        if not assignments:
            return False
        if self._same_layout(assignments):
            # No-op regeneration guard (ISSUE 14): the active membership
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
            # Effective = flap-debounced; blacklist applied at use.
            self._hosts = self._effective_hosts(discovered, time.monotonic())
            if self._new_generation(self.active_hosts(self._hosts)):
                break
            if time.monotonic() > deadline:
                log.warning("elastic driver: needed min_np=%s slots within "
                            "start timeout; giving up", self.min_np)
                self._shutdown_workers()
                return 1
            time.sleep(self.discovery_interval_s)

        last_poll = time.monotonic()
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
            # a connect timeout per corpse (ISSUE 14).
            self.rendezvous.drop_state(identity)
            if identity in self._released:
                self._released.discard(identity)
                self.registry.record_left(identity)
                continue
            if rc == 0:
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
        self.rendezvous.stop()


def run_elastic(args) -> int:
    """``python -m horovod_tpu_torch.runner --host-discovery-script`` entry
    (reference: ``_run_elastic``)."""
    min_np = args.min_np or args.np or 1
    max_np = args.max_np
    discovery = HostDiscoveryScript(args.host_discovery_script,
                                    default_slots=args.slots_per_host or 1)
    # One knob table for every launch path: tuning_env covers the fusion/
    # cycle/pipeline/stall/monitor/autotune/checkpoint flags, so a knob can
    # never work on the static path and silently vanish on the elastic
    # one.
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
    driver = ElasticDriver(
        discovery, args.command, min_np=min_np, max_np=max_np,
        env=extra_env, start_timeout_s=args.start_timeout,
        output_filename=args.output_filename, verbose=args.verbose)
    try:
        return driver.run()
    finally:
        try:
            driver.rendezvous.stop()
        except Exception:  # noqa: BLE001 - already stopped
            pass
