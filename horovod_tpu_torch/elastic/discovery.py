# Copied from horovod_tpu/elastic/discovery.py:1-90, without
# TPUMetadataDiscovery (:93-177), which has no GPU counterpart: the script
# and fixed sources report no preemption notices; a HostDiscovery subclass
# passed to ElasticDriver posts them.
"""Host discovery for elastic training.

Parity: reference ``horovod/runner/elastic/discovery.py`` —
``HostDiscoveryScript`` executes the user's ``--host-discovery-script``
(lines of ``hostname`` or ``hostname:slots``) and the driver polls it for
changes.  On TPU the natural production implementation queries the GCE/TPU
metadata service for slice membership and preemption notices (SURVEY.md §5
"Failure detection"); the script interface is the cloud-agnostic contract.
"""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Dict, List, Set

from ..utils.logging import get_logger

log = get_logger()


@dataclasses.dataclass(frozen=True)
class DiscoveredHost:
    hostname: str
    slots: int


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> List[DiscoveredHost]:
        raise NotImplementedError

    def preemption_notices(self) -> Set[str]:
        """Hostnames with an ACTIVE preemption notice: the host
        is still alive — it stays in the discovered set — but the platform
        has announced it will be reclaimed soon.  The elastic driver
        reacts by cordoning the host and DRAINING its workers (commit →
        clean LEAVE → exit, with a ``preempt_grace_s`` deadline falling
        back to termination) so the departure is orderly instead of a
        mid-collective crash.  Default: none — script/fixed discovery
        sources have no preemption signal."""
        return set()


class HostDiscoveryScript(HostDiscovery):
    def __init__(self, script: str, default_slots: int = 1):
        self.script = script
        self.default_slots = default_slots

    def find_available_hosts_and_slots(self) -> List[DiscoveredHost]:
        out = subprocess.run(self.script, shell=True, capture_output=True,
                             text=True, timeout=60)
        if out.returncode != 0:
            raise RuntimeError(
                f"host discovery script failed (rc={out.returncode}): "
                f"{out.stderr.strip()}")
        return self.parse(out.stdout)

    def parse(self, text: str) -> List[DiscoveredHost]:
        hosts: List[DiscoveredHost] = []
        seen: Dict[str, int] = {}
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if ":" in line:
                name, slots = line.rsplit(":", 1)
                try:
                    h = DiscoveredHost(name.strip(), int(slots))
                except ValueError:
                    # Truncated/garbled output from a transient poll: skip
                    # the line rather than crash the elastic driver.
                    log.warning("host discovery: malformed line %r", line)
                    continue
            else:
                h = DiscoveredHost(line, self.default_slots)
            if h.hostname in seen:
                continue
            seen[h.hostname] = h.slots
            hosts.append(h)
        return hosts


class FixedHostDiscovery(HostDiscovery):
    """Static host list (used by tests and as a degenerate case)."""

    def __init__(self, hosts: List[DiscoveredHost]):
        self._hosts = list(hosts)

    def find_available_hosts_and_slots(self) -> List[DiscoveredHost]:
        return list(self._hosts)
