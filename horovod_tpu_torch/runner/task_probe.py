# Copied from horovod_tpu/runner/task_probe.py:1-28.
"""Per-host bootstrap probe entry point (reference:
``horovod/runner/task/__main__.py`` task service — SURVEY.md P8).

Launched by the driver on every host (directly or over ssh) BEFORE the
workers: reports NICs, then participates in the mutual connectivity check.
Uses only the standard library beyond the package's own import.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="task_probe")
    p.add_argument("--driver-addr", required=True)
    p.add_argument("--driver-port", type=int, required=True)
    p.add_argument("--label", required=True)
    p.add_argument("--nic", default=None)
    args = p.parse_args(argv)
    from .bootstrap import probe_main
    return probe_main(args.driver_addr, args.driver_port, args.label,
                      args.nic)


if __name__ == "__main__":
    sys.exit(main())
