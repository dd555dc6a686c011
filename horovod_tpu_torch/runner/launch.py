# Copied from horovod_tpu/runner/launch.py:1-21.
"""The launcher's command-line entry point.

Equivalent of the reference's ``horovod/runner/launch.py`` (SURVEY.md §2b P7,
§3.3).  The launcher (arg surface, hostfile parsing, the bootstrap probe,
ssh/local spawn) lives in this package; this module wires the CLI.
"""

from __future__ import annotations

import sys


def run_commandline(argv=None) -> int:
    from .run import main
    return main(argv if argv is not None else sys.argv[1:])


if __name__ == "__main__":
    sys.exit(run_commandline())
