"""``python -m horovod_tpu_torch.runner -np N [options] <command>``."""

import sys

from .launch import run_commandline

if __name__ == "__main__":
    sys.exit(run_commandline())
