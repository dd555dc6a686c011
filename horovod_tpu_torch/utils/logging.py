# Copied from horovod_tpu/utils/logging.py:1-41 (jax-free; the port keeps its own copy).
"""Logging, mirroring the reference's LOG(level) surface.

Reference: ``horovod/common/logging.cc`` (SURVEY.md §2a N23) —
``HOROVOD_LOG_LEVEL`` in {trace, debug, info, warning, error, fatal},
``HOROVOD_LOG_TIMESTAMP`` toggles timestamps.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_logger = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("horovod_tpu_torch")
        level_name = os.environ.get("HVD_TPU_LOG_LEVEL",
                                    os.environ.get("HOROVOD_LOG_LEVEL", "warning"))
        _logger.setLevel(_LEVELS.get(level_name.strip().lower(), logging.WARNING))
        handler = logging.StreamHandler(sys.stderr)
        ts = os.environ.get("HOROVOD_LOG_TIMESTAMP", "1").lower() not in ("0", "false")
        fmt = "[%(asctime)s] [%(levelname)s] %(message)s" if ts else "[%(levelname)s] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        _logger.addHandler(handler)
        _logger.propagate = False
    return _logger
