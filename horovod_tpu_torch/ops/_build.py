"""Build the port's CUDA kernels at first use and load them with ctypes.

The build-at-first-use pattern of ``horovod_tpu/common/native.py``: each
``ops/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, named by a hash of its source and of every
header beside it (``*.cuh``, ``*.h``) so that an edited source or shared
header never reuses a stale library, under ``build/kernels/`` beside
the package (listed in ``.gitignore``).  Concurrent builders serialise on a
file lock and write through a private temporary name.

Nothing here runs at import time: the CPU tests import every module of the
port, and this machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "ops", "csrc")
_OUT_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Compiler output of each kernel's build (``-Xptxas -v`` lists registers,
# shared memory and spills per kernel), kept beside the library.
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """``nvcc`` from PyTorch's ``CUDA_HOME``, else from ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (neither under torch's CUDA_HOME nor on PATH); "
            "the port's CUDA kernels cannot be built")
    return found


def sources() -> List[str]:
    """Every kernel source of the port, by name (``flash_fwd``, ...)."""
    return sorted(f[:-3] for f in os.listdir(_CSRC) if f.endswith(".cu"))


def _lib_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, named by a hash of the source and
    of every header in ``csrc/`` (any of them may be included)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_CSRC)
                     if f.endswith((".cuh", ".h")))
    for fname in [name + ".cu"] + headers:
        h.update(fname.encode() + b"\0")
        with open(os.path.join(_CSRC, fname), "rb") as fh:
            h.update(fh.read())
    return os.path.join(_OUT_DIR, f"lib{name}.{h.hexdigest()[:16]}.so")


def _reuse(name: str, out: str) -> str:
    """A library built earlier: its compiler output comes from beside it."""
    if name not in build_logs and os.path.exists(out + ".log"):
        with open(out + ".log") as fh:
            build_logs[name] = fh.read()
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of this exact source
    exists; returns the library's path."""
    os.makedirs(_OUT_DIR, exist_ok=True)
    out = _lib_path(name)
    if os.path.exists(out):
        return _reuse(name, out)
    import fcntl
    with open(os.path.join(_OUT_DIR, f"{name}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.exists(out):
            return _reuse(name, out)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3",
               "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, os.path.join(_CSRC, name + ".cu")]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            build_logs[name] = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu (rc {res.returncode}):\n"
                    f"{res.stderr[-4000:]}")
            with open(out + ".log", "w") as fh:
                fh.write(build_logs[name])
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build several kernels at once, one ``nvcc`` per source."""
    names = sources() if names is None else names
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
