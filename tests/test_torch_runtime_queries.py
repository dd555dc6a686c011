"""The runtime queries the port gained: ``cross_rank``, ``cross_size`` and
``is_homogeneous`` against the JAX package's under the same launcher
environments, the build's capability probes against torch's own answers,
and ``profile_step`` writing a Chrome trace (the counterpart of
``tests/test_basics.py``'s profiler test).

The JAX functions read the launcher's ``HOROVOD_CROSS_RANK``/
``HOROVOD_CROSS_SIZE`` through their ``Config`` and otherwise the
topology's processes; a JAX process of a host is a port host here, so the
JAX topology is given the same ranks per host as the port's
``HOROVOD_LOCAL_COUNTS``.
"""

import json
import types

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.common import basics as jax_basics
from horovod_tpu.common.config import Config as JaxConfig
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.topology import build_topology


@pytest.fixture(autouse=True)
def _fresh_runtime():
    """Each test starts and ends with the port's runtime shut down (an
    earlier test file in the same process may have left it up)."""
    hvd.shutdown()
    yield
    hvd.shutdown()


# (size, rank, HOROVOD_LOCAL_COUNTS, HOROVOD_CROSS_RANK, _CROSS_SIZE)
ENVS = [
    (1, 0, "", "", ""),
    (6, 0, "2,1,3", "0", "3"),
    (6, 2, "2,1,3", "1", "3"),
    (6, 5, "2,1,3", "2", "3"),
    (6, 4, "2,1,3", "", ""),
    (4, 1, "2,2", "0", "2"),
    (4, 3, "2,2", "1", "2"),
    (4, 2, "2,2", "", ""),
    (2, 1, "1,1", "1", "2"),
]


def _host_of(counts, rank):
    first = 0
    for h, c in enumerate(counts):
        if rank < first + c:
            return h
        first += c
    raise ValueError(rank)


@pytest.mark.parametrize("size,rank,counts,cross_rank,cross_size", ENVS)
def test_torch_host_queries_match_jax(monkeypatch, size, rank, counts,
                                      cross_rank, cross_size):
    for var, val in (("HOROVOD_LOCAL_COUNTS", counts),
                     ("HOROVOD_CROSS_RANK", cross_rank),
                     ("HOROVOD_CROSS_SIZE", cross_size)):
        if val:
            monkeypatch.setenv(var, val)
        else:
            monkeypatch.delenv(var, raising=False)
    local = [int(c) for c in counts.split(",")] if counts else [1]
    monkeypatch.setattr(jax_basics, "_cfg", JaxConfig.from_env)
    monkeypatch.setattr(jax_basics, "_topo", lambda: types.SimpleNamespace(
        local_counts=local, num_processes=len(local),
        my_process=_host_of(local, rank)))
    st = types.SimpleNamespace(initialized=True, size=size, rank=rank,
                               config=Config.from_env(),
                               topology=build_topology(size, rank))
    monkeypatch.setattr(basics, "_state", st)
    assert hvd.cross_rank() == jax_basics.cross_rank()
    assert hvd.cross_size() == jax_basics.cross_size()
    assert hvd.is_homogeneous() == jax_basics.is_homogeneous()
    assert hvd.is_homogeneous() == (counts not in ("2,1,3",))


def test_torch_host_queries_need_init():
    for fn in (hvd.cross_rank, hvd.cross_size, hvd.is_homogeneous):
        with pytest.raises(basics.NotInitializedError):
            fn()


def test_torch_host_queries_at_size_one():
    hvd.init(device="cpu")
    try:
        assert (hvd.cross_rank(), hvd.cross_size(),
                hvd.is_homogeneous()) == (0, 1, True)
    finally:
        hvd.shutdown()


def _torch_answer(name):
    import torch.distributed as dist
    return {"nccl_built": dist.is_available() and dist.is_nccl_available(),
            "gloo_enabled": dist.is_available()
            and dist.is_gloo_available(),
            "mpi_enabled": dist.is_available() and dist.is_mpi_available(),
            "mpi_threads_supported": False,
            "cuda_built": torch.backends.cuda.is_built(),
            "rocm_built": torch.version.hip is not None}[name]


@pytest.mark.parametrize("name", ["nccl_built", "gloo_enabled",
                                  "mpi_enabled", "mpi_threads_supported",
                                  "cuda_built", "rocm_built"])
def test_torch_capability_probes(name):
    got = getattr(hvd, name)()
    assert type(got) is bool
    assert got == bool(_torch_answer(name))


def test_torch_profile_step_writes_a_chrome_trace(tmp_path):
    hvd.init(device="cpu")
    try:
        with hvd.profile_step(str(tmp_path / "prof")):
            hvd.grouped_allreduce([torch.ones(64), torch.ones(8)],
                                  name="prof")
        with pytest.raises(RuntimeError):
            hvd.stop_profile()
        hvd.start_profile(str(tmp_path / "prof2"))
        with pytest.raises(RuntimeError):
            hvd.start_profile(str(tmp_path / "prof2"))
        path = hvd.stop_profile()
    finally:
        hvd.shutdown()
    files = list((tmp_path / "prof").glob("*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]
    assert path.startswith(str(tmp_path / "prof2"))
    assert json.loads(open(path).read())["traceEvents"] is not None


def test_torch_binding_exports_the_queries():
    """The names the JAX torch binding has that the port lacked."""
    import horovod_tpu.torch as jax_binding
    for name in ("cross_rank", "cross_size", "is_homogeneous",
                 "nccl_built", "gloo_enabled", "mpi_enabled",
                 "mpi_threads_supported", "cuda_built", "rocm_built",
                 "start_timeline", "stop_timeline", "start_profile",
                 "stop_profile", "profile_step"):
        assert callable(getattr(hvd, name)), name
        assert hasattr(jax_binding, name), name
