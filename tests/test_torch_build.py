"""The port's kernel build names each library by its source and by every
header beside it, so that an edited shared header (``csrc/hopper.cuh``)
never leaves a stale library in use, reuses a library of the same name, and
raises without ``nvcc``.  No ``nvcc`` needed: only the names are computed
and no build runs."""

import os
import shutil

import pytest

from horovod_tpu_torch.ops import _build


@pytest.fixture()
def csrc_copy(tmp_path, monkeypatch):
    """A private copy of ``ops/csrc`` that ``_build`` reads instead."""
    dst = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, dst)
    monkeypatch.setattr(_build, "_CSRC", str(dst))
    return dst


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_torch_build_header_edit_renames_library(csrc_copy, name):
    before = _build._lib_path(name)
    assert before == _build._lib_path(name)     # stable for one content
    header = csrc_copy / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build._lib_path(name)
    assert after != before
    assert os.path.dirname(after) == os.path.dirname(before)


def test_torch_build_new_header_renames_and_is_no_source(csrc_copy):
    before = {n: _build._lib_path(n) for n in _build.sources()}
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    (csrc_copy / "extra.h").write_text("#pragma once\n")
    assert _build.sources() == sorted(before)   # headers are not sources
    assert "extra" not in _build.sources()
    for n, path in before.items():
        assert _build._lib_path(n) != path


def test_torch_build_source_edit_renames_only_its_library(csrc_copy):
    before = {n: _build._lib_path(n) for n in _build.sources()}
    src = csrc_copy / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._lib_path("flash_fwd") != before["flash_fwd"]
    assert _build._lib_path("flash_bwd") == before["flash_bwd"]


@pytest.fixture()
def out_dir(tmp_path, monkeypatch):
    """A private ``build/kernels`` that ``_build`` writes instead."""
    dst = tmp_path / "kernels"
    monkeypatch.setattr(_build, "_OUT_DIR", str(dst))
    return dst


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_torch_build_existing_library_is_reused(out_dir, monkeypatch, name):
    """A library of this exact source is returned as it is: no compiler is
    looked for, nor any log written."""
    def no_nvcc():
        raise AssertionError("nvcc looked for")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    out_dir.mkdir()
    path = _build._lib_path(name)
    open(path, "wb").close()
    assert _build.build(name) == path
    assert name not in _build.build_logs


def test_torch_build_without_nvcc_raises(out_dir, monkeypatch):
    """Without ``nvcc`` a build raises and leaves no library behind."""
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_fwd")
    assert not any(p.suffix == ".so" for p in out_dir.iterdir())
