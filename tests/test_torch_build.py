"""How the torch package builds its CUDA libraries, checked on the CPU (no
``nvcc`` is run): a library is stale when any header its sources include
is newer than it, ``nvcc`` is handed the ``.cu`` files only, and both
kernel libraries watch ``csrc/probe.cuh``.  Also the wrappers' probe-mask
limit.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu_torch.ops import _build
from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
from multithreading_string_matching_tpu_torch.ops import cuda_window as cw


@pytest.fixture
def sources(tmp_path):
    """``a.cu`` includes ``b.cuh``, which includes ``sub/c.cuh``; a library
    built after all three."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.cu").write_text('#include <cstdint>\n#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n  #  include "sub/c.cuh"\n')
    (tmp_path / "sub" / "c.cuh").write_text("#pragma once\n")
    lib = tmp_path / "liba.so"
    lib.write_bytes(b"")
    for i, f in enumerate(("a.cu", "b.cuh", "sub/c.cuh")):
        os.utime(tmp_path / f, (1000 + i, 1000 + i))
    os.utime(lib, (2000, 2000))
    return tmp_path, lib


def test_dependencies_follow_quoted_includes(sources):
    d, _ = sources
    deps = _build.dependencies([d / "a.cu"])
    assert deps == [d / "a.cu", d / "b.cuh", d / "sub" / "c.cuh"]


@pytest.mark.parametrize("newer", ["a.cu", "b.cuh", "sub/c.cuh", None])
def test_a_newer_header_makes_the_library_stale(sources, newer):
    d, lib = sources
    if newer is not None:
        os.utime(d / newer, (3000, 3000))
    stale = _build.is_stale(lib, _build.dependencies([d / "a.cu"]))
    assert stale == (newer is not None)
    # The .cu file alone, as the build checked before, misses a newer header.
    assert _build.is_stale(lib, [d / "a.cu"]) == (newer == "a.cu")


def test_nvcc_gets_only_cu_files(sources, monkeypatch):
    d, _ = sources
    calls = []

    def compile_to(cmd, srcs, out):
        calls.append((list(cmd), [pathlib.Path(s) for s in srcs], out))
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(b"")
        return ""

    monkeypatch.setattr(_build, "BUILD_DIR", d / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "compile_to", compile_to)
    path, _, _ = _build.build_cuda("x", [d / "a.cu", d / "b.cuh"])
    assert path == d / "build" / "libx.so"
    assert len(calls) == 1 and calls[0][0][0] == "nvcc"
    assert calls[0][1] == [d / "a.cu"]
    # Current now: no second build until a header changes.
    os.utime(path, (5000, 5000))
    _build.build_cuda("x", [d / "a.cu"])
    assert len(calls) == 1
    os.utime(d / "sub" / "c.cuh", (6000, 6000))
    _build.build_cuda("x", [d / "a.cu"])
    assert len(calls) == 2 and calls[1][1] == [d / "a.cu"]


def test_both_kernel_libraries_watch_the_probe_header():
    header = _build.CSRC_DIR / "probe.cuh"
    assert header.exists()
    for lib in (cw.LIBRARY, cw.FIND_LIBRARY, ct.LIBRARY):
        assert all(s.suffix == ".cu" for s in lib.sources)
        assert header in _build.dependencies(lib.sources)


def _masks(values):
    return torch.tensor(np.array(values, dtype=np.uint32).view(np.int32))[:, None]


def test_probe_mask_limit():
    eight = [0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF, 0xFF00, 0xFF0000, 0xFF000000, 0x00FF00FF]
    ok = _masks(eight + [0, 0, 0xFF])  # zeros are not probe masks; repeats count once
    cw.check_probe_masks(ok, 0)
    assert ok._msm_probe_masks[1] == 8
    with pytest.raises(ValueError, match="9 distinct"):
        cw.check_probe_masks(_masks(eight + [0xFFFF0000]), 0)
    # An in-place change is seen (the tensor's version counter).
    ok[0, 0] = 0x7F
    with pytest.raises(ValueError, match="9 distinct"):
        cw.check_probe_masks(ok, 0)
    # The filter form checks column K, not word 0.
    two = torch.cat([_masks(eight + [0xFFFF0000]), _masks([0xFFFFFFFF] * 9)], dim=1)
    cw.check_probe_masks(two, 1)
    with pytest.raises(ValueError):
        cw.check_probe_masks(two, 0)
