"""Build native code from the checkout's sources into the package's
git-ignored ``build/`` directory, and load it with ctypes.

Native libraries are built here, each on first use:

- the C++ pcap ingest (``multithreading_string_matching_tpu/native/
  pcap_ingest.cpp``, read by path, never imported) with ``g++``;
- the Hopper kernels (``csrc/*.cu``) with ``nvcc`` for ``sm_90a``, one
  library per source, each a plain C interface bound with ctypes
  (:class:`KernelLibrary`).

Every build compiles to a per-process temporary name and renames it into
place, so concurrent processes (pytest workers, a CLI beside a benchmark)
never load a half-written library.  Neither package ever writes the other's
library.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = PKG_DIR / "build"
CSRC_DIR = PKG_DIR / "csrc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def is_stale(out: pathlib.Path, sources: Sequence[pathlib.Path]) -> bool:
    """True when ``out`` is missing or older than any of ``sources``."""
    if not out.exists():
        return True
    mtime = out.stat().st_mtime
    return any(s.stat().st_mtime > mtime for s in sources)


def compile_to(cmd_prefix: List[str], sources: Sequence[pathlib.Path],
               out: pathlib.Path) -> str:
    """Run ``cmd_prefix -o <tmp> sources`` and rename the result to ``out``.

    Returns the compiler's combined output; raises ``RuntimeError`` with it
    when the compile fails.
    """
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [*cmd_prefix, "-o", str(tmp), *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{log}")
    os.replace(tmp, out)
    return log


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or ``nvcc`` on the PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from csrc/ on first use"
        )
    return found


def build_cuda(name: str, sources: Sequence[pathlib.Path], *,
               verbose_ptxas: bool = False) -> "tuple[pathlib.Path, float, str]":
    """Build ``sources`` into ``build/lib<name>.so`` when stale.

    Returns ``(path, seconds spent compiling, compiler output)``; seconds is
    0 when the library was already current.
    """
    out = BUILD_DIR / f"lib{name}.so"
    if not is_stale(out, sources):
        return out, 0.0, ""
    flags = list(NVCC_FLAGS)
    if verbose_ptxas:
        flags += ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    log = compile_to([find_nvcc(), *flags], sources, out)
    return out, time.perf_counter() - t0, log


class KernelLibrary:
    """One CUDA library, built from ``sources`` on first use and loaded with
    ctypes.  ``signatures`` maps each C entry point to its argument types;
    every entry point returns a CUDA error code, which :meth:`call` turns
    into a ``RuntimeError``.  ``build_info`` records the library path, the
    compile seconds and the compiler output of this process's build."""

    def __init__(self, name: str, sources: Sequence[pathlib.Path],
                 signatures: Dict[str, list]):
        self.name = name
        self.sources = list(sources)
        self.signatures = signatures
        self.build_info: Dict[str, object] = {}
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def load(self, verbose_ptxas: bool = False) -> ctypes.CDLL:
        """Build (when stale) and load the library; raises on failure."""
        with self._lock:
            if self._lib is None:
                path, seconds, log = build_cuda(
                    self.name, self.sources, verbose_ptxas=verbose_ptxas
                )
                lib = ctypes.CDLL(str(path))
                for entry, argtypes in self.signatures.items():
                    fn = getattr(lib, entry)
                    fn.restype = ctypes.c_int
                    fn.argtypes = argtypes
                lib.msm_cuda_error_string.restype = ctypes.c_char_p
                lib.msm_cuda_error_string.argtypes = [ctypes.c_int]
                self.build_info.update(path=str(path), seconds=seconds, log=log)
                self._lib = lib
            return self._lib

    def call(self, entry: str, *args) -> None:
        """Launch ``entry``; raise with the CUDA error when it is refused."""
        lib = self.load()
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            raise RuntimeError(
                f"{entry} launch failed: CUDA error {rc} "
                f"({lib.msm_cuda_error_string(rc).decode()})"
            )
