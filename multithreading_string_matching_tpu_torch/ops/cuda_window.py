"""Hand-written Hopper kernels for the window matcher, and their wrappers.

Counterpart of ``multithreading_string_matching_tpu/ops/pallas_window.py``.
The two CUDA kernels in ``csrc/window_count.cu`` replace the TPU kernel
``_make_kernel`` in its totals form (``_one_tile``) and its per-row form
(``_one_tile_rows``).  The library is built with ``nvcc`` from the checkout
on first use (ops/_build.py) and bound with ctypes.

The wrappers :func:`window_count_totals` and :func:`window_count_rows`
take the plain version (ops/window.window_count) for tensors on the CPU and
launch the kernel for tensors on a CUDA device; on a CUDA tensor they launch
or raise, never fall back.  ``LAUNCHES`` counts kernel launches by name, so
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import torch

from multithreading_string_matching_tpu_torch.ops._build import CSRC_DIR, build_cuda
from multithreading_string_matching_tpu_torch.ops.window import WindowProgram, window_count

SOURCES = [CSRC_DIR / "window_count.cu"]

# Kernel launches by kernel name, for this process.  Incremented only where
# a wrapper launches its kernel.
LAUNCHES: Dict[str, int] = {"window_count_totals": 0, "window_count_rows": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def load_library(verbose_ptxas: bool = False) -> ctypes.CDLL:
    """Build (when stale) and load the kernel library; raises on failure.
    ``BUILD_INFO`` records the library path, compile seconds and compiler
    output of this process's build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path, seconds, log = build_cuda(
            "msm_window_count", SOURCES, verbose_ptxas=verbose_ptxas
        )
        lib = ctypes.CDLL(str(path))
        for fn in (lib.msm_window_count_totals, lib.msm_window_count_rows):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p,
            ]
        lib.msm_cuda_error_string.restype = ctypes.c_char_p
        lib.msm_cuda_error_string.argtypes = [ctypes.c_int]
        BUILD_INFO.update(path=str(path), seconds=seconds, log=log)
        _lib = lib
        return _lib


def _check(payload, lengths, words, masks, lens) -> None:
    """Validate what the kernels take: raise on anything else."""
    dev = payload.device
    for name, t, dtype, ndim in (
        ("payload", payload, torch.uint8, 2),
        ("lengths", lengths, torch.int32, 1),
        ("words", words, torch.int32, 2),
        ("masks", masks, torch.int32, 2),
        ("lens", lens, torch.int32, 1),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, payload on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = payload.shape[0]
    U, K = words.shape
    if lengths.shape[0] != n:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, payload {n}")
    if masks.shape != words.shape or lens.shape[0] != U:
        raise ValueError(
            f"table shapes disagree: words {tuple(words.shape)}, "
            f"masks {tuple(masks.shape)}, lens {tuple(lens.shape)}"
        )


def _launch(name: str, payload, lengths, words, masks, lens, out) -> None:
    n, L = payload.shape
    U, K = words.shape
    if n == 0 or L == 0 or U == 0:
        return  # nothing to count: the zeroed output is the answer
    lib = load_library()
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    rc = getattr(lib, f"msm_{name}")(
        payload.data_ptr(), lengths.data_ptr(), words.data_ptr(),
        masks.data_ptr(), lens.data_ptr(), out.data_ptr(),
        n, L, U, K, payload.device.index or 0, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} "
            f"({lib.msm_cuda_error_string(rc).decode()})"
        )
    LAUNCHES[name] += 1


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no window-count kernel for device {t.device}")
    return t.device.type


def window_count_totals(payload, lengths, words, masks, lens) -> torch.Tensor:
    """int32[U] totals in build order over one ``uint8[n, L]`` tile.

    Exact while the tile has fewer than 2^31 positions (``n * L``): a
    position starts at most one match per pattern.
    """
    if _device_kind(payload) == "cpu":
        return window_count(words, masks, lens, payload, lengths, per_packet=False)
    _check(payload, lengths, words, masks, lens)
    n, L = payload.shape
    if n * L >= 2**31:
        raise ValueError(
            f"tile of {n} x {L} positions overflows the int32 counters; "
            "split it into smaller tiles"
        )
    out = torch.zeros(words.shape[0], dtype=torch.int32, device=payload.device)
    _launch("window_count_totals", payload, lengths, words, masks, lens, out)
    return out


def window_count_rows(payload, lengths, words, masks, lens) -> torch.Tensor:
    """int32[n, U] per-row counts in build order over one tile."""
    if _device_kind(payload) == "cpu":
        return window_count(words, masks, lens, payload, lengths, per_packet=True)
    _check(payload, lengths, words, masks, lens)
    out = torch.zeros(
        (payload.shape[0], words.shape[0]), dtype=torch.int32, device=payload.device
    )
    _launch("window_count_rows", payload, lengths, words, masks, lens, out)
    return out


class CudaWindowMatcher:
    """Tile-count surface over the window kernels, for one pattern program
    on one device (the counterpart of ``PallasWindowMatcher``).

    Tables stay on the device and are passed to every launch, so a new
    pattern set needs new tables and no new build.  Results are in build
    order; ``expand_duplicates`` maps them to pattern-file order through
    ``dup_map``.
    """

    def __init__(self, wp: WindowProgram, device="cuda"):
        self.wp = wp
        self.device = torch.device(device)
        self.num_unique = int(wp.pat_words.shape[0])
        self.words, self.masks, self.lens = wp.tables(self.device)
        self.dup = torch.from_numpy(wp.dup_map).to(self.device, torch.long)

    def _tile(self, p, l) -> Tuple[torch.Tensor, torch.Tensor]:
        return (
            torch.as_tensor(p, dtype=torch.uint8, device=self.device).contiguous(),
            torch.as_tensor(l, dtype=torch.int32, device=self.device).contiguous(),
        )

    def count_tiles(self, tiles, *, expand_duplicates: bool = True) -> torch.Tensor:
        """int32 totals summed over ``(payloads, lengths)`` tiles."""
        total = torch.zeros(self.num_unique, dtype=torch.int32, device=self.device)
        for p, l in tiles:
            total += window_count_totals(*self._tile(p, l), self.words, self.masks, self.lens)
        return total[self.dup] if expand_duplicates else total

    def count_tiles_per_row(self, tiles, *, expand_duplicates: bool = True) -> List[torch.Tensor]:
        """One int32[rows_i, U or P] matrix per tile."""
        outs = []
        for p, l in tiles:
            out = window_count_rows(*self._tile(p, l), self.words, self.masks, self.lens)
            outs.append(out[:, self.dup] if expand_duplicates else out)
        return outs

    def count_tile_summary(self, payloads, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(totals int32[U] in build order, row_hits bool[n])`` for one tile,
        reduced on the device."""
        rows = window_count_rows(
            *self._tile(payloads, lengths), self.words, self.masks, self.lens
        )
        return rows.sum(dim=0, dtype=torch.int32), rows.sum(dim=1) > 0

