"""Hand-written Hopper kernels for the window matcher, and their wrappers.

Counterpart of ``multithreading_string_matching_tpu/ops/pallas_window.py``.
The CUDA kernels in ``csrc/window_count.cu`` replace the TPU kernel
``_make_kernel`` in its totals form (``_one_tile``, and ``_one_tile_repeated``
through the totals kernel's repeats grid axis) and its per-row form
(``_one_tile_rows``), and ``_make_halo_kernel`` (``_halo_run``, the flow
stream's scan rounds).  The library is built with ``nvcc`` from the
checkout on first use (ops/_build.py) and bound with ctypes.

The wrappers :func:`window_count_totals`, :func:`window_count_rows` and
:func:`window_count_halo` take the plain version (ops/window.py) for
tensors on the CPU and launch the kernel for tensors on a CUDA device; on a
CUDA tensor they launch or raise, never fall back.  ``LAUNCHES`` counts
kernel launches by name (a totals launch with ``reps > 1`` counts as
``window_count_totals_repeated``), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from multithreading_string_matching_tpu_torch.ops._build import CSRC_DIR, KernelLibrary
from multithreading_string_matching_tpu_torch.ops.window import (
    WindowProgram,
    window_count,
    window_count_halo_plain,
)

SOURCES = [CSRC_DIR / "window_count.cu"]

# Kernel launches by kernel name, for this process.  Incremented only where
# a wrapper launches its kernel.
LAUNCHES: Dict[str, int] = {
    "window_count_totals": 0, "window_count_rows": 0, "window_count_totals_repeated": 0,
    "window_count_halo": 0,
}

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
LIBRARY = KernelLibrary("msm_window_count", SOURCES, {
    # ..., n, L, U, K, reps, device, stream
    "msm_window_count_totals": _ARGS + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    # ..., n, L, U, K, device, stream
    "msm_window_count_rows": _ARGS + [ctypes.c_int, ctypes.c_void_p],
    # payload, eff, ms, words, masks, lens, out, n, L, U, K, min_end, device, stream
    "msm_window_count_halo": [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p],
})
load_library = LIBRARY.load
BUILD_INFO = LIBRARY.build_info


def check_tile(payload, lengths, tables) -> None:
    """Validate a tile and its pattern tables ``(name, tensor, ndim)`` the
    way the kernels take them: raise on anything else."""
    dev = payload.device
    for name, t, dtype, ndim in (
        ("payload", payload, torch.uint8, 2),
        ("lengths", lengths, torch.int32, 1),
        *((name, t, torch.int32, ndim) for name, t, ndim in tables),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, payload on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lengths.shape[0] != payload.shape[0]:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, payload {payload.shape[0]}")


def check_totals_bound(payload, reps: int) -> None:
    """Totals are exact while ``reps * n * L < 2^31``: a position starts at
    most one match per pattern."""
    n, L = payload.shape
    if reps < 1 or reps > 65535:
        raise ValueError(f"reps must be in [1, 65535], got {reps}")
    if reps * n * L >= 2**31:
        raise ValueError(
            f"{reps} repeats of a tile of {n} x {L} positions overflow the int32 "
            "counters; split it into smaller tiles"
        )


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its card index: a bare ``cuda``
    is card 0, where the wrappers launch a tensor on it."""
    d = torch.device(device)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def device_kind(t: torch.Tensor, kernel: str = "window-count") -> str:
    """``"cpu"`` (plain version) or ``"cuda"`` (kernel); raise otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {kernel} kernel for device {t.device}")
    return t.device.type


def _check(payload, lengths, words, masks, lens) -> None:
    check_tile(payload, lengths, (("words", words, 2), ("masks", masks, 2), ("lens", lens, 1)))
    U = words.shape[0]
    if masks.shape != words.shape or lens.shape[0] != U:
        raise ValueError(
            f"table shapes disagree: words {tuple(words.shape)}, "
            f"masks {tuple(masks.shape)}, lens {tuple(lens.shape)}"
        )


def _launch(name: str, payload, lengths, words, masks, lens, out, reps: int = 1) -> None:
    n, L = payload.shape
    U, K = words.shape
    if n == 0 or L == 0 or U == 0:
        return  # nothing to count: the zeroed output is the answer
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    args = [payload.data_ptr(), lengths.data_ptr(), words.data_ptr(), masks.data_ptr(),
            lens.data_ptr(), out.data_ptr(), n, L, U, K]
    if name == "window_count_totals":
        args.append(reps)
    LIBRARY.call(f"msm_{name}", *args, payload.device.index or 0, stream)
    LAUNCHES[name if reps == 1 else f"{name}_repeated"] += 1


def window_count_totals(payload, lengths, words, masks, lens, reps: int = 1) -> torch.Tensor:
    """int32[U] totals in build order over one ``uint8[n, L]`` tile, times
    ``reps``: the kernel's repeats grid axis scans the tile ``reps`` times."""
    if device_kind(payload) == "cpu":
        return window_count(words, masks, lens, payload, lengths, per_packet=False) * reps
    _check(payload, lengths, words, masks, lens)
    check_totals_bound(payload, reps)
    out = torch.zeros(words.shape[0], dtype=torch.int32, device=payload.device)
    _launch("window_count_totals", payload, lengths, words, masks, lens, out, reps)
    return out


def window_count_rows(payload, lengths, words, masks, lens) -> torch.Tensor:
    """int32[n, U] per-row counts in build order over one tile."""
    if device_kind(payload) == "cpu":
        return window_count(words, masks, lens, payload, lengths, per_packet=True)
    _check(payload, lengths, words, masks, lens)
    out = torch.zeros(
        (payload.shape[0], words.shape[0]), dtype=torch.int32, device=payload.device
    )
    _launch("window_count_rows", payload, lengths, words, masks, lens, out)
    return out


def window_count_halo(x, eff, ms, words, masks, lens, min_end: int) -> torch.Tensor:
    """int32[U] build-order totals over one flow-round tile ``x`` uint8[R, W]
    of rows ``[halo | bytes]``: a match at i counts iff its word chain
    matches, ``i + m <= eff[r]``, ``i + m > min_end`` (the halo width) and
    ``i >= ms[r]``."""
    if device_kind(x) == "cpu":
        return window_count_halo_plain(x, eff, ms, min_end, (words, masks, lens))
    _check(x, eff, words, masks, lens)
    check_tile(x, eff, (("ms", ms, 1),))
    if ms.shape[0] != x.shape[0]:
        raise ValueError(f"ms has {ms.shape[0]} rows, x {x.shape[0]}")
    check_totals_bound(x, 1)
    if min_end < 0:
        raise ValueError(f"min_end must be >= 0, got {min_end}")
    out = torch.zeros(words.shape[0], dtype=torch.int32, device=x.device)
    R, W = x.shape
    U, K = words.shape
    if R == 0 or W == 0 or U == 0:
        return out  # nothing to count: the zeroed output is the answer
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LIBRARY.call("msm_window_count_halo", x.data_ptr(), eff.data_ptr(), ms.data_ptr(),
                 words.data_ptr(), masks.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 R, W, U, K, min_end, x.device.index or 0, stream)
    LAUNCHES["window_count_halo"] += 1
    return out


class TileCountSurface:
    """The tile-count surface shared by the window and the table matchers
    (the counterpart of the JAX package's ``TileCountSurface``).

    Subclasses set ``wp``, ``device``, ``num_unique`` and ``dup`` (the
    ``dup_map`` on the device) and implement ``_tile_totals(p, l, reps)``,
    int32[U] build-order totals times ``reps``, ``_tile_rows(p, l)``,
    int32[n, U] build-order per-row counts, and ``_copy_to(device)``, the
    same surface on another device.  ``expand_duplicates`` maps
    build order to pattern-file order through ``dup``.
    """

    def _tile(self, p, l) -> Tuple[torch.Tensor, torch.Tensor]:
        return (
            torch.as_tensor(p, dtype=torch.uint8, device=self.device).contiguous(),
            torch.as_tensor(l, dtype=torch.int32, device=self.device).contiguous(),
        )

    def count_tiles(self, tiles, *, expand_duplicates: bool = True) -> torch.Tensor:
        """int32 totals summed over ``(payloads, lengths)`` tiles."""
        total = torch.zeros(self.num_unique, dtype=torch.int32, device=self.device)
        for p, l in tiles:
            total += self._tile_totals(*self._tile(p, l), 1)
        return total[self.dup] if expand_duplicates else total

    def count_tiles_repeated(self, tiles, repeats: int) -> torch.Tensor:
        """``repeats`` times the build-order totals: one launch per tile (per
        class for the table matcher) whose grid scans the tile ``repeats``
        times, so every repeat really re-reads it."""
        total = torch.zeros(self.num_unique, dtype=torch.int32, device=self.device)
        for p, l in tiles:
            total += self._tile_totals(*self._tile(p, l), repeats)
        return total

    def count_tiles_per_row(self, tiles, *, expand_duplicates: bool = True) -> List[torch.Tensor]:
        """One int32[rows_i, U or P] matrix per tile."""
        outs = []
        for p, l in tiles:
            out = self._tile_rows(*self._tile(p, l))
            outs.append(out[:, self.dup] if expand_duplicates else out)
        return outs

    def count_tile_summary(self, payloads, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(totals int32[U] in build order, row_hits bool[n])`` for one tile,
        reduced on the device."""
        rows = self._tile_rows(*self._tile(payloads, lengths))
        return rows.sum(dim=0, dtype=torch.int32), rows.sum(dim=1) > 0

    def on_device(self, device) -> "TileCountSurface":
        """This surface with its tables on ``device`` (a mesh shard's): itself
        when they are there already, else a copy made once, kept, and made
        again once the program changes (``swap_tables``)."""
        device = canonical_device(device)
        if device == canonical_device(self.device):
            return self
        copies = getattr(self, "_copies", None)
        if copies is None:
            copies = self._copies = {}
        copy = copies.get(device)
        if copy is None or copy.wp is not self.wp:
            copy = copies[device] = self._copy_to(device)
        return copy


class CudaWindowMatcher(TileCountSurface):
    """Tile-count surface over the window kernels, for one pattern program
    on one device (the counterpart of ``PallasWindowMatcher``).

    Tables stay on the device and are passed to every launch, so a new
    pattern set needs new tables and no new build.
    """

    def __init__(self, wp: WindowProgram, device="cuda"):
        self.wp = wp
        self.device = torch.device(device)
        self.num_unique = int(wp.pat_words.shape[0])
        self.words, self.masks, self.lens = wp.tables(self.device)
        self.dup = torch.from_numpy(wp.dup_map).to(self.device, torch.long)

    def _tile_totals(self, p, l, reps: int) -> torch.Tensor:
        return window_count_totals(p, l, self.words, self.masks, self.lens, reps)

    def _tile_rows(self, p, l) -> torch.Tensor:
        return window_count_rows(p, l, self.words, self.masks, self.lens)

    def _copy_to(self, device) -> "CudaWindowMatcher":
        return CudaWindowMatcher(self.wp, device)

    # -- flow-halo rounds -------------------------------------------------

    @property
    def halo_width(self) -> int:
        return max(int(self.wp.max_len) - 1, 1)

    def count_tile_halo(self, x, eff_len, min_start) -> torch.Tensor:
        """Build-order int32[U] totals for one flow-round tile ``x = [halo |
        round bytes]`` (``halo_width`` halo columns), the carried-halo scan
        of ops/window.window_stream_chunk in one launch.

        ``eff_len[i]``: valid bytes of row i, halo included; bytes past it
        are not read as matches.  ``min_start[i]``: first column a match
        may start at (``H`` minus the row's real halo bytes)."""
        x, eff = self._tile(x, eff_len)
        ms = torch.as_tensor(min_start, dtype=torch.int32, device=self.device).contiguous()
        return window_count_halo(x, eff, ms, self.words, self.masks, self.lens,
                                 self.halo_width)
