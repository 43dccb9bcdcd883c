"""Hand-written Hopper kernels for large pattern sets, and their wrappers.

Counterpart of ``multithreading_string_matching_tpu/ops/pallas_table.py``'s
``PallasTableMatcher``.  The four CUDA kernels in ``csrc/table_count.cu``
replace the TPU's table and filter kernels, totals (``_class_call``, with
and without the repeats grid axis) and per row (``_one_tile_rows``); each
launch counts one word-count class (ops/table.py).  The library is built
with ``nvcc`` from the checkout on first use (ops/_build.py) and bound with
ctypes.  :class:`ShardTableKernel` launches the same kernels on one pattern
shard's table block: the TPU's ``ShardTableKernel.counts`` and ``.rows``.

The wrappers take the plain versions (ops/table.table_count and
filter_count) for tensors on the CPU and launch the kernel for tensors on a
CUDA device; on a CUDA tensor they launch or raise, never fall back.
``LAUNCHES`` counts kernel launches by name (a totals launch with
``reps > 1`` counts as ``<name>_repeated``, a :class:`ShardTableKernel`
launch as ``shard_<name>``).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.ops._build import CSRC_DIR, KernelLibrary
from multithreading_string_matching_tpu_torch.ops.cuda_window import (
    TileCountSurface,
    check_tile,
    check_totals_bound,
    device_kind,
)
from multithreading_string_matching_tpu_torch.ops.table import (
    filter_count,
    partition,
    table_count,
)
from multithreading_string_matching_tpu_torch.ops.window import WindowProgram

SOURCES = [CSRC_DIR / "table_count.cu"]

# Kernel launches by kernel name, for this process.  Incremented only where
# a wrapper launches its kernel.
LAUNCHES: Dict[str, int] = {
    "table_count_totals": 0, "table_count_rows": 0,
    "filter_count_totals": 0, "filter_count_rows": 0,
    "table_count_totals_repeated": 0, "filter_count_totals_repeated": 0,
    # ShardTableKernel's launches (pattern-sharded path), apart from the
    # class route's.
    "shard_table_count_totals": 0, "shard_table_count_rows": 0,
    "shard_filter_count_totals": 0, "shard_filter_count_rows": 0,
}

# payload, lengths, words, masks, lens, out, n, L, U, K, kw
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 3
_TOTALS = _ARGS + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # reps, device, stream
_ROWS = _ARGS + [ctypes.c_int, ctypes.c_void_p]                  # device, stream
LIBRARY = KernelLibrary("msm_table_count", SOURCES, {
    "msm_table_count_totals": _TOTALS, "msm_table_count_rows": _ROWS,
    "msm_filter_count_totals": _TOTALS, "msm_filter_count_rows": _ROWS,
})
load_library = LIBRARY.load
BUILD_INFO = LIBRARY.build_info


def _check(payload, lengths, words, masks, lens, K: int, filtered: bool) -> None:
    check_tile(payload, lengths, (("words", words, 2), ("masks", masks, 2), ("lens", lens, 1)))
    need = K + 1 if filtered else K
    if masks.shape != words.shape or lens.shape[0] != words.shape[0] or words.shape[1] < need:
        raise ValueError(
            f"class tables for K={K}{' with the filter column' if filtered else ''} "
            f"disagree: words {tuple(words.shape)}, masks {tuple(masks.shape)}, "
            f"lens {tuple(lens.shape)}"
        )
    if K < 1 or K > 512:
        raise ValueError(f"word count K={K} outside the kernels' 1..512")


def _launch(name: str, payload, lengths, words, masks, lens, out, K: int, reps: int = 1,
            counter: str = "") -> None:
    n, L = payload.shape
    U, kw = words.shape
    if n == 0 or L == 0 or U == 0:
        return  # nothing to count: the zeroed output is the answer
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    args = [payload.data_ptr(), lengths.data_ptr(), words.data_ptr(), masks.data_ptr(),
            lens.data_ptr(), out.data_ptr(), n, L, U, K, kw]
    if name.endswith("_totals"):
        args.append(reps)
    LIBRARY.call(f"msm_{name}", *args, payload.device.index or 0, stream)
    LAUNCHES[counter or (name if reps == 1 else f"{name}_repeated")] += 1


def _totals(name: str, plain, payload, lengths, words, masks, lens, K: int, reps: int,
            counter: str = ""):
    if device_kind(payload, name.replace("_", "-")) == "cpu":
        return plain(words, masks, lens, payload, lengths, K) * reps
    _check(payload, lengths, words, masks, lens, K, name == "filter_count")
    check_totals_bound(payload, reps)
    out = torch.zeros(words.shape[0], dtype=torch.int32, device=payload.device)
    _launch(f"{name}_totals", payload, lengths, words, masks, lens, out, K, reps, counter)
    return out


def _rows(name: str, plain, payload, lengths, words, masks, lens, K: int, counter: str = ""):
    if device_kind(payload, name.replace("_", "-")) == "cpu":
        return plain(words, masks, lens, payload, lengths, K, per_row=True)
    _check(payload, lengths, words, masks, lens, K, name == "filter_count")
    out = torch.zeros((payload.shape[0], words.shape[0]), dtype=torch.int32, device=payload.device)
    _launch(f"{name}_rows", payload, lengths, words, masks, lens, out, K, counter=counter)
    return out


def table_count_totals(payload, lengths, words, masks, lens, K: int, reps: int = 1) -> torch.Tensor:
    """int32[U] totals of one class (class order) over one tile, times ``reps``."""
    return _totals("table_count", table_count, payload, lengths, words, masks, lens, K, reps)


def table_count_rows(payload, lengths, words, masks, lens, K: int) -> torch.Tensor:
    """int32[n, U] per-row counts of one class over one tile."""
    return _rows("table_count", table_count, payload, lengths, words, masks, lens, K)


def filter_count_totals(payload, lengths, words, masks, lens, K: int, reps: int = 1) -> torch.Tensor:
    """int32[U] totals of one class whose tables carry the filter as column
    K, over one tile, times ``reps``."""
    return _totals("filter_count", filter_count, payload, lengths, words, masks, lens, K, reps)


def filter_count_rows(payload, lengths, words, masks, lens, K: int) -> torch.Tensor:
    """int32[n, U] per-row counts of one filtered class over one tile."""
    return _rows("filter_count", filter_count, payload, lengths, words, masks, lens, K)


class CudaTableMatcher(TileCountSurface):
    """Tile-count surface over the table kernels, for one pattern program on
    one device (the counterpart of ``PallasTableMatcher``).

    ``filtered`` selects the filter kernels.  Class tables stay on the
    device and are passed to every launch, so :meth:`swap_tables` uploads
    new tables and builds nothing.  Results are in build order.
    """

    def __init__(self, wp: WindowProgram, device="cuda", *, filtered: bool = False,
                 assume_zero_padded: bool = False):
        self.device = torch.device(device)
        self.filtered = filtered
        self._assume_zero_padded = assume_zero_padded
        self._totals_fn = filter_count_totals if filtered else table_count_totals
        self._rows_fn = filter_count_rows if filtered else table_count_rows
        self.classes, inv, self.use_fit = partition(wp, filtered, assume_zero_padded)
        self._stage(wp, inv)

    def _stage(self, wp: WindowProgram, inv: np.ndarray) -> None:
        self.wp = wp
        self.num_unique = int(wp.pat_words.shape[0])
        self._tables = [c.tables(self.device) for c in self.classes]
        self._inv = torch.from_numpy(inv).to(self.device)
        self.dup = torch.from_numpy(wp.dup_map).to(self.device, torch.long)

    def _tile_totals(self, p, l, reps: int) -> torch.Tensor:
        outs = [self._totals_fn(p, l, *tabs, c.K, reps)
                for c, tabs in zip(self.classes, self._tables)]
        return torch.cat(outs)[self._inv]

    def _tile_rows(self, p, l) -> torch.Tensor:
        outs = [self._rows_fn(p, l, *tabs, c.K) for c, tabs in zip(self.classes, self._tables)]
        return torch.cat(outs, dim=1)[:, self._inv]

    def swap_tables(self, wp: WindowProgram) -> None:
        """Replace the pattern set in place: new class tables, the same
        kernels.  Raises ``ValueError`` when the fit mode or the class
        geometry (each class's K and size) differs, as the JAX package does;
        callers then build a fresh matcher."""
        classes, inv, use_fit = partition(wp, self.filtered, self._assume_zero_padded)
        if use_fit != self.use_fit:
            raise ValueError("swap_tables: fit-mask mode differs (NUL patterns changed)")
        if [(c.K, c.num) for c in classes] != [(c.K, c.num) for c in self.classes]:
            raise ValueError("swap_tables: pattern-set geometry differs")
        self.classes = classes
        self._stage(wp, inv)

    def _copy_to(self, device) -> "CudaTableMatcher":
        return CudaTableMatcher(self.wp, device, filtered=self.filtered,
                                assume_zero_padded=self._assume_zero_padded)


class ShardTableKernel:
    """The table or filter kernels at one fixed geometry, for one pattern
    shard (parallel/pattern_shard.py): the counterpart of the JAX package's
    ``ShardTableKernel``.

    Each call takes one shard's ``[S, K(+1)]`` table block as data, at the
    whole set's ``K = K_max``: every pattern runs the full K-word chain, and
    the words past a pattern's end (word 0, mask 0) compare true.  Padded
    slots hold word 0, mask 0 and a length of ``2**30``, which no position
    fits; with ``filtered`` their filter column is the never-fires sentinel
    (word 1, mask 0).  Either way they count 0.

    On CUDA tensors a call launches one kernel of ``csrc/table_count.cu``
    and adds one to ``LAUNCHES["shard_<form>_count_<totals|rows>"]``, not to
    the class route's keys; on CPU tensors it takes the plain version.
    ``use_fit`` is the plan's and changes nothing: the kernels and the plain
    versions always apply the fit mask.
    """

    def __init__(self, K: int, S: int, use_fit: bool, filtered: bool, device="cuda"):
        if K < 1 or K > 512:
            raise ValueError(f"word count K={K} outside the kernels' 1..512")
        if S < 1:
            raise ValueError(f"shard size S={S} must be positive")
        self.K = K
        self.S = S
        self.use_fit = use_fit
        self.filtered = filtered
        self.device = torch.device(device)
        self._name = "filter_count" if filtered else "table_count"
        self._plain = filter_count if filtered else table_count

    def _block(self, words, masks, lens):
        kw = self.K + (1 if self.filtered else 0)
        if tuple(words.shape) != (self.S, kw) or tuple(masks.shape) != (self.S, kw):
            raise ValueError(
                f"shard block must be [{self.S}, {kw}]: words {tuple(words.shape)}, "
                f"masks {tuple(masks.shape)}"
            )
        if lens.numel() != self.S:
            raise ValueError(f"shard lens has {lens.numel()} entries for S={self.S}")
        return lens.reshape(self.S)

    def counts(self, words, masks, lens, payloads, lengths) -> torch.Tensor:
        """int32[S] totals of this shard's block over one tile, in slot order
        (there is no class permutation)."""
        lens = self._block(words, masks, lens)
        return _totals(self._name, self._plain, payloads, lengths, words, masks, lens, self.K, 1,
                       counter=f"shard_{self._name}_totals")

    def rows(self, words, masks, lens, payloads, lengths) -> torch.Tensor:
        """int32[n, S] per-row counts of this shard's block over one tile."""
        lens = self._block(words, masks, lens)
        return _rows(self._name, self._plain, payloads, lengths, words, masks, lens, self.K,
                     counter=f"shard_{self._name}_rows")
