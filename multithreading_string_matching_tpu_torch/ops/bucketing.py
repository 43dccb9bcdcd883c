"""Length-bucketed and 0x00-packed staging plans.

Counterpart of ``multithreading_string_matching_tpu/ops/bucketing.py``.
Payload lengths are heavy-tailed, so rows are sorted by length into one
tile per quantized width class (padded bytes tight against real bytes), or
sequence-packed into fixed-width rows with a single 0x00 separator.  Both
are pure host arithmetic; the outputs equal the JAX package's exactly.
:func:`bucket_tiles` cuts the bucket tiles of the DFA engines' route.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def quantize_rows(n: int) -> int:
    """Row-count padding target: next power of two up to 1024, then the next
    multiple of 1024."""
    n = max(int(n), 8)
    if n <= 1024:
        return 1 << (n - 1).bit_length()
    return -(-n // 1024) * 1024


def bucket_plan(
    lengths: np.ndarray,
    n_tile: int = 2048,
    l_quant: int = 128,
    min_rows: Optional[int] = None,
) -> List[Tuple[np.ndarray, int]]:
    """Partition packets into ``(row_indices, tile_byte_len)`` tiles, one per
    quantized width class; sparse wide classes merge downward until a tile
    holds ``min_rows`` rows (default ``n_tile // 4``), and classes larger
    than ``n_tile`` rows are re-chunked.  Rows stay sorted by descending
    length."""
    lengths = np.asarray(lengths)
    if min_rows is None:
        min_rows = max(1, n_tile // 4)
    merge_budget = 128 * 1024  # extra padded bytes a merge may cost
    order = np.argsort(-lengths, kind="stable")  # widest first
    widths = np.maximum(lengths[order], 1)
    widths = (-(-widths // l_quant) * l_quant).astype(np.int64)
    bounds = [0, *(np.flatnonzero(np.diff(widths)) + 1), len(order)]
    plan: List[Tuple[np.ndarray, int]] = []
    start = 0
    for b in range(1, len(bounds) - 1):
        stop = bounds[b]
        rows_next = bounds[b + 1] - stop
        waste = rows_next * (int(widths[start]) - int(widths[stop]))
        if stop - start >= min_rows or waste > merge_budget:
            plan.append((order[start:stop], int(widths[start])))
            start = stop
    if start < len(order):
        plan.append((order[start:], int(widths[start])))
    bounded: List[Tuple[np.ndarray, int]] = []
    for idx, lt in plan:
        for s in range(0, len(idx), n_tile):
            bounded.append((idx[s : s + n_tile], lt))
    return bounded


def pack_rows(
    payloads: np.ndarray,
    lengths: np.ndarray,
    width: int = 2048,
    *,
    plan: Optional[Tuple[List[List[int]], List[int]]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sequence-pack payloads into fixed-width rows with one 0x00 separator
    byte between segments.

    Exact for NUL-free pattern sets only (a window crossing a separator
    contains 0x00); callers must refuse NUL-containing patterns.  Returns
    ``(packed uint8[R, width], fill int32[R])``; rows are zero past ``fill``.
    """
    payloads = np.asarray(payloads)
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.size:
        lmax = int(lengths.max())
        if lmax > width:
            raise ValueError(
                f"payload of {lmax} bytes exceeds pack width {width}"
            )
        if lmax > payloads.shape[1]:
            raise ValueError(
                f"length {lmax} exceeds payload tensor width {payloads.shape[1]}"
            )
    from multithreading_string_matching_tpu_torch.io import native

    if native.available():
        got = native.pack(payloads, lengths, width)
        if got is not None:
            return got
        return (
            np.zeros((1, width), dtype=np.uint8),
            np.zeros(1, dtype=np.int32),
        )
    rows, fills = plan if plan is not None else pack_plan(lengths, width)
    packed = np.zeros((max(len(rows), 1), width), dtype=np.uint8)
    for r, members in enumerate(rows):
        pos = 0
        for idx in members:
            ln = int(lengths[idx])
            if pos:
                pos += 1  # the separator byte is already 0
            packed[r, pos : pos + ln] = payloads[idx, :ln]
            pos += ln
    fill = np.asarray(fills if fills else [0], dtype=np.int32)
    return packed, fill


def pack_plan(
    lengths: np.ndarray, width: int
) -> Tuple[List[List[int]], List[int]]:
    """Row assignment for :func:`pack_rows` from lengths alone: each row
    starts with the largest remaining segment, then fills with the smallest
    ones that still fit.  Returns ``(rows, fills)``."""
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.size and int(lengths.max()) > width:
        raise ValueError(
            f"payload of {int(lengths.max())} bytes exceeds pack width {width}"
        )
    order = np.argsort(lengths, kind="stable")  # ascending
    order = order[lengths[order] > 0]
    rows: List[List[int]] = []
    fills: List[int] = []
    lo, hi = 0, len(order) - 1
    while lo <= hi:
        idx = order[hi]
        hi -= 1
        members = [int(idx)]
        fill = int(lengths[idx])
        while lo <= hi and fill + 1 + int(lengths[order[lo]]) <= width:
            members.append(int(order[lo]))
            fill += 1 + int(lengths[order[lo]])
            lo += 1
        rows.append(members)
        fills.append(fill)
    return rows, fills


def bucket_tiles(
    payloads: np.ndarray,
    lengths: np.ndarray,
    *,
    n_tile: int = 2048,
    l_quant: int = 128,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``(row indices, uint8 tile, int32 lengths)`` per bucket of the plan,
    as the JAX package's ``run_bucketed`` cuts them for the DFA engines:
    the payloads' own bytes cut to each bucket's width (no zero columns
    added: a length past the buffer scans to its end), rows padded to
    :func:`quantize_rows` with length 0."""
    payloads = np.asarray(payloads)
    lengths = np.asarray(lengths)
    out = []
    for idx, lt in bucket_plan(lengths, n_tile=n_tile, l_quant=l_quant):
        tile_p = payloads[idx, :lt]
        tile_l = lengths[idx]
        target = quantize_rows(tile_p.shape[0])  # padding rows have length 0
        if tile_p.shape[0] < target:
            pad = target - tile_p.shape[0]
            tile_p = np.pad(tile_p, ((0, pad), (0, 0)))
            tile_l = np.pad(tile_l, (0, pad))
        out.append((idx, tile_p, tile_l))
    return out
