"""The matrix-unit formulation of exact byte matching: a +-1 bit inner
product per (position, pattern), on the tensor cores.

Counterpart of ``bench/mxu_match.py`` (its ``_bit_tables``, the count
surface of its ``MxuMatcher`` and the kernel ``_make_kernel``), which the
JAX package uses to measure whether the matrix unit could beat the compare
kernels:

- each window of ``m_max`` payload bytes becomes ``C = 8 * m_max`` values of
  +-1, one per bit, with bytes past the tile's width read as 0;
- each pattern becomes a ``[C]`` row of +-1, with 0 past its length;
- ``score[pos, u] = <window bits, pattern bits>``, and a match is
  ``score == 8 * len(u)``.

:func:`mxu_count` launches the hand-written kernel of ``csrc/mxu_count.cu``
(int8 ``mma.sync`` on the tensor cores) for tensors on a CUDA device, and
the plain version :func:`mxu_count_plain` for tensors on the CPU; on a CUDA
tensor it launches or raises, never falls back.  ``LAUNCHES`` counts kernel
launches (``mxu_count_repeated`` for ``reps > 1``).

Like the Pallas call, the counts cover each tile's staged width and read no
row lengths: tiles must be zero past each row's length, and only NUL-free
pattern sets count exactly (:class:`MxuMatcher` refuses the others).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multithreading_string_matching_tpu_torch.io.patterns import MAX_PATTERN_LEN
from multithreading_string_matching_tpu_torch.ops._build import CSRC_DIR, KernelLibrary
from multithreading_string_matching_tpu_torch.ops.cuda_window import (
    canonical_device,
    check_totals_bound,
    device_kind,
)

U_BLOCK = 128
K_STEP = 32  # the kernel's depth per tensor-core instruction (mma m16n8k32)
MAX_C = -(-8 * MAX_PATTERN_LEN // K_STEP) * K_STEP

# The plain version's intermediates hold at most this many float32 values.
PLAIN_BUDGET = 1 << 25

SOURCES = [CSRC_DIR / "mxu_count.cu"]

# Kernel launches by kernel name, for this process.  Incremented only where
# the wrapper launches its kernel.
LAUNCHES: Dict[str, int] = {"mxu_count": 0, "mxu_count_repeated": 0}

LIBRARY = KernelLibrary("msm_mxu_count", SOURCES, {
    # payload, P, tgt, out, n, L, U_pad, C, reps, device, stream
    "msm_mxu_count": [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
})
load_library = LIBRARY.load
BUILD_INFO = LIBRARY.build_info


def bit_tables(patterns: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, int]:
    """``(P int8[U_pad, C], tgt int32[U_pad, 1], m_max)`` from raw bytes:
    +-1 per pattern bit (bit j of byte k at column ``8k + j``), 0 past the
    pattern's length; ``tgt = 8 * len``, and 1 for the padded slots (an
    all-zero row scores 0 everywhere)."""
    m_max = max(len(p) for p in patterns)
    U = len(patterns)
    U_pad = -(-U // U_BLOCK) * U_BLOCK
    P = np.zeros((U_pad, 8 * m_max), np.int8)
    tgt = np.ones((U_pad, 1), np.int32)
    for u, p in enumerate(patterns):
        bits = np.unpackbits(np.frombuffer(p, np.uint8), bitorder="little")
        P[u, : bits.size] = bits.astype(np.int8) * 2 - 1
        tgt[u, 0] = 8 * len(p)
    return P, tgt, m_max


def _planes(x: torch.Tensor, m_max: int) -> torch.Tensor:
    """float32[r, L, 8 * m_max]: the +-1 bits of the ``m_max`` bytes from
    every position of ``x`` uint8[r, L], bytes past the width read as 0."""
    r, L = x.shape
    win = F.pad(x.to(torch.int32), (0, m_max - 1)).unfold(1, m_max, 1)  # [r, L, m_max]
    shifts = torch.arange(8, dtype=torch.int32, device=x.device)
    bits = (win.unsqueeze(-1) >> shifts) & 1
    return (bits * 2 - 1).reshape(r, L, 8 * m_max).to(torch.float32)


def mxu_count_plain(P, tgt, m_max: int, payloads) -> torch.Tensor:
    """Plain version: int32[U_pad] totals over one ``uint8[n, L]`` tile.

    Builds the ``[rows, positions, C]`` +-1 bit planes as the Pallas body
    does, takes the score product in float32 (exact: every score is an
    integer of magnitude at most ``8 * m_max <= 792 < 2^24``) and counts
    ``scores == tgt`` per pattern, a chunk of rows at a time."""
    dev = payloads.device
    U_pad = P.shape[0]
    C = 8 * m_max
    out = torch.zeros(U_pad, dtype=torch.int32, device=dev)
    n, L = payloads.shape
    if n == 0 or L == 0:
        return out
    Pf = P[:, :C].to(device=dev, dtype=torch.float32)
    tf = tgt.reshape(-1).to(device=dev, dtype=torch.float32)
    step = max(1, PLAIN_BUDGET // (L * max(C, U_pad)))
    for r0 in range(0, n, step):
        scores = _planes(payloads[r0 : r0 + step], m_max) @ Pf.T  # [r, L, U_pad]
        out += (scores == tf).sum(dim=(0, 1), dtype=torch.int32)
    return out


def mxu_count(payloads, P, tgt, reps: int = 1) -> torch.Tensor:
    """int32[U_pad] totals over one ``uint8[n, L]`` tile, times ``reps``.

    ``P`` int8[U_pad, C] and ``tgt`` int32[U_pad(, 1)] as :func:`bit_tables`
    makes them, on the tile's device; ``C`` is padded with zero columns to
    the kernel's depth when it is not a multiple of 32 (:class:`MxuMatcher`
    keeps its tables padded, so its launches never pad)."""
    U_pad, C = P.shape
    if device_kind(payloads, "mxu-count") == "cpu":
        return mxu_count_plain(P, tgt, C // 8, payloads) * reps
    dev = payloads.device
    for name, t, dtype, ndim in (("payloads", payloads, torch.uint8, 2), ("P", P, torch.int8, 2)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, payloads on {dev}")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    tgt = tgt.reshape(-1)
    if tgt.device != dev or tgt.dtype != torch.int32 or tgt.numel() != U_pad:
        raise ValueError(f"tgt must be int32[{U_pad}] on {dev}, got {tgt.dtype} "
                         f"{tuple(tgt.shape)} on {tgt.device}")
    if U_pad == 0 or U_pad % U_BLOCK or C == 0 or C % 8 or C > MAX_C:
        raise ValueError(f"P must be [a multiple of {U_BLOCK}, 8 * m_max <= {MAX_C}], "
                         f"got {tuple(P.shape)}")
    check_totals_bound(payloads, reps)
    if C % K_STEP:
        P = F.pad(P, (0, K_STEP - C % K_STEP))
    out = torch.zeros(U_pad, dtype=torch.int32, device=dev)
    n, L = payloads.shape
    if n == 0 or L == 0:
        return out  # nothing to count: the zeroed output is the answer
    stream = torch.cuda.current_stream(dev).cuda_stream
    LIBRARY.call("msm_mxu_count", payloads.data_ptr(), P.data_ptr(), tgt.contiguous().data_ptr(),
                 out.data_ptr(), n, L, U_pad, P.shape[1], reps, dev.index or 0, stream)
    LAUNCHES["mxu_count" if reps == 1 else "mxu_count_repeated"] += 1
    return out


class MxuMatcher:
    """The count surface of ``bench/mxu_match.py``'s ``MxuMatcher`` over the
    tensor-core kernel: build-order int32 totals over the given patterns
    (no deduplication), summed over tiles.  Tiles must be zero-padded past
    each row's length; their lengths are not read.

    The TPU's ``tn`` (VMEM row tiling) and ``interpret`` switch are not
    carried over.  The tables stay on the device."""

    def __init__(self, patterns: Sequence[bytes], device="cuda"):
        pats = [bytes(p) for p in patterns]
        if not pats or any(len(p) == 0 for p in pats):
            raise ValueError("patterns must be non-empty")
        if any(0 in p for p in pats):
            raise ValueError("the bit-product matcher counts exactly only NUL-free pattern sets")
        if any(len(p) > MAX_PATTERN_LEN for p in pats):
            raise ValueError(f"patterns are at most {MAX_PATTERN_LEN} bytes")
        self.device = canonical_device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available; pass device='cpu' "
                               "to run the plain version")
        self.P, self.tgt, self.m_max = bit_tables(pats)
        self.num_unique = len(pats)
        # Zero columns up to the kernel's depth, once, so no launch pads.
        self._P = F.pad(torch.from_numpy(self.P), (0, -self.P.shape[1] % K_STEP)).to(self.device)
        self._tgt = torch.from_numpy(self.tgt.reshape(-1)).to(self.device)

    def _tiles_total(self, tiles, reps: int) -> torch.Tensor:
        total = torch.zeros(self._P.shape[0], dtype=torch.int32, device=self.device)
        for p, _ in tiles:
            p = torch.as_tensor(p, dtype=torch.uint8, device=self.device).contiguous()
            total += mxu_count(p, self._P, self._tgt, reps)
        return total[: self.num_unique]

    def count_tiles(self, tiles) -> torch.Tensor:
        """int32[num_unique] totals over ``(payloads, lengths)`` tiles."""
        return self._tiles_total(tiles, 1)

    def count_tiles_repeated(self, tiles, reps: int) -> torch.Tensor:
        """``reps`` times the totals: one launch per tile whose grid scans
        the tile ``reps`` times, so every repeat really re-reads it."""
        return self._tiles_total(tiles, reps)
