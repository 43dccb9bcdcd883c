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
(int8 warpgroup MMA, ``wgmma``, on the tensor cores) for tensors on a CUDA
device, and
the plain version :func:`mxu_count_plain` for tensors on the CPU; on a CUDA
tensor it launches or raises, never falls back.  ``LAUNCHES`` counts kernel
launches (``mxu_count_repeated`` for ``reps > 1``).

Like the Pallas call, the counts cover each tile's staged width and read no
row lengths: tiles must be zero past each row's length, and only NUL-free
pattern sets count exactly (:class:`MxuMatcher` refuses the others).

:func:`window_fragment` and :func:`pattern_smem_offset` write down the two
index maps the kernel rests on (its A operand, the payload windows, in
registers; its B operand, the patterns, in shared memory), so the CPU tests
can rebuild :func:`_planes` and :func:`bit_tables`' ``P`` from them.
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
K_STEP = 32  # the kernel's depth per tensor-core instruction (wgmma m64nNk32)
M_TILE = 64  # payload positions per wgmma (its M)
CORE_ROWS, CORE_BYTES = 8, 16  # a core matrix of the shared-memory layout
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
    # payload, P, tgt, out, n, L, U_pad, C, reps, u_live, device, stream
    "msm_mxu_count_live": [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    # u_live, C, int[3] out: wgmma width N, warpgroups a block, shared bytes
    "msm_mxu_shape": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
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


def window_fragment(warp: int, lane: int, reg: int, step: int) -> Tuple[int, int]:
    """``(byte, nibble)`` behind one A-fragment register of the kernel's
    wgmma: register ``reg`` (0-3) of ``lane`` of ``warp`` (0-3 in the
    warpgroup) at k-step ``step`` holds the four +-1 values of nibble
    ``nibble`` (0 low, 1 high) of byte ``byte`` counted from the M-tile's
    first position.

    It follows from wgmma's A layout for 8-bit types (that of ``mma.sync``
    m16n8k32 in each warp's 16 rows): register ``reg`` holds row
    ``16 warp + g + 8 (reg & 1)`` and columns ``32 step + 16 (reg >> 1) +
    4 t`` .. ``+ 3``, with ``g, t = lane // 4, lane % 4``; column ``c`` of
    that row is bit ``c % 8`` of byte ``row + c // 8``.  So the word is
    ``2 * byte + nibble`` of the kernel's expanded segment (two words a
    byte)."""
    g, t = lane >> 2, lane & 3
    row = 16 * warp + g + 8 * (reg & 1)
    return row + 4 * step + 2 * (reg >> 1) + (t >> 1), t & 1


def pattern_smem_offset(n: int, c: int, width: int) -> int:
    """Byte offset of pattern ``n`` (0 <= n < ``width``, the block's wgmma
    N), column ``c`` of its ``P`` row, in the kernel's shared copy: the
    canonical K-major layout without swizzle, core matrices of 8 patterns x
    16 bytes, the ``width / 8`` core matrices of one 16-byte column block
    side by side.  A k-step ``s`` reads from ``32 * s * width`` with the
    descriptor's leading byte offset ``16 * width`` (the next 16 bytes of
    K) and stride byte offset 128 (the next 8 patterns):
    :func:`pattern_descriptor_offset`."""
    kb, kc = divmod(c, CORE_BYTES)
    nb, nr = divmod(n, CORE_ROWS)
    return (kb * (width // CORE_ROWS) + nb) * CORE_ROWS * CORE_BYTES + nr * CORE_BYTES + kc


def pattern_descriptor_offset(n: int, k: int, step: int, width: int) -> int:
    """Where the tensor cores read B[k, n] of k-step ``step`` (0 <= k < 32)
    through the kernel's descriptor: start ``32 * step * width``, then
    ``(k // 16) * LBO + (n // 8) * SBO + (n % 8) * 16 + k % 16``, the
    canonical no-swizzle K-major layout ``((8, n), (16, 2)) : ((16, SBO),
    (1, LBO))`` in bytes."""
    lbo, sbo = CORE_BYTES * width, CORE_ROWS * CORE_BYTES
    return (K_STEP * step * width + (k // CORE_BYTES) * lbo + (n // CORE_ROWS) * sbo
            + (n % CORE_ROWS) * CORE_BYTES + k % CORE_BYTES)


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


def mxu_count(payloads, P, tgt, reps: int = 1, live: int = None, out=None) -> torch.Tensor:
    """int32[U_pad] totals over one ``uint8[n, L]`` tile, times ``reps``.

    ``P`` int8[U_pad, C] and ``tgt`` int32[U_pad(, 1)] as :func:`bit_tables`
    makes them, on the tile's device; ``C`` is padded with zero columns to
    the kernel's depth when it is not a multiple of 32 (:class:`MxuMatcher`
    keeps its tables padded, so its launches never pad).  ``live``, when
    given, says that only the first ``live`` slots hold patterns: the kernel
    skips the padded ones, whose totals are 0 either way.  ``out``, when
    given (int32[U_pad] on the tile's device), receives the totals added to
    what it holds, and is returned: one launch and nothing else per tile."""
    U_pad, C = P.shape
    if live is None:
        live = U_pad
    if not 0 < live <= U_pad:
        raise ValueError(f"live must be in 1..{U_pad}, got {live}")
    if device_kind(payloads, "mxu-count") == "cpu":
        got = mxu_count_plain(P, tgt, C // 8, payloads) * reps
        return got if out is None else out.add_(got)
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
    if out is None:
        out = torch.zeros(U_pad, dtype=torch.int32, device=dev)
    elif out.device != dev or out.dtype != torch.int32 or out.shape != (U_pad,):
        raise ValueError(f"out must be int32[{U_pad}] on {dev}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    n, L = payloads.shape
    if n == 0 or L == 0:
        return out  # nothing to count: the zeroed output is the answer
    stream = torch.cuda.current_stream(dev).cuda_stream
    LIBRARY.call("msm_mxu_count_live", payloads.data_ptr(), P.data_ptr(),
                 tgt.contiguous().data_ptr(), out.data_ptr(), n, L, U_pad, P.shape[1], reps, live,
                 dev.index or 0, stream)
    LAUNCHES["mxu_count" if reps == 1 else "mxu_count_repeated"] += 1
    return out


def tile_shape(live: int, C: int) -> Tuple[int, int, int]:
    """``(N, warpgroups, shared bytes)`` of the kernel's launch for ``live``
    patterns at depth ``C`` (a multiple of 32): the wgmma width N (the
    patterns split into ``ceil(live / N)`` blocks), the warpgroups of a
    block and its dynamic shared memory.  Asks the built library."""
    shape = (ctypes.c_int * 3)()
    LIBRARY.call("msm_mxu_shape", live, C, ctypes.addressof(shape))
    return shape[0], shape[1], shape[2]


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
            mxu_count(p, self._P, self._tgt, reps, live=self.num_unique, out=total)
        return total[: self.num_unique]

    def count_tiles(self, tiles) -> torch.Tensor:
        """int32[num_unique] totals over ``(payloads, lengths)`` tiles."""
        return self._tiles_total(tiles, 1)

    def count_tiles_repeated(self, tiles, reps: int) -> torch.Tensor:
        """``reps`` times the totals: one launch per tile whose grid scans
        the tile ``reps`` times, so every repeat really re-reads it."""
        return self._tiles_total(tiles, reps)
