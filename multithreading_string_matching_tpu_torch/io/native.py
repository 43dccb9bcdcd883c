"""ctypes bridge to the C++ ingest fast path.

Counterpart of ``multithreading_string_matching_tpu/io/native.py``.  It
compiles the SAME source, ``multithreading_string_matching_tpu/native/
pcap_ingest.cpp`` (read by path: importing the JAX package would import
jax), into this package's own ``build/libmsm_ingest.so``.  Every routine has
a bit-identical numpy implementation (io/pcap.py, io/decode.py,
ops/bucketing.py) that stays the spec.  ``MSM_NO_NATIVE=1`` disables the
native path; a missing compiler or source falls back to numpy silently.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from multithreading_string_matching_tpu_torch.ops._build import (
    BUILD_DIR,
    PKG_DIR,
    compile_to,
    is_stale,
)

_SRC = PKG_DIR.parent / "multithreading_string_matching_tpu" / "native" / "pcap_ingest.cpp"
_SO = BUILD_DIR / "libmsm_ingest.so"
_lock = threading.Lock()
_lib = None
_tried = False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MSM_NO_NATIVE"):
            return None
        try:
            if _SRC.exists() and is_stale(_SO, [_SRC]):
                compile_to(["g++", "-O3", "-shared", "-fPIC"], [_SRC], _SO)
            lib = ctypes.CDLL(str(_SO))
            _bind(lib)
        except (OSError, RuntimeError, AttributeError):
            return None
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the signature of every symbol this package calls."""
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.msm_parse_records.restype = ctypes.c_int64
    lib.msm_parse_records.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        i64p, i64p, i64p, i64p, i64p,
    ]
    lib.msm_parse_stream.restype = ctypes.c_int64
    lib.msm_parse_stream.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p, i64p, i64p, i64p,
    ]
    lib.msm_parse_pcapng.restype = ctypes.c_int64
    lib.msm_parse_pcapng.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        i64p, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p, i64p, i64p, i64p,
    ]
    lib.msm_decode.restype = None
    lib.msm_decode.argtypes = [
        u8p, ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, u8p, i64p, i64p,
    ]
    lib.msm_fill_padded.restype = None
    lib.msm_fill_padded.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64, u8p, ctypes.c_int64,
    ]
    lib.msm_scatter_segments.restype = None
    lib.msm_scatter_segments.argtypes = [
        u8p, i64p, i64p, i64p, i64p, ctypes.c_int64, u8p, ctypes.c_int64,
    ]
    lib.msm_pack_fill.restype = None
    lib.msm_pack_fill.argtypes = [
        u8p, ctypes.c_int64, i64p, i64p, i64p,
        ctypes.c_int64, ctypes.c_int64, u8p,
    ]
    lib.msm_pack_plan.restype = ctypes.c_int64
    lib.msm_pack_plan.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p,
    ]


def available() -> bool:
    return get_lib() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _need_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native ingest library is unavailable")
    return lib


def parse_records(buf: np.ndarray, swapped: bool, strict: bool):
    """Native record walk; returns (offsets, caplens, origlens, ts_sec,
    ts_frac) or raises ValueError on truncation in strict mode."""
    lib = _need_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    count = lib.msm_parse_records(
        _u8(buf), buf.size, int(swapped), int(strict), None, None, None, None, None
    )
    if count < 0:
        raise ValueError("truncated pcap record")
    arrs = [np.empty(count, dtype=np.int64) for _ in range(5)]
    lib.msm_parse_records(
        _u8(buf), buf.size, int(swapped), int(strict), *[_i64(a) for a in arrs]
    )
    return tuple(arrs)


def parse_stream(pend, pos: int, swapped: bool, batch_max: int, max_record: int):
    """Native streaming record walk over ``pend[pos:]``: parse every
    complete record, at most ``batch_max``.  Returns ``(count, consumed,
    status, need, offsets, caplens, origlens, ts_sec, ts_frac)``; offsets
    are packet-data starts relative to ``pos``, and status is 0 (needs
    ``need`` more bytes), 1 (batch full) or 2 (a record over
    ``max_record``).  ``pend`` is the streaming buffer, a bytearray whose
    export is released before returning (the caller may resize it again),
    or a 1-D uint8 array, read-only ones included (a mapped capture: the
    walk only reads)."""
    lib = _need_lib()
    avail = len(pend) - pos
    cap = max(1, min(int(batch_max), avail // 16 + 1))
    arrs = [np.empty(cap, dtype=np.int64) for _ in range(5)]
    state = np.zeros(3, dtype=np.int64)
    if isinstance(pend, bytearray):
        # The ctypes array decays to a pointer at the call; ctypes.cast would
        # keep the export alive and the caller's next resize of pend would raise.
        c_buf = (ctypes.c_uint8 * avail).from_buffer(pend, pos)
    else:
        if pend.dtype != np.uint8 or pend.ndim != 1 or not pend.flags.c_contiguous:
            raise ValueError("parse_stream: pend must be a contiguous 1-D uint8 array")
        c_buf = _u8(pend[pos:])
    try:
        count = lib.msm_parse_stream(
            c_buf, avail, int(swapped), cap, max_record,
            *[_i64(a) for a in arrs], _i64(state),
        )
    finally:
        del c_buf
    return (int(count), int(state[0]), int(state[1]), int(state[2]),
            *[a[:count] for a in arrs])


def parse_pcapng(pend, pos: int, swapped: bool, batch_max: int, max_block: int,
                 tsdivs, spb_snap: int):
    """Native pcapng packet-block walk over ``pend[pos:]``, the current
    section only: it stops at any block that is not an EPB, SPB or PB and
    leaves it to the Python parser.  ``pend`` is a bytearray (the streaming
    buffer) or bytes (the one-shot reader's file image; the walk only
    reads).  Returns ``(count, consumed, status, aux, data_off, caplens,
    origlens, ts_sec, ts_frac)`` as ``msm_parse_pcapng`` reports them."""
    lib = _need_lib()
    avail = len(pend) - pos
    # A valid packet block is at least 16 bytes; a 12-byte one stops the
    # walk as malformed before any output, so avail // 16 bounds the arrays.
    cap = max(1, min(int(batch_max), avail // 16 + 1))
    arrs = [np.empty(cap, dtype=np.int64) for _ in range(5)]
    state = np.zeros(3, dtype=np.int64)
    divs = np.ascontiguousarray(tsdivs, dtype=np.int64)
    if isinstance(pend, bytearray):
        c_buf = (ctypes.c_uint8 * avail).from_buffer(pend, pos)
    else:  # read-only source: a zero-copy numpy view carries the pointer
        c_buf = _u8(np.frombuffer(pend, dtype=np.uint8, offset=pos))
    try:
        count = lib.msm_parse_pcapng(
            c_buf, avail, int(swapped), cap, max_block,
            _i64(divs), divs.size, spb_snap,
            *[_i64(a) for a in arrs], _i64(state),
        )
    finally:
        del c_buf  # release the bytearray export (the caller resizes pend)
    return (int(count), int(state[0]), int(state[1]), int(state[2]),
            *[a[:count] for a in arrs])


def decode(buf, offsets, caplens, origlens, mode: str, strict: bool):
    """Native validity/geometry decode; mirrors io.decode.decode_headers."""
    lib = _need_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    caplens = np.ascontiguousarray(caplens, dtype=np.int64)
    origlens = np.ascontiguousarray(origlens, dtype=np.int64)
    n = offsets.size
    valid = np.empty(n, dtype=np.uint8)
    poff = np.empty(n, dtype=np.int64)
    plen = np.empty(n, dtype=np.int64)
    lib.msm_decode(
        _u8(buf), buf.size, _i64(offsets), _i64(caplens), _i64(origlens), n,
        0 if mode == "udp" else 1, int(strict), _u8(valid), _i64(poff), _i64(plen),
    )
    return valid.astype(bool), poff, plen


def _pack_plan(lengths: np.ndarray, width: int):
    """Run msm_pack_plan; returns (members, per_row, fills, n_rows) or None
    when there is nothing to pack."""
    lib = _need_lib()
    lmax = int(lengths.max()) if lengths.size else 0
    if lmax > width:
        # An oversized segment must raise, not overrun the row in memcpy.
        raise ValueError(f"payload of {lmax} bytes exceeds pack width {width}")
    order = np.argsort(lengths, kind="stable")
    order = np.ascontiguousarray(order[lengths[order] > 0], dtype=np.int64)
    n_ord = order.size
    if n_ord == 0:
        return None
    members = np.empty(n_ord, dtype=np.int64)
    per_row = np.empty(n_ord, dtype=np.int64)
    fills = np.empty(n_ord, dtype=np.int64)
    n_rows = lib.msm_pack_plan(
        _i64(lengths), _i64(order), n_ord, width,
        _i64(members), _i64(per_row), _i64(fills),
    )
    return members, per_row, fills, int(n_rows)


def plan_rows(lengths, width: int) -> int:
    """Row count the packing plan would produce, without copying bytes."""
    got = _pack_plan(np.ascontiguousarray(lengths, dtype=np.int64), width)
    return got[3] if got is not None else 0


def pack(payloads, lengths, width: int):
    """Native plan+materialize for ops/bucketing.pack_rows; returns
    (packed, fills) or None when no segment is non-empty."""
    lib = _need_lib()
    payloads = np.ascontiguousarray(payloads, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    got = _pack_plan(lengths, width)
    if got is None:
        return None
    members, per_row, fills, n_rows = got
    per_row = per_row[:n_rows]
    out = np.zeros((n_rows, width), dtype=np.uint8)
    lib.msm_pack_fill(
        _u8(payloads), payloads.shape[1] if payloads.ndim == 2 else 0,
        _i64(lengths), _i64(members), _i64(per_row),
        n_rows, width, _u8(out),
    )
    return out, fills[:n_rows].astype(np.int32)


def scatter_segments(buf, src, lens, rows, offs, out: np.ndarray) -> None:
    """Copy ``buf[src[s] : src[s] + lens[s]]`` into ``out[rows[s], offs[s]:]``
    for every segment s (the flow-reassembly fill).  ``out`` must be a
    C-contiguous uint8 matrix and the geometry in bounds (io/flows derives
    both from the decode that sized ``out``)."""
    lib = _need_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if out.dtype != np.uint8 or out.ndim != 2 or not out.flags.c_contiguous:
        # The write target cannot be copied defensively: a wrong dtype or
        # stride would make the C row arithmetic write out of bounds.
        raise ValueError("scatter_segments: out must be a C-contiguous uint8 matrix")
    lib.msm_scatter_segments(
        _u8(buf), _i64(np.ascontiguousarray(src, np.int64)),
        _i64(np.ascontiguousarray(lens, np.int64)),
        _i64(np.ascontiguousarray(rows, np.int64)),
        _i64(np.ascontiguousarray(offs, np.int64)),
        len(src), _u8(out), out.shape[1],
    )


def fill_padded(buf, starts, lens, lmax: int) -> np.ndarray:
    """Scatter byte slices into a zero-padded ``uint8[N, lmax]`` tensor."""
    lib = _need_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.zeros((starts.size, lmax), dtype=np.uint8)
    lib.msm_fill_padded(_u8(buf), _i64(starts), _i64(lens), starts.size, _u8(out), lmax)
    return out
