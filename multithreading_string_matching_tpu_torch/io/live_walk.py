"""One native walk over a live feed's frame headers: the capture filter,
the payload decode and the gather, in one call.

``native/live_walk.cpp`` is this package's own source (the JAX package has
no counterpart); it is built with ``g++`` into the git-ignored
``build/libmsm_live_walk.so`` on first use.  :func:`walk` gives the rows
that :func:`io.decode.extract_payloads` (``keep_invalid=True``) masked by
:func:`io.decode.bpf_protocol_mask` gives, row for row, for an Ethernet
capture (or an unknown linktype, which decodes as Ethernet); those two stay
the spec and serve every other linktype.  ``MSM_NO_NATIVE=1``, a missing
compiler or a failed build leave the walk unavailable, as for
``io/native.py``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from multithreading_string_matching_tpu_torch.io.decode import (
    LINKTYPE_NULL,
    LINKTYPE_SLL,
    RAW_IP_LINKTYPES,
)
from multithreading_string_matching_tpu_torch.io.pcap import PcapFile
from multithreading_string_matching_tpu_torch.ops._build import (
    BUILD_DIR,
    PKG_DIR,
    compile_to,
    is_stale,
)

SRC = PKG_DIR / "native" / "live_walk.cpp"
SO = BUILD_DIR / "libmsm_live_walk.so"
_NOT_ETHERNET = (LINKTYPE_SLL, LINKTYPE_NULL, *RAW_IP_LINKTYPES)
_lock = threading.Lock()
_lib = None
_tried = False


def bind(lib: ctypes.CDLL) -> None:
    """Declare ``msm_live_walk``'s signature: raw addresses for the arrays,
    a pointer for the width it reports."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.msm_live_walk.restype = i64
    lib.msm_live_walk.argtypes = [
        vp, i64, vp, vp, vp, i64, ctypes.c_int, ctypes.c_int, vp, i64, vp, vp,
        ctypes.POINTER(i64),
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the walk's library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MSM_NO_NATIVE"):
            return None
        try:
            if is_stale(SO, [SRC]):
                compile_to(["g++", "-O3", "-shared", "-fPIC"], [SRC], SO)
            lib = ctypes.CDLL(str(SO))
            bind(lib)
        except (OSError, RuntimeError, AttributeError):
            return None
        _lib = lib
        return _lib


def applies(pcap: PcapFile) -> bool:
    """Whether :func:`walk` serves ``pcap``: an Ethernet (or unknown)
    linktype, and the library loaded."""
    return pcap.linktype not in _NOT_ETHERNET and get_lib() is not None


def walk(pcap: PcapFile, mode: str, bpf_filter: bool
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(payloads uint8[r, w], lengths int32[r], src_idx int64[r])`` of the
    frames of ``pcap`` that the capture filter passes (every frame without
    ``bpf_filter``), each row its payload clipped to the captured bytes and
    zero past its length, a zero-length row for a frame without a valid
    payload; ``w`` is the longest row's length, at least 1.  The arrays are
    fresh on every call.  Only where :func:`applies`."""
    if mode not in ("udp", "tcp"):
        raise ValueError(f"mode must be 'udp' or 'tcp', got {mode!r}")
    lib = get_lib()
    buf = np.ascontiguousarray(pcap.buf, dtype=np.uint8)
    offsets = np.ascontiguousarray(pcap.offsets, dtype=np.int64)
    caplens = np.ascontiguousarray(pcap.caplens, dtype=np.int64)
    origlens = np.ascontiguousarray(pcap.origlens, dtype=np.int64)
    n = offsets.shape[0]
    # A row never holds more than its frame's captured bytes.
    out = np.empty(n * max(int(caplens.max()) if n else 0, 1), dtype=np.uint8)
    lengths = np.empty(n, dtype=np.int32)
    idx = np.empty(n, dtype=np.int64)
    width = ctypes.c_int64()
    rows = lib.msm_live_walk(
        buf.ctypes.data, buf.size, offsets.ctypes.data, caplens.ctypes.data,
        origlens.ctypes.data, n, 0 if mode == "udp" else 1, int(bool(bpf_filter)),
        out.ctypes.data, out.size, lengths.ctypes.data, idx.ctypes.data, ctypes.byref(width),
    )
    if rows < 0:
        raise RuntimeError("msm_live_walk: the rows overran their buffer")
    w = width.value
    return out[: rows * w].reshape(rows, w), lengths[:rows], idx[:rows]
