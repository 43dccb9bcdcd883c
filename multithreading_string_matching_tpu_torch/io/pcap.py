"""Classic-pcap file reading.

Counterpart of ``multithreading_string_matching_tpu/io/pcap.py``: the whole
capture becomes ONE flat ``uint8`` buffer plus per-packet
``(offset, caplen, origlen)`` arrays, walked by the native C++ ingest when it
is available and by the numpy walker below otherwise (bit-identical).

Only the classic container is ported so far; a pcapng file raises
``NotImplementedError``.  Compressed captures (gzip/bzip2/xz, detected by
content magic) decompress transparently.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO

import numpy as np

MAGIC_USEC_LE = 0xA1B2C3D4
MAGIC_USEC_BE = 0xD4C3B2A1
MAGIC_NSEC_LE = 0xA1B23C4D
MAGIC_NSEC_BE = 0x4D3CB2A1

LINKTYPE_ETHERNET = 1

_GLOBAL_HDR = struct.Struct("<IHHiIII")
_GLOBAL_HDR_BE = struct.Struct(">IHHiIII")


class _PrefixReader:
    """A binary reader that replays sniffed head bytes before the stream, so
    compression magic can be detected on non-seekable inputs (pipes)."""

    def __init__(self, head: bytes, f, owns: bool):
        self._head = head
        self._f = f
        self._owns = owns  # close-through only for files WE opened

    def read(self, n: int = -1) -> bytes:
        if self._head:
            if n is None or n < 0:
                out = self._head + self._f.read()
                self._head = b""
                return out
            out, self._head = self._head[:n], self._head[n:]
            if len(out) < n:
                out += self._f.read(n - len(out))
            return out
        return self._f.read(n)

    def read1(self, n: int = -1) -> bytes:
        """At most one underlying read — never blocks for a full buffer."""
        if self._head:
            out, self._head = (self._head, b"") if n is None or n < 0 else (
                self._head[:n], self._head[n:]
            )
            return out
        r1 = getattr(self._f, "read1", None)
        return r1(n) if r1 is not None else self._f.read(n)

    def readable(self) -> bool:  # io protocol, used by BZ2File/LZMAFile
        return True

    def close(self) -> None:
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _CodecClose:
    """Close a codec wrapper AND its underlying reader together (gzip, bz2
    and lzma never close a ``fileobj`` they were handed)."""

    def __init__(self, codec, under: _PrefixReader):
        self._codec = codec
        self._under = under

    def read(self, n: int = -1) -> bytes:
        return self._codec.read(n)

    def read1(self, n: int = -1) -> bytes:
        return self._codec.read1(n)

    def close(self) -> None:
        self._codec.close()
        self._under.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _codec_errors(f) -> tuple:
    """Exception types that mean "corrupt/truncated compressed data" — only
    when a codec wrapper is in the stack, so a genuine I/O error on a plain
    file propagates as the OSError it is."""
    if not isinstance(f, _CodecClose):
        return ()
    errs = [EOFError, OSError]
    try:
        import zlib

        errs.append(zlib.error)
    except ImportError:
        pass
    try:
        import lzma

        errs.append(lzma.LZMAError)
    except ImportError:
        pass
    return tuple(errs)


def _stream_read(f, n: int, strict: bool) -> bytes:
    """Read exactly ``n`` bytes (short only at end-of-stream).  A codec error
    raises ValueError when ``strict``, else ends the stream at the last good
    byte."""
    errors = _codec_errors(f)
    r1 = getattr(f, "read1", None) if (errors and not strict) else None
    parts = []
    got = 0
    while got < n:
        try:
            b = r1(n - got) if r1 is not None else f.read(n - got)
        except errors as e:
            if strict:
                raise ValueError(
                    f"truncated or corrupt compressed capture: {e}"
                ) from e
            break
        if not b:
            break
        parts.append(b)
        got += len(b)
    return parts[0] if len(parts) == 1 else b"".join(parts)


def _read_all(f, strict: bool, chunk: int = 4 << 20) -> bytes:
    """Read a whole capture stream, honoring the truncation contract."""
    if strict:
        try:
            return f.read()
        except _codec_errors(f) as e:
            raise ValueError(
                f"truncated or corrupt compressed capture: {e}"
            ) from e
    parts = []
    while True:
        b = _stream_read(f, chunk, False)
        if not b:
            return b"".join(parts)
        parts.append(b)


def open_capture(source) -> BinaryIO:
    """Open a capture for reading, transparently decompressing.

    ``source`` is a path, ``"-"`` (stdin) or an open binary file object.
    Detection is by content magic, never by file extension.
    """
    if isinstance(source, (str, os.PathLike)) and str(source) == "-":
        import sys

        source = sys.stdin.buffer
    owns = not hasattr(source, "read")
    f = open(source, "rb") if owns else source
    head = b""
    while len(head) < 6:  # a pipe may return short reads
        b = f.read(6 - len(head))
        if not b:
            break
        head += b
    pr = _PrefixReader(head, f, owns)
    if head[:2] == b"\x1f\x8b":
        import gzip

        return _CodecClose(gzip.GzipFile(fileobj=pr, mode="rb"), pr)
    if head[:3] == b"BZh":
        import bz2

        return _CodecClose(bz2.BZ2File(pr, "rb"), pr)
    if head[:6] == b"\xfd7zXZ\x00":
        import lzma

        return _CodecClose(lzma.LZMAFile(pr, "rb"), pr)
    return pr


@dataclass(frozen=True)
class PcapFile:
    """A fully ingested capture: one flat byte buffer + per-packet indices."""

    buf: np.ndarray        # uint8[total_bytes]
    offsets: np.ndarray    # int64[N] start of packet i's captured bytes in buf
    caplens: np.ndarray    # int64[N] captured length of packet i
    origlens: np.ndarray   # int64[N] original (on-the-wire) length
    ts_sec: np.ndarray     # int64[N]
    ts_frac: np.ndarray    # int64[N] microseconds or nanoseconds (see nanos)
    linktype: int
    snaplen: int
    nanos: bool

    @property
    def num_packets(self) -> int:
        return int(self.offsets.shape[0])

    def packet(self, i: int) -> np.ndarray:
        """Captured bytes of packet i (a view into the flat buffer)."""
        o = int(self.offsets[i])
        return self.buf[o : o + int(self.caplens[i])]


def _parse_global_header(head: bytes):
    if len(head) < 24:
        raise ValueError("pcap file shorter than its 24-byte global header")
    magic = struct.unpack("<I", head[:4])[0]
    if magic in (MAGIC_USEC_LE, MAGIC_NSEC_LE):
        hdr = _GLOBAL_HDR.unpack(head[:24])
        swapped, nanos = False, magic == MAGIC_NSEC_LE
    elif magic in (MAGIC_USEC_BE, MAGIC_NSEC_BE):
        hdr = _GLOBAL_HDR_BE.unpack(head[:24])
        swapped, nanos = True, magic == MAGIC_NSEC_BE
    else:
        if head[:4] == b"\x0a\x0d\x0d\x0a":
            raise NotImplementedError(
                "pcapng captures are not yet ported to the torch package "
                "(read them with multithreading_string_matching_tpu, or "
                "convert to classic pcap)"
            )
        raise ValueError(f"not a classic pcap file (magic {head[:4].hex()})")
    _, vmaj, vmin, _tz, _sig, snaplen, linktype = hdr
    if vmaj != 2:  # other 2.x minors share the record layout
        raise ValueError(f"unsupported pcap version {vmaj}.{vmin}")
    return swapped, nanos, snaplen, linktype


def read_pcap(path, *, strict: bool = True, use_native: bool = True) -> PcapFile:
    """Parse a classic pcap file into a :class:`PcapFile`.

    ``strict=False`` tolerates a truncated final record (keeps the complete
    prefix).  ``use_native`` takes the C++ record walk when available.
    """
    with open_capture(path) as f:
        raw = _read_all(f, strict)
    swapped, nanos, snaplen, linktype = _parse_global_header(raw[:24])
    data = np.frombuffer(raw, dtype=np.uint8)
    total = data.shape[0]

    if use_native:
        from multithreading_string_matching_tpu_torch.io import native

        if native.available():
            offs, caps, origs, tss, tsf = native.parse_records(data, swapped, strict)
            return PcapFile(
                buf=data, offsets=offs, caplens=caps, origlens=origs,
                ts_sec=tss, ts_frac=tsf,
                linktype=linktype, snaplen=snaplen, nanos=nanos,
            )

    rec = struct.Struct(">IIII" if swapped else "<IIII")
    offsets, caplens, origlens, tss, tsf = [], [], [], [], []
    pos = 24
    while pos + 16 <= total:
        sec, frac, incl, orig = rec.unpack_from(raw, pos)
        pos += 16
        if pos + incl > total:
            if strict:
                raise ValueError(
                    f"truncated pcap record at byte {pos - 16}: "
                    f"needs {incl} bytes, file has {total - pos}"
                )
            break
        offsets.append(pos)
        caplens.append(incl)
        origlens.append(orig)
        tss.append(sec)
        tsf.append(frac)
        pos += incl
    if strict and pos != total:
        raise ValueError(f"{total - pos} trailing bytes after last pcap record")

    return PcapFile(
        buf=data,
        offsets=np.asarray(offsets, dtype=np.int64),
        caplens=np.asarray(caplens, dtype=np.int64),
        origlens=np.asarray(origlens, dtype=np.int64),
        ts_sec=np.asarray(tss, dtype=np.int64),
        ts_frac=np.asarray(tsf, dtype=np.int64),
        linktype=linktype,
        snaplen=snaplen,
        nanos=nanos,
    )


def classic_global_header(
    linktype: int = LINKTYPE_ETHERNET, snaplen: int = 65535,
    nanos: bool = False,
) -> bytes:
    """The 24-byte classic-pcap global header."""
    magic = MAGIC_NSEC_LE if nanos else MAGIC_USEC_LE
    return struct.pack("<IHHiIII", magic, 2, 4, 0, 0, snaplen, linktype)
