"""Classic-pcap file reading.

Counterpart of ``multithreading_string_matching_tpu/io/pcap.py``: the whole
capture becomes ONE flat ``uint8`` buffer plus per-packet
``(offset, caplen, origlen)`` arrays, walked by the native C++ ingest when it
is available and by the numpy walker below otherwise (bit-identical).

:func:`iter_pcap` streams a capture in bounded-memory batches (the flow
monitor's ingest) and :func:`slice_pcap` cuts packet ranges out of one.
Only the classic container is ported so far; a pcapng file raises
``NotImplementedError``.  Compressed captures (gzip/bzip2/xz, detected by
content magic) decompress transparently.

The writers re-emit selected packets verbatim as classic pcap:
:func:`write_pcap` in one go, :class:`PcapWriter` chunk by chunk (the
streamed dump), and :func:`concat_pcaps` merges rotated captures into one
corpus with packets numbered in input order.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Union

import numpy as np

MAGIC_USEC_LE = 0xA1B2C3D4
MAGIC_USEC_BE = 0xD4C3B2A1
MAGIC_NSEC_LE = 0xA1B23C4D
MAGIC_NSEC_BE = 0x4D3CB2A1

LINKTYPE_ETHERNET = 1

# Streaming cap on one record: a corrupt length field must raise, not
# buffer gigabytes before the file turns out to end (read_pcap, holding the
# whole file, has no such cap).
_MAX_STREAM_RECORD = 1 << 28

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

    def seekable(self) -> bool:
        # Picks the streaming refill mode: full reads for files, whatever
        # has arrived for pipes.
        probe = getattr(self._f, "seekable", None)
        return bool(probe and probe())

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

    def seekable(self) -> bool:
        return self._under.seekable()  # the source's, not the codec's

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


def _stream_read1(f, n: int, strict: bool) -> bytes:
    """At most one underlying read: whatever has arrived, up to ``n`` (the
    refill for pipes, so a live feed flows through as it arrives).  Returns
    b"" only at end of stream or, when not ``strict``, at a codec error."""
    errors = _codec_errors(f)
    r1 = getattr(f, "read1", None)
    try:
        return r1(n) if r1 is not None else f.read(n)
    except errors as e:
        if strict:
            raise ValueError(f"truncated or corrupt compressed capture: {e}") from e
        return b""


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


def _source_seekable(f) -> bool:
    probe = getattr(f, "seekable", None)
    return bool(probe and probe())


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


def _serialize_records(pcap: PcapFile, idx: np.ndarray) -> np.ndarray:
    """The selected packets as classic-pcap record bytes: one output
    buffer, headers filled vectorized, each record's captured bytes copied
    as one slice."""
    if idx.size and (idx.min() < 0 or idx.max() >= pcap.num_packets):
        raise ValueError(
            f"packet index out of range (capture has {pcap.num_packets})"
        )
    secs = pcap.ts_sec[idx]
    fracs = pcap.ts_frac[idx]
    caps = pcap.caplens[idx]
    origs = pcap.origlens[idx]
    for name, arr in (("ts_sec", secs), ("ts_frac", fracs),
                      ("caplen", caps), ("origlen", origs)):
        if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
            raise ValueError(f"{name} not representable as a pcap u32 field")
    out_sizes = 16 + caps
    rec_starts = np.concatenate(([0], np.cumsum(out_sizes)[:-1]))
    out = np.zeros(int(out_sizes.sum()), dtype=np.uint8)
    hdr = np.empty((idx.size, 4), dtype="<u4")
    hdr[:, 0] = secs
    hdr[:, 1] = fracs
    hdr[:, 2] = caps
    hdr[:, 3] = origs
    hdr_bytes = hdr.view(np.uint8).reshape(idx.size, 16)
    for k in range(idx.size):
        rs = int(rec_starts[k])
        out[rs : rs + 16] = hdr_bytes[k]
        src = int(pcap.offsets[idx[k]])
        n = int(caps[k])
        out[rs + 16 : rs + 16 + n] = pcap.buf[src : src + n]
    return out


class PcapWriter:
    """Incremental classic-pcap writer (the streamed counterpart of
    :func:`write_pcap`).

    The global header is written from the first chunk's metadata, even
    when that chunk selects no packet, so the header follows the capture
    and not a guess; later chunks must agree on linktype and timestamp
    resolution (a classic pcap has one of each).  The constructor's
    ``linktype``/``snaplen``/``nanos`` are used only when the stream ends
    before any chunk arrives.  A ``.gz``/``.bz2``/``.xz`` suffix compresses
    the output; the readers accept the result.  A context manager.
    """

    def __init__(
        self, path: Union[str, os.PathLike], *,
        linktype: int = LINKTYPE_ETHERNET, snaplen: int = 65535,
        nanos: bool = False,
    ):
        suffix = str(path).lower()
        if suffix.endswith(".gz"):
            import gzip

            self._f = gzip.open(path, "wb")
        elif suffix.endswith(".bz2"):
            import bz2

            self._f = bz2.open(path, "wb")
        elif suffix.endswith(".xz"):
            import lzma

            self._f = lzma.open(path, "wb")
        else:
            self._f = open(path, "wb")
        self._meta = None  # (linktype, nanos)
        self._fallback = (linktype, snaplen, nanos)
        self.packets_written = 0

    def write(self, pcap: PcapFile, indices=None) -> int:
        """Append the packets ``indices`` (all by default; a boolean mask
        of one entry per packet is taken as a selection) of ``pcap``."""
        if indices is None:
            idx = np.arange(pcap.num_packets, dtype=np.int64)
        else:
            idx = np.asarray(indices).ravel()
            if idx.dtype == bool:
                if idx.size != pcap.num_packets:
                    raise ValueError(
                        f"boolean mask has {idx.size} entries for a "
                        f"{pcap.num_packets}-packet capture"
                    )
                idx = np.flatnonzero(idx)
            idx = idx.astype(np.int64)
        if self._meta is None:
            self._meta = (pcap.linktype, pcap.nanos)
            self._f.write(
                classic_global_header(pcap.linktype, pcap.snaplen, pcap.nanos)
            )
        elif self._meta != (pcap.linktype, pcap.nanos):
            raise ValueError(
                f"chunk metadata {(pcap.linktype, pcap.nanos)} does not match "
                f"the stream's (linktype, nanos)={self._meta}"
            )
        self._f.write(_serialize_records(pcap, idx).tobytes())
        self.packets_written += int(idx.size)
        return int(idx.size)

    def close(self) -> None:
        if not self._f.closed:
            if self._meta is None:
                # No chunk arrived: still a valid, empty capture.
                lt, sl, ns = self._fallback
                self._f.write(classic_global_header(lt, sl, ns))
            self._f.close()

    def __enter__(self) -> "PcapWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_pcap(path: Union[str, os.PathLike], pcap: PcapFile, indices=None) -> int:
    """Write the packets ``indices`` of a parsed capture (all by default)
    as a classic pcap: original record bytes, timestamps, snaplen and
    linktype; the resolution follows ``pcap.nanos``.  Returns the number
    of packets written."""
    with PcapWriter(path) as w:
        return w.write(pcap, indices)


def concat_pcaps(pcaps) -> PcapFile:
    """Parsed captures as one, packets in input order (rotated capture
    files scanned as one corpus, numbered globally).  Linktype and
    timestamp resolution must agree; snaplen becomes the maximum."""
    pcaps = list(pcaps)
    if not pcaps:
        raise ValueError("concat_pcaps needs at least one capture")
    if len(pcaps) == 1:
        return pcaps[0]
    meta = {(p.linktype, p.nanos) for p in pcaps}
    if len(meta) > 1:
        raise ValueError(
            f"captures disagree on (linktype, nanos): {sorted(meta)}"
        )
    bufs = [p.buf for p in pcaps]
    base = np.cumsum([0] + [b.shape[0] for b in bufs[:-1]])
    return PcapFile(
        buf=np.concatenate(bufs),
        offsets=np.concatenate([p.offsets + off for p, off in zip(pcaps, base)]),
        caplens=np.concatenate([p.caplens for p in pcaps]),
        origlens=np.concatenate([p.origlens for p in pcaps]),
        ts_sec=np.concatenate([p.ts_sec for p in pcaps]),
        ts_frac=np.concatenate([p.ts_frac for p in pcaps]),
        linktype=pcaps[0].linktype,
        snaplen=max(p.snaplen for p in pcaps),
        nanos=pcaps[0].nanos,
    )


def iter_pcap(
    path,
    batch_packets: int = 1024,
    *,
    strict: bool = True,
    read_size: int = 4 << 20,
    use_native: bool = True,
) -> Iterator[PcapFile]:
    """Stream a classic capture as :class:`PcapFile` batches of at most
    ``batch_packets`` packets, reading ``read_size`` bytes at a time: peak
    residency is one batch plus one read buffer.  Concatenated, the batches
    equal :func:`read_pcap`'s packets byte for byte.

    ``path`` is a path, ``"-"`` (stdin) or a binary file object (the
    ``tcpdump -w - | ... --stream`` shape).  ``strict=False`` keeps the
    complete prefix of a truncated capture.  ``use_native`` takes the C++
    streaming record walk, which keeps each batch's record headers in
    ``buf`` (offsets point past them) so a batch is one copy.  pcapng
    raises ``NotImplementedError`` (not yet ported).
    """
    if batch_packets < 1:
        raise ValueError("batch_packets must be >= 1")
    with open_capture(path) as f:
        # Header reads are always strict: a capture whose global header is
        # unreadable has no complete prefix to keep.
        head = _stream_read(f, 24, True)
        swapped, nanos, snaplen, linktype = _parse_global_header(head)
        rec = struct.Struct(">IIII" if swapped else "<IIII")

        pend = bytearray()
        pos = 0
        eof = False
        offsets, caplens, origlens, tss, tsf, chunks = [], [], [], [], [], []
        buf_pos = 0
        n_rec = 0

        def _cat(parts) -> np.ndarray:
            # Scalars from the Python walk, arrays from the native walk.
            if parts and isinstance(parts[0], np.ndarray):
                return parts[0] if len(parts) == 1 else np.concatenate(parts)
            return np.asarray(parts, dtype=np.int64)

        def flush() -> PcapFile:
            nonlocal buf_pos, n_rec
            if chunks and isinstance(chunks[0], np.ndarray):
                buf = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
            else:
                blob = b"".join(chunks)
                buf = (np.frombuffer(blob, dtype=np.uint8).copy() if blob
                       else np.zeros(0, dtype=np.uint8))
            out = PcapFile(
                buf=buf, offsets=_cat(offsets), caplens=_cat(caplens),
                origlens=_cat(origlens), ts_sec=_cat(tss), ts_frac=_cat(tsf),
                linktype=linktype, snaplen=snaplen, nanos=nanos,
            )
            for lst in (offsets, caplens, origlens, tss, tsf, chunks):
                lst.clear()
            buf_pos = 0
            n_rec = 0
            return out

        seekable = _source_seekable(f)

        def refill(need: int) -> bool:
            """Grow ``pend`` until ``need`` bytes lie past ``pos``: full
            reads from files, whatever has arrived from pipes."""
            nonlocal pos, eof
            while len(pend) - pos < need and not eof:
                if pos:
                    del pend[:pos]
                    pos = 0
                want = max(read_size, need)
                b = (_stream_read(f, want, strict) if seekable
                     else _stream_read1(f, want, strict))
                if not b:
                    eof = True
                else:
                    pend.extend(b)
            return len(pend) - pos >= need

        if use_native:
            from multithreading_string_matching_tpu_torch.io import native

            use_native = native.available()

        def too_big(size: int) -> ValueError:
            return ValueError(
                f"pcap record of {size} bytes exceeds the {_MAX_STREAM_RECORD}-byte "
                "streaming bound; use read_pcap for this capture"
            )

        while True:
            if not refill(16):
                avail = len(pend) - pos
                if avail and strict:
                    raise ValueError(f"{avail} trailing bytes after last pcap record")
                break
            if use_native:
                count, consumed, status, need, o, c, g, s, fr = native.parse_stream(
                    pend, pos, swapped, batch_packets - n_rec, _MAX_STREAM_RECORD,
                )
                if count:
                    # One span copy, record headers included: the offsets
                    # already point past each 16-byte header in the span.
                    chunks.append(np.frombuffer(pend, dtype=np.uint8, count=consumed,
                                                offset=pos).copy())
                    offsets.append(o + buf_pos)
                    caplens.append(c)
                    origlens.append(g)
                    tss.append(s)
                    tsf.append(fr)
                    buf_pos += consumed
                    n_rec += count
                    pos += consumed
                if status == 1:  # batch full
                    yield flush()
                    continue
                if status == 2:  # oversized record
                    if strict:
                        raise too_big(need)
                    break
                # status 0: the next record straddles the buffer's end.
                if need == 16:
                    continue  # a partial header: the refill/EOF logic above
                if not refill(need):
                    if strict:
                        raise ValueError(
                            f"truncated pcap record: needs {need - 16} bytes, "
                            f"file has {len(pend) - pos - 16}"
                        )
                    break
                continue
            sec, frac, incl, orig = rec.unpack_from(pend, pos)
            if incl > _MAX_STREAM_RECORD:
                if strict:
                    raise too_big(incl)
                break
            if not refill(16 + incl):
                if strict:
                    raise ValueError(
                        f"truncated pcap record: needs {incl} bytes, "
                        f"file has {len(pend) - pos - 16}"
                    )
                break
            pos += 16
            chunks.append(bytes(pend[pos : pos + incl]))
            pos += incl
            offsets.append(buf_pos)
            buf_pos += incl
            caplens.append(incl)
            origlens.append(orig)
            tss.append(sec)
            tsf.append(frac)
            n_rec += 1
            if n_rec >= batch_packets:
                yield flush()
        if n_rec:
            yield flush()


def slice_pcap(full: PcapFile, start: int, stop: int, *, copy: bool = True) -> PcapFile:
    """Packets ``[start, stop)`` of a parsed capture.  ``copy=True`` narrows
    the byte buffer to the range (the rest can be freed); ``copy=False``
    keeps a view of the whole buffer (cheap transient slices)."""
    start = max(0, start)
    stop = min(full.num_packets, stop)
    meta = dict(linktype=full.linktype, snaplen=full.snaplen, nanos=full.nanos)
    if start >= stop:
        empty = np.zeros(0, dtype=np.int64)
        return PcapFile(buf=np.zeros(0, dtype=np.uint8), offsets=empty, caplens=empty,
                        origlens=empty, ts_sec=empty, ts_frac=empty, **meta)
    cols = dict(caplens=full.caplens[start:stop], origlens=full.origlens[start:stop],
                ts_sec=full.ts_sec[start:stop], ts_frac=full.ts_frac[start:stop], **meta)
    if not copy:
        return PcapFile(buf=full.buf, offsets=full.offsets[start:stop], **cols)
    lo = int(full.offsets[start])
    hi = int(full.offsets[stop - 1] + full.caplens[stop - 1])
    return PcapFile(buf=full.buf[lo:hi].copy(), offsets=full.offsets[start:stop] - lo, **cols)
