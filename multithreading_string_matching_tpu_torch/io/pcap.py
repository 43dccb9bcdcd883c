"""Capture file reading: classic pcap and pcapng.

Counterpart of ``multithreading_string_matching_tpu/io/pcap.py``: the whole
capture becomes ONE flat ``uint8`` buffer plus per-packet
``(offset, caplen, origlen)`` arrays, walked by the native C++ ingest when it
is available and by the numpy walker below otherwise (bit-identical).

:func:`iter_pcap` streams a capture in bounded-memory batches (the flow
monitor's ingest) and :func:`slice_pcap` cuts packet ranges out of one.
pcapng captures (several sections and interfaces, EPB/SPB/PB blocks) read
through both, as libpcap's ``pcap_open_offline`` reads them, and so do
compressed captures (gzip/bzip2/xz, detected by content magic).

The writers re-emit selected packets verbatim as classic pcap:
:func:`write_pcap` in one go, :class:`PcapWriter` chunk by chunk (the
streamed dump), and :func:`concat_pcaps` merges rotated captures into one
corpus with packets numbered in input order.
"""

from __future__ import annotations

import mmap
import os
import stat
import struct
from dataclasses import dataclass
from typing import BinaryIO, Dict, Iterator, Optional, Union

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

# Records a native call of the mapped walk may return: bounds its index
# arrays when ``batch_packets`` exceeds the capture.
_MAPPED_STEP = 1 << 16

# Batches yielded by iter_pcap, by ingest path: "mapped" (a regular classic
# file walked in place through a read-only mapping) or "read" (every other
# source: read into a buffer, each batch copied out of it).
INGEST: Dict[str, int] = {"mapped": 0, "read": 0}

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


def _mappable_fd(f) -> Optional[int]:
    """The descriptor under ``f`` when :func:`open_capture` opened it by
    path, found no codec magic, and it is a regular file; else None."""
    if not isinstance(f, _PrefixReader) or not f._owns:
        return None
    fd = f._f.fileno()
    return fd if stat.S_ISREG(os.fstat(fd).st_mode) else None


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
            return "pcapng"
        raise ValueError(f"not a classic pcap file (magic {head[:4].hex()})")
    _, vmaj, vmin, _tz, _sig, snaplen, linktype = hdr
    if vmaj != 2:  # other 2.x minors share the record layout
        raise ValueError(f"unsupported pcap version {vmaj}.{vmin}")
    return swapped, nanos, snaplen, linktype


def read_pcap(path, *, strict: bool = True, use_native: bool = True) -> PcapFile:
    """Parse a classic pcap or pcapng file into a :class:`PcapFile`.

    ``strict=False`` tolerates a truncated final record or block (keeps the
    complete prefix).  ``use_native`` takes the C++ record walk when
    available.
    """
    with open_capture(path) as f:
        raw = _read_all(f, strict)
    parsed = _parse_global_header(raw[:24])
    if parsed == "pcapng":
        return _read_pcapng(raw, strict=strict, use_native=use_native)
    swapped, nanos, snaplen, linktype = parsed
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


_PCAPNG_BOM = 0x1A2B3C4D
# pcapng packet-block types the native walker handles (PB/SPB/EPB).
_PCAPNG_PACKET_BLOCKS = (2, 3, 6)
# if_tsresol divisors are Python ints (10**v can exceed int64 for exotic
# resolutions); the native walk only runs while every divisor fits.  Shared
# between the one-shot and streaming readers so the bound cannot drift.
_MAX_TSDIV = 1 << 62


def _extend_native_pcapng(
    accs, span, doffs, caps, origs, ss, ff
):
    """Append one native pcapng walk's packets to the batch accumulators
    ``accs = (chunks, offsets, caplens, origlens, tss, tsf)``.  ``span`` is
    the walked bytes TRIMMED to the last packet's data end — that keeps the
    shared Python block parser's buf-position derivation
    (``offsets[-1] + caplens[-1]``) exact for whatever block it parses
    next.  Offsets point at each packet's data inside the span (block
    headers stay in place)."""
    chunks, offsets, caplens, origlens, tss, tsf = accs
    base = (offsets[-1] + caplens[-1]) if offsets else 0
    chunks.append(span)
    offsets.extend((doffs + base).tolist())
    caplens.extend(caps.tolist())
    origlens.extend(origs.tolist())
    tss.extend(ss.tolist())
    tsf.extend(ff.tolist())


def _read_pcapng(
    raw: bytes, *, strict: bool = True, use_native: bool = True
) -> PcapFile:
    """Minimal pcapng reader: SHB / IDB / EPB / SPB / obsolete PB blocks.

    The reference gets pcapng support for free from libpcap
    (``pcap_open_offline`` autodetects the container); this provides the same
    capability.  Per-section endianness is honored; unknown block types are
    skipped by their length field.  Timestamps are normalized to
    microseconds (``if_tsresol`` applied); the linktype is taken from the
    first interface (the vectorized decoder only interprets Ethernet anyway —
    packets of other linktypes simply fail the validity predicate).
    """
    total = len(raw)
    pos = 0
    end = "<"  # per-section; set at each SHB
    interfaces = []            # (linktype, snaplen, tsresol_divisor_to_usec)
    first_meta = None          # (linktype, snaplen) of the first interface ever
    saw_interface = False
    offsets, caplens, origlens, tss, tsf = [], [], [], [], []
    chunks = []                # captured-bytes slices, concatenated at the end

    def u32(b, o):
        return struct.unpack_from(end + "I", b, o)[0]

    if use_native:
        from multithreading_string_matching_tpu_torch.io import native

        use_native = native.available()

    while pos + 12 <= total:
        # Peek the type: invoking the walker on a non-packet block would
        # pay the call + output-array allocation only to stop immediately.
        if (
            use_native
            and u32(raw, pos) in _PCAPNG_PACKET_BLOCKS
            and all(it[2] <= _MAX_TSDIV for it in interfaces)
        ):
            # Runs of packet blocks parse natively (same walker as the
            # streaming reader; block size unbounded — the one-shot reader
            # has no streaming bound — but the batch is capped so the
            # per-call output arrays stay ~40 MB even on multi-GB files).
            count, consumed, status, aux, doffs, caps, origs, ss, ff = (
                native.parse_pcapng(
                    raw, pos, end == ">", 1 << 20, 1 << 62,
                    [it[2] for it in interfaces],
                    interfaces[0][1] if interfaces else 0,
                )
            )
            if count:
                trim = int(doffs[-1] + caps[-1])
                _extend_native_pcapng(
                    (chunks, offsets, caplens, origlens, tss, tsf),
                    raw[pos : pos + trim], doffs, caps, origs, ss, ff,
                )
                pos += consumed
            if status == 1:  # batch cap reached: just keep walking
                continue
            if status == 0:  # next block incomplete
                if aux <= 12:
                    break  # sub-12-byte tail: the while guard's silent exit
                if strict:
                    raise ValueError(
                        f"truncated/invalid pcapng block at byte {pos}"
                    )
                break
            if status == 4:  # invalid block header (same message as below)
                if strict:
                    raise ValueError(
                        f"truncated/invalid pcapng block at byte {pos}"
                    )
                break
            if status == 5:  # malformed packet block
                if strict:
                    raise ValueError(
                        f"malformed pcapng block (type 0x{aux:08x}) "
                        f"at byte {pos}"
                    )
                break
            # status 2: a non-packet block — handled below, then the walk
            # resumes natively.  (status 3 impossible at max_block 2^62.)
        btype = u32(raw, pos)
        if btype == 0x0A0D0D0A:  # SHB: re-detect endianness from its BOM
            bom_le = struct.unpack_from("<I", raw, pos + 8)[0]
            if bom_le == _PCAPNG_BOM:
                end = "<"
            elif struct.unpack_from(">I", raw, pos + 8)[0] == _PCAPNG_BOM:
                end = ">"
            else:
                raise ValueError("pcapng SHB with invalid byte-order magic")
            # Interface IDs are SECTION-scoped: a new section's packet blocks
            # must not resolve against a previous section's IDBs (wrong
            # tsresol/linktype otherwise — e.g. mergecap -a output).
            if interfaces:
                saw_interface = True
                if first_meta is None:
                    first_meta = (interfaces[0][0], interfaces[0][1])
            interfaces.clear()
        blen = u32(raw, pos + 4)
        if blen < 12 or blen % 4 or pos + blen > total:
            if strict:
                raise ValueError(f"truncated/invalid pcapng block at byte {pos}")
            break
        body = raw[pos + 8 : pos + blen - 4]
        try:
            _parse_pcapng_block(
                btype, body, end, interfaces,
                offsets, caplens, origlens, tss, tsf, chunks, pos=pos,
            )
        except struct.error as e:
            if strict:
                raise ValueError(
                    f"malformed pcapng block (type 0x{btype:08x}) at byte {pos}"
                ) from e
            break
        pos += blen

    if strict and offsets and not (interfaces or saw_interface):
        raise ValueError("pcapng file has packet blocks but no interface block")
    if first_meta is None and interfaces:
        first_meta = (interfaces[0][0], interfaces[0][1])
    linktype, snaplen = first_meta if first_meta else (LINKTYPE_ETHERNET, 65535)
    blob = b"".join(chunks)
    return PcapFile(
        buf=np.frombuffer(blob, dtype=np.uint8).copy()
        if blob
        else np.zeros(0, dtype=np.uint8),
        offsets=np.asarray(offsets, dtype=np.int64),
        caplens=np.asarray(caplens, dtype=np.int64),
        origlens=np.asarray(origlens, dtype=np.int64),
        ts_sec=np.asarray(tss, dtype=np.int64),
        ts_frac=np.asarray(tsf, dtype=np.int64),
        linktype=linktype,
        snaplen=snaplen,
        nanos=False,
    )


def _parse_pcapng_block(
    btype, body, end, interfaces, offsets, caplens, origlens, tss, tsf, chunks,
    *, pos,
):
    """Dispatch one pcapng block body; raises struct.error / ValueError on
    malformed content (the caller maps struct.error per strictness)."""
    buf_pos = offsets[-1] + caplens[-1] if offsets else 0

    def u32(b, o):
        return struct.unpack_from(end + "I", b, o)[0]

    def ticks_to_usec(ts_hi, ts_lo, iface):
        # A packet block citing a not-yet-seen interface keeps the
        # microsecond default (the spec says IDBs come first, but writers
        # that emit a late IDB exist and the packets are still countable —
        # the EOF interface check + test_stream_pcapng_idb_after_epb pin
        # this leniency).  KNOWN TRADEOFF: if the late IDB declares a
        # non-microsecond if_tsresol, the early blocks' timestamps are
        # scaled with the default — byte counts are unaffected.
        div = interfaces[iface][2] if iface < len(interfaces) else 1_000_000
        ticks = (ts_hi << 32) | ts_lo
        sec = ticks // div
        if sec > 0x7FFF_FFFF_FFFF_FFFF:
            # Not representable as int64 seconds (corrupt/absurd capture):
            # struct.error so the caller's malformed-block mapping applies —
            # and so the native walk (which checks the same bound) and this
            # path fail identically instead of np.asarray raising a raw
            # OverflowError at batch-flush time.
            raise struct.error(f"pcapng timestamp overflows int64 at byte {pos}")
        return sec, ((ticks % div) * 1_000_000) // div

    if btype == 0x00000001:  # IDB
        linktype = struct.unpack_from(end + "H", body, 0)[0]
        snaplen = u32(body, 4)
        tsres_div = 1_000_000  # default 1e-6 ticks -> per-usec divisor 1
        o = 8
        while o + 4 <= len(body):  # options
            code, olen = struct.unpack_from(end + "HH", body, o)
            if code == 0:
                break
            if o + 4 + olen > len(body):
                # Truncated option value: struct.error so the caller's
                # strictness mapping applies (ValueError / stop-at-prefix)
                # instead of a raw IndexError escaping both modes.
                raise struct.error(
                    f"pcapng IDB option truncated at byte {pos}"
                )
            if code == 9 and olen >= 1:  # if_tsresol
                v = body[o + 4]
                tsres_div = 2 ** (v & 0x7F) if v & 0x80 else 10 ** v
            o += 4 + (-(-olen // 4) * 4)
        interfaces.append((linktype, snaplen, tsres_div))
    elif btype == 0x00000006:  # Enhanced Packet Block
        iface, ts_hi, ts_lo, incl, orig = struct.unpack_from(end + "IIIII", body, 0)
        data = body[20 : 20 + incl]
        if len(data) < incl:
            # struct.error: the caller maps it to ValueError (strict) / stop.
            raise struct.error(f"pcapng EPB shorter than caplen at byte {pos}")
        sec, frac = ticks_to_usec(ts_hi, ts_lo, iface)
        tss.append(sec)
        tsf.append(frac)
        offsets.append(buf_pos)
        caplens.append(incl)
        origlens.append(orig)
        chunks.append(data)
    elif btype == 0x00000003:  # Simple Packet Block
        orig = u32(body, 0)
        snap = interfaces[0][1] if interfaces else 0
        incl = min(orig, snap) if snap else orig
        # A writer that stored fewer bytes than min(orig, snaplen) is
        # indistinguishable from block padding here (SPB carries no caplen
        # field); clipping to the body bounds the damage to <=3 pad bytes.
        data = body[4 : 4 + incl]
        offsets.append(buf_pos)
        caplens.append(len(data))
        origlens.append(orig)
        tss.append(0)
        tsf.append(0)
        chunks.append(data)
    elif btype == 0x00000002:  # obsolete Packet Block (same ts encoding as EPB)
        iface, _drops, ts_hi, ts_lo, incl, orig = struct.unpack_from(
            end + "HHIIII", body, 0
        )
        data = body[20 : 20 + incl]
        if len(data) < incl:
            raise struct.error(f"pcapng PB shorter than caplen at byte {pos}")
        sec, frac = ticks_to_usec(ts_hi, ts_lo, iface)
        offsets.append(buf_pos)
        caplens.append(incl)
        origlens.append(orig)
        tss.append(sec)
        tsf.append(frac)
        chunks.append(data)
    # all other block types (SHB handled by the caller, NRB, ISB, custom,
    # ...) carry no packets and are skipped


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
    """Stream a classic or pcapng capture as :class:`PcapFile` batches of at most
    ``batch_packets`` packets.  Concatenated, the batches equal
    :func:`read_pcap`'s packets byte for byte.

    ``path`` is a path, ``"-"`` (stdin) or a binary file object (the
    ``tcpdump -w - | ... --stream`` shape).  ``strict=False`` keeps the
    complete prefix of a truncated capture.  ``use_native`` takes the C++
    streaming record walk, which keeps each batch's record headers in
    ``buf`` (offsets point past them).

    A classic capture that this function opens by path, uncompressed and a
    regular file, with the native walk available, is mapped read-only and
    walked in place (:func:`_iter_mapped`): each batch's ``buf`` is a
    read-only view of the mapping, no byte copied.  Every other source is
    read ``read_size`` bytes at a time and each batch copied out of the read
    buffer (peak residency one batch plus one read buffer); pcapng walks
    block by block (:func:`_iter_pcapng_stream`), runs of packet blocks in
    C++.  :data:`INGEST` counts the batches of each path.
    """
    if batch_packets < 1:
        raise ValueError("batch_packets must be >= 1")
    with open_capture(path) as f:
        # Header reads are always strict: a capture whose global header is
        # unreadable has no complete prefix to keep.
        head = _stream_read(f, 4, True)
        if head == b"\x0a\x0d\x0d\x0a":
            yield from _iter_pcapng_stream(f, head, batch_packets, strict, read_size,
                                           use_native)
            return
        head += _stream_read(f, 20, True)
        swapped, nanos, snaplen, linktype = _parse_global_header(head)
        if use_native:
            from multithreading_string_matching_tpu_torch.io import native

            use_native = native.available()
        fd = _mappable_fd(f) if use_native else None
        if fd is not None:
            yield from _iter_mapped(fd, swapped, batch_packets, strict,
                                    dict(linktype=linktype, snaplen=snaplen, nanos=nanos))
            return
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
            INGEST["read"] += 1
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
                        raise _too_big(need)
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
                    raise _too_big(incl)
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


def _too_big(size: int) -> ValueError:
    return ValueError(
        f"pcap record of {size} bytes exceeds the {_MAX_STREAM_RECORD}-byte "
        "streaming bound; use read_pcap for this capture"
    )


def _iter_mapped(
    fd: int, swapped: bool, batch_packets: int, strict: bool, meta: dict,
) -> Iterator[PcapFile]:
    """The classic walk of :func:`iter_pcap` over a read-only mapping of the
    regular file ``fd``: one native walk a batch (more only past
    ``_MAPPED_STEP`` records), each batch's ``buf`` a view of exactly the
    records it walked, headers included.  Batches, errors and tolerances
    are the read path's.

    The mapping covers the file's size at the first batch and is unmapped
    when the last view of it dies (the views hold it through their base).
    Before each walk the file's size is read again: a file cut below the
    mapped end raises ``ValueError`` when ``strict`` and otherwise ends at
    its last complete record, so the walk never reads past the file's end.
    A batch still held when its own pages are cut away faults on its next
    read, as any mapping of that file would."""
    from multithreading_string_matching_tpu_torch.io import native

    size = os.fstat(fd).st_size
    if size <= 24:  # a header-only capture
        if size < 24 and strict:
            raise ValueError(f"capture shrank to {size} bytes while being read")
        return
    data = np.frombuffer(mmap.mmap(fd, size, access=mmap.ACCESS_READ), dtype=np.uint8)
    pos = 24
    while True:
        limit = size
        now = os.fstat(fd).st_size
        if now < size:
            if strict:
                raise ValueError(
                    f"capture shrank from {size} to {now} bytes while being read")
            limit = max(pos, now)
        view = data[:limit]
        start, n, parts = pos, 0, []
        while True:
            count, consumed, status, need, o, c, g, s, fr = native.parse_stream(
                view, pos, swapped, min(batch_packets - n, _MAPPED_STEP), _MAX_STREAM_RECORD,
            )
            if count:
                parts.append((o + (pos - start), c, g, s, fr))
                n += count
                pos += consumed
            if status != 1 or n == batch_packets:
                break
        if n < batch_packets and strict:
            # The walk stopped short of a full batch: the capture ends here.
            rest = limit - pos
            if status == 2:
                raise _too_big(need)
            if need > 16:
                raise ValueError(
                    f"truncated pcap record: needs {need - 16} bytes, file has {rest - 16}")
            if rest:
                raise ValueError(f"{rest} trailing bytes after last pcap record")
        if n:
            cols = [p[0] if len(parts) == 1 else np.concatenate(p) for p in zip(*parts)]
            INGEST["mapped"] += 1
            yield PcapFile(data[start:pos], *cols, **meta)
        if n < batch_packets:
            return


def _iter_pcapng_stream(
    f, head: bytes, batch_packets: int, strict: bool, read_size: int,
    use_native: bool = True,
) -> Iterator[PcapFile]:
    """Block-at-a-time pcapng walk (blocks are self-delimiting); shares the
    per-block parser with :func:`_read_pcapng` so the two paths cannot
    diverge.  Interface state (endianness, linktype, tsresol) persists across
    yielded batches; the first interface's linktype labels every batch, as in
    the one-shot reader.

    With the native library available, RUNS of packet blocks (EPB/SPB/PB)
    parse through one C call per buffer fill (``msm_parse_pcapng``); any
    other block type returns control here so section/interface state stays
    in exactly one place.  Same leniencies, same error strings, same batch
    boundaries (differentially tested against the Python walk)."""
    if use_native:
        from multithreading_string_matching_tpu_torch.io import native

        use_native = native.available()
    pend = bytearray(head)
    pos = 0
    eof = False
    file_off = 0
    end = "<"
    interfaces: list = []
    first_meta = None          # (linktype, snaplen) of the first interface ever
    saw_interface = False
    offsets, caplens, origlens, tss, tsf, chunks = [], [], [], [], [], []

    seekable = _source_seekable(f)

    def refill(need: int) -> bool:
        nonlocal pos, eof
        while len(pend) - pos < need and not eof:
            if pos:
                del pend[:pos]
                pos = 0
            want = max(read_size, need)
            b = (
                _stream_read(f, want, strict)
                if seekable
                else _stream_read1(f, want, strict)
            )
            if not b:
                eof = True
            else:
                pend.extend(b)
        return len(pend) - pos >= need

    def flush() -> PcapFile:
        blob = b"".join(chunks)
        meta = first_meta or (
            (interfaces[0][0], interfaces[0][1])
            if interfaces
            else (LINKTYPE_ETHERNET, 65535)
        )
        out = PcapFile(
            buf=np.frombuffer(blob, dtype=np.uint8).copy()
            if blob
            else np.zeros(0, dtype=np.uint8),
            offsets=np.asarray(offsets, dtype=np.int64),
            caplens=np.asarray(caplens, dtype=np.int64),
            origlens=np.asarray(origlens, dtype=np.int64),
            ts_sec=np.asarray(tss, dtype=np.int64),
            ts_frac=np.asarray(tsf, dtype=np.int64),
            linktype=meta[0],
            snaplen=meta[1],
            nanos=False,
        )
        offsets.clear(); caplens.clear(); origlens.clear()
        tss.clear(); tsf.clear(); chunks.clear()
        INGEST["read"] += 1
        return out

    saw_packets = False
    while True:
        if not refill(12):
            # The one-shot reader's `while pos + 12 <= total` silently
            # ignores a sub-12-byte tail even in strict mode; match it.
            break
        if (
            use_native
            # Peek the type: a non-packet block would stop the walker
            # immediately — skip the call + output-array allocation.
            and struct.unpack_from(end + "I", pend, pos)[0]
            in _PCAPNG_PACKET_BLOCKS
            and all(it[2] <= _MAX_TSDIV for it in interfaces)
        ):
            remaining = batch_packets - len(offsets)
            count, consumed, status, aux, doffs, caps, origs, ss, ff = (
                native.parse_pcapng(
                    pend, pos, end == ">",
                    # When the flush gate below holds a late-IDB section's
                    # packets, remaining can hit 0 — keep walking unbounded
                    # like the Python loop does.
                    remaining if remaining > 0 else 1 << 60,
                    _MAX_STREAM_RECORD,
                    [it[2] for it in interfaces],
                    interfaces[0][1] if interfaces else 0,
                )
            )
            if count:
                trim = int(doffs[-1] + caps[-1])
                _extend_native_pcapng(
                    (chunks, offsets, caplens, origlens, tss, tsf),
                    # memoryview: one copy out of the mutable buffer, not a
                    # bytearray-slice copy followed by a bytes() copy.
                    bytes(memoryview(pend)[pos : pos + trim]),
                    doffs, caps, origs, ss, ff,
                )
                pos += consumed
                file_off += consumed
                saw_packets = True
            if len(offsets) >= batch_packets and (
                interfaces or first_meta is not None
            ):
                yield flush()
            if status == 1:  # batch full
                continue
            if status == 3:  # oversized block (same error as below)
                if strict:
                    raise ValueError(
                        f"pcapng block of {aux} bytes exceeds the "
                        f"{_MAX_STREAM_RECORD}-byte streaming bound; "
                        "use read_pcap for this capture"
                    )
                break
            if status == 4:  # invalid block header
                if strict:
                    raise ValueError(
                        f"truncated/invalid pcapng block at byte {file_off}"
                    )
                break
            if status == 5:  # malformed packet block
                if strict:
                    raise ValueError(
                        f"malformed pcapng block (type 0x{aux:08x}) "
                        f"at byte {file_off}"
                    )
                break
            if status == 0:  # next block straddles the buffer end
                if aux <= 12:
                    continue  # partial header: top-of-loop refill/EOF logic
                if not refill(aux):
                    if strict:
                        raise ValueError(
                            f"truncated/invalid pcapng block at byte "
                            f"{file_off}"
                        )
                    break
                continue
            # status 2: a non-packet block — the Python parser below owns
            # section (SHB) and interface (IDB) state; it handles this one
            # block, then the walk resumes natively.
        # The SHB type is an endianness palindrome, so reading it with the
        # previous section's byte order still detects a new section.
        btype = struct.unpack_from(end + "I", pend, pos)[0]
        if btype == 0x0A0D0D0A:
            bom_le = struct.unpack_from("<I", pend, pos + 8)[0]
            if bom_le == _PCAPNG_BOM:
                end = "<"
            elif struct.unpack_from(">I", pend, pos + 8)[0] == _PCAPNG_BOM:
                end = ">"
            else:
                raise ValueError("pcapng SHB with invalid byte-order magic")
            # Section-scoped interface IDs (see _read_pcapng).
            if interfaces:
                saw_interface = True
                if first_meta is None:
                    first_meta = (interfaces[0][0], interfaces[0][1])
            interfaces.clear()
        blen = struct.unpack_from(end + "I", pend, pos + 4)[0]
        if blen > _MAX_STREAM_RECORD:
            if strict:
                raise ValueError(
                    f"pcapng block of {blen} bytes exceeds the "
                    f"{_MAX_STREAM_RECORD}-byte streaming bound; "
                    "use read_pcap for this capture"
                )
            break
        if blen < 12 or blen % 4 or not refill(blen):
            if strict:
                raise ValueError(
                    f"truncated/invalid pcapng block at byte {file_off}"
                )
            break
        body = bytes(pend[pos + 8 : pos + blen - 4])
        try:
            _parse_pcapng_block(
                btype, body, end, interfaces,
                offsets, caplens, origlens, tss, tsf, chunks, pos=file_off,
            )
        except struct.error as e:
            if strict:
                raise ValueError(
                    f"malformed pcapng block (type 0x{btype:08x}) "
                    f"at byte {file_off}"
                ) from e
            break
        pos += blen
        file_off += blen
        saw_packets = saw_packets or bool(offsets)
        # Hold the batch until the section's linktype is KNOWN (its first
        # IDB) — flushing earlier would label pre-IDB packet blocks (the
        # nonstandard late-IDB leniency case) with the Ethernet fallback
        # while read_pcap labels the whole file with the late IDB's
        # linktype.  Standard captures (IDB first) flush on schedule; a
        # nonstandard section buffers its pre-IDB packets in memory, which
        # is exactly read_pcap's residency for the same file.
        if len(offsets) >= batch_packets and (
            interfaces or first_meta is not None
        ):
            yield flush()
    if offsets:
        yield flush()
    # Interface presence is checked at EOF, exactly like the one-shot
    # reader — an IDB may legally arrive after the first packet block.
    if strict and saw_packets and not (interfaces or saw_interface):
        raise ValueError("pcapng file has packet blocks but no interface block")


def read_pcap_range(path: Union[str, os.PathLike], start: int, stop: int) -> PcapFile:
    """Only packets ``[start, stop)`` of a capture: the per-host ingest of a
    sharded run (each host reads its own range).  A caller that already
    holds the parsed capture takes :func:`slice_pcap` instead."""
    return slice_pcap(read_pcap(path), start, stop)


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
