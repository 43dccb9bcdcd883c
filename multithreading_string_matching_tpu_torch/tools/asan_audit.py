"""Memory-safety audit of the C++ ingest and the live walk, through the port's ctypes layer.

Counterpart of ``bench/asan_audit.py``::

    python -m multithreading_string_matching_tpu_torch.tools.asan_audit
        [--seed N] [--garbage-cases N] [--geometry-cases N] [--self-test]

The port compiles the JAX package's ``native/pcap_ingest.cpp`` (read by
path) but calls it through its own bindings, ``io/native.py``: its own
argtypes (``_bind``), ``msm_parse_stream`` over a ``bytearray`` (the read
path) and over a read-only mapping of the capture (the mapped path), its
own ``scatter_segments`` and ``fill_padded``.  This tool builds the source
with ``g++ -O1 -g -fsanitize=address,undefined -fno-sanitize-recover=all``
into the package's git-ignored ``build/``, re-executes itself with
AddressSanitizer preloaded (``LD_PRELOAD=$(g++ -print-file-name=libasan.so)``;
the Python binary is not instrumented), swaps the library into
``io.native`` (``_bind``, ``_lib``, ``_tried``) and drives it with

1. structured captures: 25 random classic (both byte orders, both
   magics, zero-length records, clipped tails) and 25 pcapng captures (several
   sections, late IDBs with ``if_tsresol``, EPB/SPB/PB, junk and malformed
   blocks, clipped tails), each walked natively and in Python by
   ``read_pcap`` and by ``iter_pcap`` at several batch and read sizes,
   strict and not, with identical packets and metadata required, and
   identical errors (the one-shot classic walk: an error in both, its
   native message being generic); ``iter_pcap`` natively twice, by path
   (a classic capture: the mapped walk) and through a file object (the
   read path);
   plus the two timestamp extremes of the pcapng walk;
2. raw garbage: ``--garbage-cases`` blobs (pure garbage behind a classic
   magic half the time, garbage behind a pcapng section header, bit-flipped
   valid classic and pcapng captures, either byte order) through
   ``read_pcap`` and ``iter_pcap`` (by path and through a file object) at
   random batch and read sizes, strict and not: ``ValueError`` and
   ``OverflowError`` are the only outcomes allowed besides a parse;
3. geometry: ``--geometry-cases`` random ``decode``, ``fill_padded``,
   ``pack`` and ``scatter_segments`` calls (offsets and lengths inside the
   buffer, as the parser guarantees; origlens that lie about the wire);
4. the live walk (``io/live_walk.py`` over the package's own
   ``native/live_walk.cpp``, built the same way into
   ``build/libmsm_live_walk_asan.so``): ``--geometry-cases`` rounds of
   random truncated and lying Ethernet frames (IPv4 with any IHL, IPv6 and
   its fragment header, ARP, VLAN, noise; caplens cut anywhere, origlens
   that lie), in both modes, behind the capture filter and not: over one
   shared buffer, held to the numpy walks row for row; frame by frame, each
   in a buffer of exactly its captured bytes, so a read past a caplen is a
   read past the buffer; and with offsets and caplens that point past the
   buffer, which the walk clips.

Any ASan or UBSan finding aborts the process: the run exits non-zero.  A
clean run ends with ``ASAN AUDIT CLEAN``.  ``--self-test`` makes one
deliberate out-of-bounds call through the raw ctypes entry
(``msm_fill_padded`` told to copy past a 4 KB buffer) and must die with
AddressSanitizer's report: a run whose self-test exits 0 had no sanitizer
loaded.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

from multithreading_string_matching_tpu_torch.io import live_walk, native
from multithreading_string_matching_tpu_torch.io.decode import bpf_protocol_mask, extract_payloads
from multithreading_string_matching_tpu_torch.io.pcap import INGEST, PcapFile
from multithreading_string_matching_tpu_torch.ops._build import BUILD_DIR, PKG_DIR, compile_to, is_stale

SO = BUILD_DIR / "libmsm_ingest_asan.so"
WALK_SO = BUILD_DIR / "libmsm_live_walk_asan.so"
CAPTURES = 25  # structured classic captures, and as many pcapng ones
CHILD = "MSM_ASAN_AUDIT_CHILD"
FLAGS = ["g++", "-O1", "-g", "-shared", "-fPIC", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all"]


def build() -> pathlib.Path:
    """The sanitized ingest and walk libraries, each rebuilt when its
    source is newer; returns the ingest's."""
    if is_stale(SO, [native._SRC]):
        compile_to(FLAGS, [native._SRC], SO)
    if is_stale(WALK_SO, [live_walk.SRC]):
        compile_to(FLAGS, [live_walk.SRC], WALK_SO)
    return SO


def reexec(argv) -> None:
    """Run this module again with ASan preloaded (it must be loaded before
    libc initialises); never returns."""
    libasan = subprocess.run(["g++", "-print-file-name=libasan.so"], check=True,
                             capture_output=True, text=True).stdout.strip()
    env = dict(os.environ)
    env["LD_PRELOAD"] = libasan
    env.setdefault("ASAN_OPTIONS", "detect_leaks=0:abort_on_error=1")
    env[CHILD] = "1"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(PKG_DIR.parent),
                                                      env.get("PYTHONPATH")]))
    os.execve(sys.executable, [sys.executable, "-m", __spec__.name, *argv], env)


def swap_in(path: pathlib.Path) -> ctypes.CDLL:
    """Load the sanitized libraries and make them the ones ``io.native``
    and ``io.live_walk`` call; returns the ingest's."""
    lib = ctypes.CDLL(str(path))
    native._bind(lib)
    native._lib = lib
    native._tried = True
    if not native.available():
        raise RuntimeError("io.native did not take the sanitized library")
    walk_lib = ctypes.CDLL(str(WALK_SO))
    live_walk.bind(walk_lib)
    live_walk._lib = walk_lib
    live_walk._tried = True
    return lib


# ---------------------------------------------------------------------------
# Captures
# ---------------------------------------------------------------------------


def pcapng_block(end: str, btype: int, body: bytes) -> bytes:
    pad = (-len(body)) % 4
    blen = 12 + len(body) + pad
    return struct.pack(end + "II", btype, blen) + body + b"\x00" * pad + struct.pack(end + "I", blen)


def structured_classic(rng, end: str) -> bytes:
    """A classic capture of up to 40 records of random sizes (zero-length
    ones included, origlen at or past caplen), either magic, sometimes with
    its tail clipped inside a record or a header."""
    magic = 0xA1B23C4D if rng.integers(2) else 0xA1B2C3D4
    out = bytearray(struct.pack(end + "IHHiIII", magic, 2, 4, 0, 0, 65535, 1))
    for _ in range(int(rng.integers(0, 40))):
        n = int(rng.choice([0, 1, 17, 60, 300, 1600]))
        out += struct.pack(end + "IIII", int(rng.integers(0, 2**31)), int(rng.integers(0, 10**6)),
                           n, n + int(rng.integers(0, 5)))
        out += rng.integers(0, 256, n).astype(np.uint8).tobytes()
    if rng.integers(2):
        out = out[: max(24, len(out) - int(rng.integers(1, 30)))]
    return bytes(out)


def structured_pcapng(rng, end: str) -> bytes:
    """A pcapng capture of 1-2 sections of random blocks: IDBs (some with
    an ``if_tsresol`` whose divisor is tiny or past 1.8e13), EPBs (some
    with a huge ``ts_hi``), SPBs, obsolete PBs, junk blocks, EPBs whose
    caplen runs past the body; sometimes its tail clipped."""
    out = bytearray()
    for _ in range(int(rng.integers(1, 3))):
        out += pcapng_block(end, 0x0A0D0D0A, struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1))
        for _ in range(int(rng.integers(0, 14))):
            kind = int(rng.integers(0, 6))
            if kind == 0:
                body = struct.pack(end + "HHI", int(rng.choice([1, 101, 113])), 0,
                                   int(rng.choice([0, 64, 65535])))
                if rng.integers(2):
                    body += struct.pack(end + "HH", 9, 1) + bytes(
                        [int(rng.choice([0, 3, 6, 9, 14, 16]))]) + b"\x00\x00\x00"
                    body += struct.pack(end + "HH", 0, 0)
                out += pcapng_block(end, 0x00000001, body)
            elif kind == 1:
                data = rng.integers(0, 256, int(rng.integers(0, 90))).astype(np.uint8).tobytes()
                out += pcapng_block(end, 0x00000006, struct.pack(
                    end + "IIIII", int(rng.integers(0, 3)),
                    int(rng.choice([0, 1000, 2**31, 2**32 - 1])), int(rng.integers(0, 2**32)),
                    len(data), len(data) + int(rng.integers(0, 9))) + data)
            elif kind == 2:
                data = rng.integers(0, 256, int(rng.integers(0, 70))).astype(np.uint8).tobytes()
                out += pcapng_block(end, 0x00000003, struct.pack(end + "I", len(data)) + data)
            elif kind == 3:
                data = rng.integers(0, 256, int(rng.integers(0, 50))).astype(np.uint8).tobytes()
                out += pcapng_block(end, 0x00000002, struct.pack(
                    end + "HHIIII", 0, 0, 0, int(rng.integers(0, 10**6)), len(data),
                    len(data)) + data)
            elif kind == 4:
                out += pcapng_block(end, 0x0BADBEEF, b"\x07" * 12)
            else:
                out += pcapng_block(end, 0x00000006, struct.pack(
                    end + "IIIII", 0, 0, 0, 4000, 4000) + b"x" * 8)
    if rng.integers(2):
        out = out[: max(4, len(out) - int(rng.integers(1, 40)))]
    return bytes(out)


def valid_classic(rng, end: str) -> bytearray:
    out = bytearray(struct.pack(end + "IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))
    for _ in range(30):
        n = int(rng.integers(0, 200))
        out += struct.pack(end + "IIII", 1, 2, n, n)
        out += rng.integers(0, 256, n).astype(np.uint8).tobytes()
    return out


def valid_pcapng(rng, end: str) -> bytearray:
    out = bytearray(pcapng_block(end, 0x0A0D0D0A, struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1)))
    out += pcapng_block(end, 0x00000001, struct.pack(end + "HHI", 1, 0, 65535))
    for _ in range(30):
        n = int(rng.integers(0, 150))
        d = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        out += pcapng_block(end, 0x00000006, struct.pack(end + "IIIII", 0, 0, 0, n, n) + d)
    return out


def garbage(rng, trial: int) -> bytes:
    """Blob ``trial`` of the raw-garbage part: kinds in turn, a random byte
    order each."""
    kind, end = trial % 4, ("<" if rng.integers(2) else ">")
    if kind == 0:
        blob = rng.integers(0, 256, int(rng.integers(0, 400))).astype(np.uint8).tobytes()
        if rng.integers(2):
            blob = struct.pack(end + "IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1) + blob
        return blob
    if kind == 1:
        blob = rng.integers(0, 256, int(rng.integers(0, 400))).astype(np.uint8).tobytes()
        return pcapng_block("<", 0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1)) + blob
    b = valid_classic(rng, end) if kind == 2 else valid_pcapng(rng, end)
    for _ in range(int(rng.integers(1, 20))):
        b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
    return bytes(b)


# ---------------------------------------------------------------------------
# The three parts
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return "err", str(e)


def _same_batches(tag: str, a, b) -> None:
    """Raise unless two lists of parsed batches hold the same packets and
    metadata."""
    if len(a) != len(b):
        raise AssertionError(f"{tag}: {len(a)} batches natively, {len(b)} in Python")
    for x, y in zip(a, b):
        if x.num_packets != y.num_packets or x.linktype != y.linktype:
            raise AssertionError(f"{tag}: batch shape or linktype differs")
        for j in range(x.num_packets):
            if bytes(x.packet(j)) != bytes(y.packet(j)):
                raise AssertionError(f"{tag}: packet {j} differs")
        for f in ("caplens", "origlens", "ts_sec", "ts_frac"):
            if not np.array_equal(getattr(x, f), getattr(y, f)):
                raise AssertionError(f"{tag}: {f} differs")


def _iter_file(path: pathlib.Path, *args, **kw) -> list:
    """``iter_pcap``'s batches from ``path`` handed over as a file object:
    the read path, which a path to a classic capture does not take."""
    from multithreading_string_matching_tpu_torch.io.pcap import iter_pcap

    with open(path, "rb") as f:
        return list(iter_pcap(f, *args, **kw))


def walk_differential(rng, tmp: pathlib.Path, captures: int) -> int:
    """Native against Python walks on ``captures`` classic and as many
    pcapng captures (``iter_pcap`` native by path and through a file
    object); returns the walks compared."""
    from multithreading_string_matching_tpu_torch.io.pcap import iter_pcap, read_pcap

    walks = 0
    for trial in range(2 * captures):
        end = ">" if rng.integers(2) else "<"
        ng = trial % 2 == 1
        raw = structured_pcapng(rng, end) if ng else structured_classic(rng, end)
        path = tmp / f"walk_{trial}{'.pcapng' if ng else '.pcap'}"
        path.write_bytes(raw)
        for strict in (True, False):
            (nk, nv), (pk, pv) = (_outcome(lambda un=un: [read_pcap(path, strict=strict,
                                                                   use_native=un)])
                                  for un in (True, False))
            tag = f"capture {trial} ({'pcapng' if ng else 'classic'}{end}) read_pcap strict={strict}"
            # The one-shot classic walk's native error is one generic message
            # (as in the JAX package): there only the outcome must agree.
            if nk != pk or (nk == "err" and ng and nv != pv):
                raise AssertionError(f"{tag}: native {nk} {nv if nk == 'err' else ''}, "
                                     f"Python {pk} {pv if pk == 'err' else ''}")
            if nk == "ok":
                _same_batches(tag, nv, pv)
            walks += 1
            for bp in (1, 7, 1000):
                for rs in (64, 4 << 20):
                    kw = dict(read_size=rs, strict=strict)
                    (nk, nv), (fk, fv), (pk, pv) = (_outcome(run) for run in (
                        lambda: list(iter_pcap(path, bp, **kw)),
                        lambda: _iter_file(path, bp, **kw),
                        lambda: list(iter_pcap(path, bp, use_native=False, **kw))))
                    tag = (f"capture {trial} ({'pcapng' if ng else 'classic'}{end}) iter_pcap "
                           f"batch={bp} read={rs} strict={strict}")
                    if not nk == fk == pk or (nk == "err" and not nv == fv == pv):
                        raise AssertionError(f"{tag}: native by path {nk}, native through a "
                                             f"file object {fk}, Python {pk}")
                    if nk == "ok":
                        _same_batches(tag, nv, pv)
                        _same_batches(tag, fv, pv)
                    walks += 1
    return walks


def timestamp_extremes() -> None:
    """The pcapng walk's two timestamp edges, natively and in Python: a
    divisor past ~1.8e13 (a 128-bit multiply), and seconds past int64 with a
    tiny divisor (``malformed pcapng block`` in both walks, an empty
    prefix when tolerant)."""
    from multithreading_string_matching_tpu_torch.io.pcap import _read_pcapng

    def ng(tsresol, ts_hi, ts_lo):
        idb = struct.pack("<HHI", 1, 0, 65535) + struct.pack("<HH", 9, 1) + bytes([tsresol])
        idb += b"\x00\x00\x00" + struct.pack("<HH", 0, 0)
        return (pcapng_block("<", 0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
                + pcapng_block("<", 0x00000001, idb)
                + pcapng_block("<", 0x00000006,
                               struct.pack("<IIIII", 0, ts_hi, ts_lo, 4, 4) + b"data"))

    ticks, div = 123_456_789_012_345_678, 10**14
    raw = ng(14, ticks >> 32, ticks & 0xFFFFFFFF)
    for un in (True, False):
        got = _read_pcapng(raw, use_native=un)
        if (int(got.ts_sec[0]), int(got.ts_frac[0])) != (ticks // div,
                                                         ((ticks % div) * 1_000_000) // div):
            raise AssertionError(f"tsresol 14 (native={un}): {got.ts_sec[0]} {got.ts_frac[0]}")
    raw = ng(0, 2**32 - 1, 2**32 - 5)
    errs = [_outcome(lambda un=un: _read_pcapng(raw, use_native=un)) for un in (True, False)]
    if errs[0] != errs[1] or errs[0][0] != "err" or "malformed pcapng block" not in errs[0][1]:
        raise AssertionError(f"seconds past int64: {errs}")
    for un in (True, False):
        if _read_pcapng(raw, strict=False, use_native=un).num_packets != 0:
            raise AssertionError("seconds past int64, tolerant: packets kept")


def garbage_fuzz(rng, tmp: pathlib.Path, cases: int) -> int:
    """``cases`` garbage blobs through both readers, strict and not."""
    from multithreading_string_matching_tpu_torch.io.pcap import iter_pcap, read_pcap

    path = tmp / "garbage.bin"
    for trial in range(cases):
        path.write_bytes(garbage(rng, trial))
        for strict in (False, True):
            try:
                read_pcap(path, strict=strict)
            except (ValueError, OverflowError):
                pass
            kw = dict(batch_packets=int(rng.choice([1, 7, 1000])),
                      read_size=int(rng.choice([32, 4096])), strict=strict)
            for run in (lambda: list(iter_pcap(path, **kw)), lambda: _iter_file(path, **kw)):
                try:
                    run()
                except (ValueError, OverflowError):
                    pass
    return cases


def geometry_fuzz(rng, cases: int) -> int:
    """``cases`` rounds of random decode / fill_padded / pack /
    scatter_segments geometry inside the contract each routine states."""
    z = np.zeros(0, np.int64)
    for _ in range(cases):
        nbytes = int(rng.integers(0, 3000))
        buf = rng.integers(0, 256, nbytes).astype(np.uint8)
        n = int(rng.integers(0, 40))
        offsets = rng.integers(0, max(1, nbytes), n).astype(np.int64) if n else z
        caplens = rng.integers(0, 4000, n).astype(np.int64) if n else z
        caplens = np.minimum(caplens, np.maximum(nbytes - offsets, 0))
        origlens = rng.integers(0, 70000, n).astype(np.int64) if n else z
        for mode in ("udp", "tcp"):
            for strict in (False, True):
                valid, _, _ = native.decode(buf, offsets, caplens, origlens, mode, strict)
                if valid.shape != (n,):
                    raise AssertionError(f"decode returned {valid.shape} for {n} packets")
        lens = np.minimum(caplens, 128)
        out = native.fill_padded(buf, offsets, lens, 128)
        if out.shape != (n, 128):
            raise AssertionError(f"fill_padded returned {out.shape}")
        if n:
            native.pack(out, lens, 256)
        rows_n = int(rng.integers(1, 8))
        stride = int(rng.integers(1, 300))
        out2 = np.zeros((rows_n, stride), np.uint8)
        s_len = np.minimum(lens, stride).astype(np.int64)
        s_src = np.minimum(offsets, max(0, nbytes - 1)).astype(np.int64)
        s_len = np.minimum(s_len, np.maximum(nbytes - s_src, 0))
        s_row = rng.integers(0, rows_n, n).astype(np.int64) if n else z
        s_off = np.minimum(rng.integers(0, stride, n).astype(np.int64) if n else z,
                           stride - s_len)
        if n:
            native.scatter_segments(buf, s_src, s_len, s_row, s_off, out2)
    return cases


def lying_frame(rng) -> bytes:
    """An Ethernet frame of random bytes whose header fields are drawn to
    reach every branch of the walk: IPv4 with any IHL and protocol (and a
    TCP data offset where the frame reaches it), IPv6 with its next header
    and a fragment header's, ARP, a VLAN tag, or any ethertype."""
    fr = bytearray(rng.integers(0, 256, int(rng.integers(0, 140))).astype(np.uint8).tobytes())
    fr = bytearray(14) + fr
    et = int(rng.choice([0x0800, 0x0800, 0x86DD, 0x0806, 0x8100, int(rng.integers(0, 65536))]))
    fr[12:14] = et.to_bytes(2, "big")
    if et == 0x0800 and len(fr) > 23:
        fr[14] = 0x40 | int(rng.integers(0, 16))
        fr[23] = int(rng.choice([17, 6, 1, int(rng.integers(0, 256))]))
        doff = 14 + (fr[14] & 0x0F) * 4 + 12
        if doff < len(fr):
            fr[doff] = int(rng.integers(0, 16)) << 4
    elif et == 0x86DD and len(fr) > 20:
        fr[20] = int(rng.choice([17, 6, 44, 58]))
        if len(fr) > 54:
            fr[54] = int(rng.choice([17, 6, 58]))
    return bytes(fr)


def _capture(frames, caplens, origlens) -> PcapFile:
    """A capture of ``frames`` cut at ``caplens``: their captured bytes laid
    end to end in a fresh numpy buffer of exactly that many bytes."""
    caps = np.asarray(caplens, np.int64)
    data = b"".join(fr[:c] for fr, c in zip(frames, caps.tolist()))
    buf = np.empty(len(data), np.uint8)
    buf[:] = np.frombuffer(data, np.uint8)
    z = np.zeros(caps.size, np.int64)
    return PcapFile(buf=buf, offsets=np.cumsum(caps) - caps, caplens=caps,
                    origlens=np.asarray(origlens, np.int64), ts_sec=z, ts_frac=z,
                    linktype=1, snaplen=65535, nanos=False)


def _walk_equals_spec(pcap: PcapFile, mode: str, bpf_filter: bool) -> None:
    """Raise unless the walk's rows are the numpy walks' rows."""
    batch = extract_payloads(pcap, mode, keep_invalid=True)
    n = pcap.num_packets
    lengths, src_idx, want = batch.lengths[:n], np.arange(n), batch.payloads[:n]
    if bpf_filter:
        mask = bpf_protocol_mask(pcap, mode)
        lengths, src_idx, want = lengths[mask], src_idx[mask], want[mask]
    got, got_l, got_i = live_walk.walk(pcap, mode, bpf_filter)
    if not (np.array_equal(got_l, lengths) and np.array_equal(got_i, src_idx)):
        raise AssertionError(f"live walk ({mode}, filter={bpf_filter}): lengths or indices differ")
    for r, ln in enumerate(lengths.tolist()):
        if not np.array_equal(got[r, :ln], want[r, :ln]) or got[r, ln:].any():
            raise AssertionError(f"live walk ({mode}, filter={bpf_filter}): row {r} differs")


def walk_fuzz(rng, cases: int) -> int:
    """``cases`` rounds of the live walk over up to 30 lying frames, as part
    4 of the module docstring says."""
    for _ in range(cases):
        n = int(rng.integers(0, 30))
        frames = [lying_frame(rng) for _ in range(n)]
        caps = [int(rng.integers(0, len(fr) + 1)) if rng.integers(3) == 0 else len(fr)
                for fr in frames]
        origs = [int(rng.choice([len(fr), rng.integers(0, 60), len(fr) + rng.integers(0, 300)]))
                 for fr in frames]
        pcap = _capture(frames, caps, origs)
        for mode in ("udp", "tcp"):
            for bpf_filter in (True, False):
                _walk_equals_spec(pcap, mode, bpf_filter)
                for i in range(n):
                    live_walk.walk(_capture(frames[i:i + 1], caps[i:i + 1], origs[i:i + 1]),
                                   mode, bpf_filter)
        # Index arrays that point past the buffer: the walk clips them.
        if n:
            nbytes = pcap.buf.size
            lying = PcapFile(
                buf=pcap.buf, offsets=rng.integers(-5, nbytes + 50, n).astype(np.int64),
                caplens=rng.integers(-5, 400, n).astype(np.int64),
                origlens=np.asarray(origs, np.int64), ts_sec=pcap.ts_sec, ts_frac=pcap.ts_frac,
                linktype=1, snaplen=65535, nanos=False)
            live_walk.walk(lying, "udp", bool(rng.integers(2)))
            live_walk.walk(lying, "tcp", bool(rng.integers(2)))
    return cases


def self_test(lib: ctypes.CDLL) -> None:
    """One out-of-bounds read through the raw entry: ``msm_fill_padded``
    copies 8,192 bytes out of a 4,096-byte buffer.  Under ASan the process
    dies here with a heap-buffer-overflow report."""
    buf = np.zeros(4096, np.uint8)
    starts = np.zeros(1, np.int64)
    lens = np.full(1, 8192, np.int64)
    out = np.zeros((1, 8192), np.uint8)
    print("self-test: msm_fill_padded reads 8,192 bytes of a 4,096-byte buffer", flush=True)
    lib.msm_fill_padded(native._u8(buf), native._i64(starts), native._i64(lens), 1,
                        native._u8(out), 8192)
    print("self-test: the out-of-bounds read was NOT reported (no sanitizer loaded?)", flush=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--garbage-cases", type=int, default=4000)
    ap.add_argument("--geometry-cases", type=int, default=500)
    ap.add_argument("--self-test", action="store_true",
                    help="one deliberate out-of-bounds call: must die with ASan's report")
    args = ap.parse_args(argv)
    if not os.environ.get(CHILD):
        build()
        reexec(argv)
    lib = swap_in(SO)
    if args.self_test:
        self_test(lib)
        return 1
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        walks = walk_differential(rng, tmp, CAPTURES)
        timestamp_extremes()
        print(f"structured captures clean under ASan: {2 * CAPTURES} captures, "
              f"{walks} native/Python walk pairs, timestamp extremes; iter_pcap batches "
              f"mapped {INGEST['mapped']}, read {INGEST['read']}", flush=True)
        garbage_fuzz(rng, tmp, args.garbage_cases)
        print(f"raw-garbage fuzz clean under ASan: {args.garbage_cases} cases", flush=True)
    geometry_fuzz(rng, args.geometry_cases)
    print(f"decode/fill/pack/scatter fuzz clean under ASan: {args.geometry_cases} cases",
          flush=True)
    walk_fuzz(rng, args.geometry_cases)
    print(f"live walk fuzz clean under ASan: {args.geometry_cases} cases", flush=True)
    print(f"ASAN AUDIT CLEAN (seed {args.seed}, {time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
