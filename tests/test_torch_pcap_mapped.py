"""The mapped classic-pcap walk of the torch package's ``iter_pcap``.

A regular classic capture opened by path is walked in place through a
read-only mapping, each batch a view of the records it holds; every other
source (file objects, stdin, pipes, codecs, pcapng, ``use_native=False``)
reads through a buffer.  Both paths must give the same batches, field by
field and payload for payload, as each other and as the JAX package's
``iter_pcap``, with the same errors; ``pcap.INGEST`` counts which path ran.
Inputs are seeded synth captures re-encoded in each byte order and
timestamp resolution; every comparison is exact.
"""

import gzip
import os
import pathlib
import struct
import sys
import threading
import types

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.io import pcap as jax_pcap
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io import native
from multithreading_string_matching_tpu_torch.io import pcap as pt_pcap
from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu_torch.parallel import pipeline

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = load_patterns(REPO / "multithreading_string_matching_tpu_torch" / "data"
                        / "strings_standin.txt")
FIELDS = ("offsets", "caplens", "origlens", "ts_sec", "ts_frac")


@pytest.fixture(scope="module")
def packets(tmp_path_factory):
    """A 300-packet UDP capture planted with the stand-in set, parsed."""
    path = tmp_path_factory.mktemp("torch_pcap_mapped") / "synth.pcap"
    synth_udp_pcap(path, 300, payload_len=160, payload_len_jitter=150, patterns=STANDIN,
                   plant_rate=0.5, invalid_rate=0.05, seed=20)
    return pt_pcap.read_pcap(path)


def encode(pcap, big_endian=False, nanos=False, count=None):
    """``pcap``'s first ``count`` packets as a classic capture of one byte
    order and timestamp resolution (the fraction re-scaled to it)."""
    end = ">" if big_endian else "<"
    magic = pt_pcap.MAGIC_NSEC_LE if nanos else pt_pcap.MAGIC_USEC_LE
    out = bytearray(struct.pack(end + "IHHiIII", magic, 2, 4, 0, 0, pcap.snaplen,
                                pcap.linktype))
    for i in range(pcap.num_packets if count is None else count):
        frac = int(pcap.ts_frac[i]) * (1000 if nanos else 1)
        data = pcap.packet(i).tobytes()
        out += struct.pack(end + "IIII", int(pcap.ts_sec[i]), frac, len(data),
                           int(pcap.origlens[i]))
        out += data
    return bytes(out)


def record_header(length, big_endian=False):
    return struct.pack((">" if big_endian else "<") + "IIII", 1, 2, length, length)


def outcome(fn):
    """``("ok", batches)`` or ``("err", "Type: message")``."""
    try:
        return "ok", list(fn())
    except (ValueError, OverflowError) as e:
        return "err", f"{type(e).__name__}: {e}"


def assert_same(got, want):
    """Two batch lists, field by field, buffers included."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.num_packets == w.num_packets
        for f in FIELDS:
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
            assert getattr(g, f).dtype == np.int64, f
        assert np.array_equal(g.buf, w.buf)
        assert (g.linktype, g.snaplen, g.nanos) == (w.linktype, w.snaplen, w.nanos)


def assert_same_payloads(got, want, mode="udp"):
    """Both batch lists decode to the same payloads, batch by batch."""
    for g, w in zip(got, want):
        a, b = extract_payloads(g, mode), extract_payloads(w, mode)
        assert a.num_packets == b.num_packets
        assert np.array_equal(a.valid, b.valid)
        assert np.array_equal(a.lengths, b.lengths)
        assert np.array_equal(a.payloads, b.payloads)


def counted(fn):
    """``fn()``'s result and the batches each ingest path yielded meanwhile."""
    before = dict(pt_pcap.INGEST)
    out = fn()
    return out, {k: pt_pcap.INGEST[k] - before[k] for k in before}


def read_path(path, **kw):
    """The read path's batches: the same file handed over as a file object."""
    with open(path, "rb") as f:
        return list(pt_pcap.iter_pcap(f, **kw))


@pytest.mark.parametrize("batch", [1, 7, 8192, 10**9])
@pytest.mark.parametrize("big_endian,nanos", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_mapped_equals_read_path_and_jax(tmp_path, packets, big_endian, nanos, batch):
    path = tmp_path / "c.pcap"
    path.write_bytes(encode(packets, big_endian, nanos))
    got, ran = counted(lambda: list(pt_pcap.iter_pcap(path, batch_packets=batch)))
    want = read_path(path, batch_packets=batch)
    assert ran == {"mapped": len(got), "read": 0}
    assert len(got) == -(-packets.num_packets // batch)
    assert_same(got, want)
    assert_same(got, list(jax_pcap.iter_pcap(path, batch_packets=batch)))
    assert_same_payloads(got, want)
    assert_same_payloads(got, list(pt_pcap.iter_pcap(path, batch_packets=batch,
                                                     use_native=False)))
    whole = pt_pcap.read_pcap(path)
    assert nanos == whole.nanos == got[0].nanos
    cat = pt_pcap.concat_pcaps(got)
    for i in range(whole.num_packets):
        assert cat.packet(i).tobytes() == whole.packet(i).tobytes()


def _tail_cases(pcap):
    """name: capture bytes with a damaged or odd end."""
    good = encode(pcap, count=40)
    return {
        "truncated-body": good + record_header(100) + b"x" * 60,
        "truncated-header": good + record_header(100)[:9],
        "trailing-bytes": good + b"\x01\x02\x03",
        "oversized-record": good + record_header(pt_pcap._MAX_STREAM_RECORD + 1),
        "oversized-first": encode(pcap, count=0) + record_header((1 << 32) - 1),
        "big-endian-truncated": encode(pcap, big_endian=True, count=40)
        + record_header(100, big_endian=True) + b"y" * 99,
        "header-only": encode(pcap, count=0),
        "short-header": encode(pcap, count=0)[:20],
        "empty": b"",
    }


TAIL_CASES = ["truncated-body", "truncated-header", "trailing-bytes", "oversized-record",
              "oversized-first", "big-endian-truncated", "header-only", "short-header",
              "empty"]


@pytest.mark.parametrize("batch", [1, 7, 40, 8192])
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("case", TAIL_CASES)
def test_ends_and_errors_equal_read_path(tmp_path, packets, case, strict, batch):
    path = tmp_path / "t.pcap"
    path.write_bytes(_tail_cases(packets)[case])
    kw = dict(batch_packets=batch, strict=strict)
    (kind, got), ran = counted(lambda: outcome(lambda: pt_pcap.iter_pcap(path, **kw)))
    want_kind, want = outcome(lambda: read_path(path, **kw))
    assert kind == want_kind, (got, want)
    jax_kind, jax_got = outcome(lambda: jax_pcap.iter_pcap(path, **kw))
    assert jax_kind == kind
    if kind == "err":
        assert got == want == jax_got
        if case in ("truncated-body", "big-endian-truncated") and strict:
            assert "truncated pcap record" in got
        if case == "truncated-header" and strict:  # a partial header is trailing bytes
            assert "9 trailing bytes" in got
        return
    assert_same(got, want)
    assert_same(got, jax_got)
    assert ran["read"] == 0 and ran["mapped"] == len(got)
    assert sum(b.num_packets for b in got) == (0 if case in ("header-only", "oversized-first")
                                               else 40)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("where", ["inside-next-batch", "before-position", "at-boundary"])
def test_file_cut_under_a_live_generator(tmp_path, packets, where, strict):
    """The file shrinks between two batches: a clean ValueError when strict,
    otherwise the complete records that are left, never a fault."""
    raw = encode(packets, count=120)
    path = tmp_path / "cut.pcap"
    path.write_bytes(raw)
    whole = pt_pcap.read_pcap(path)
    gen = pt_pcap.iter_pcap(path, batch_packets=50, strict=strict)
    first = next(gen)
    assert first.num_packets == 50 and not first.buf.flags.writeable
    assert first.packet(49).tobytes() == whole.packet(49).tobytes()
    end_of_first = 24 + first.buf.shape[0]
    cut = {"inside-next-batch": int(whole.offsets[70]) + 5,
           "before-position": end_of_first - 100,
           "at-boundary": int(whole.offsets[60]) - 16}[where]
    del first  # its pages may be cut away: never read it again
    os.truncate(path, cut)
    if strict:
        with pytest.raises(ValueError, match="shrank"):
            next(gen)
        return
    rest = list(gen)
    kept = {"inside-next-batch": 20, "before-position": 0, "at-boundary": 10}[where]
    assert sum(b.num_packets for b in rest) == kept
    for k in range(kept):
        assert rest[0].packet(k).tobytes() == whole.packet(50 + k).tobytes()
        assert rest[0].caplens[k] == whole.caplens[50 + k]


def test_batches_are_read_only_views(tmp_path, packets):
    raw = encode(packets)
    path = tmp_path / "ro.pcap"
    path.write_bytes(raw)
    batches = list(pt_pcap.iter_pcap(path, batch_packets=64))
    for b in batches:
        assert not b.buf.flags.writeable
        with pytest.raises(ValueError):
            b.buf[0] = b.buf[0] ^ 0xFF
        with pytest.raises(ValueError):
            b.buf.setflags(write=True)
    assert path.read_bytes() == raw
    # The mapping outlives the generator and the file's name.
    os.unlink(path)
    assert pt_pcap.concat_pcaps(batches).packet(0).tobytes() == packets.packet(0).tobytes()


def _pipe(data, consume):
    """``consume(read_end_file)`` while a thread writes ``data`` into a pipe."""
    r, w = os.pipe()

    def writer():
        with os.fdopen(w, "wb") as f:
            for i in range(0, len(data), 1000):
                f.write(data[i : i + 1000])

    t = threading.Thread(target=writer)
    t.start()
    try:
        with os.fdopen(r, "rb") as f:
            return consume(f)
    finally:
        t.join(timeout=30)
        assert not t.is_alive()


SOURCES = ["path", "file-object", "stdin", "pipe", "fifo-path", "gzip-file", "pcapng",
           "no-native", "no-native-env"]


@pytest.mark.parametrize("source", SOURCES)
def test_bypass_sources_take_the_read_path(tmp_path, packets, monkeypatch, source):
    raw = encode(packets, big_endian=True)
    path = tmp_path / "s.pcap"
    path.write_bytes(raw)
    want = read_path(path, batch_packets=9)
    it = lambda src, **kw: list(pt_pcap.iter_pcap(src, batch_packets=9, **kw))  # noqa: E731
    if source == "path":
        run = lambda: it(path)  # noqa: E731
    elif source == "file-object":
        run = lambda: read_path(path, batch_packets=9)  # noqa: E731
    elif source == "stdin":
        stdin = open(path, "rb")
        monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(buffer=stdin))
        run = lambda: it("-")  # noqa: E731
    elif source == "pipe":
        run = lambda: _pipe(raw, it)  # noqa: E731
    elif source == "fifo-path":
        fifo = tmp_path / "fifo"
        os.mkfifo(fifo)

        def run():
            t = threading.Thread(target=lambda: fifo.write_bytes(raw))
            t.start()
            try:
                return it(fifo)
            finally:
                t.join(timeout=30)
                assert not t.is_alive()
    elif source == "gzip-file":
        gz = tmp_path / "s.pcap.gz"
        gz.write_bytes(gzip.compress(raw))
        run = lambda: it(gz)  # noqa: E731
    elif source == "pcapng":
        from tests.test_torch_pcapng import pcapng_from

        ng = tmp_path / "s.pcapng"
        ng.write_bytes(pcapng_from(pt_pcap.read_pcap(path)))
        run = lambda: it(ng)  # noqa: E731
    elif source == "no-native":
        run = lambda: it(path, use_native=False)  # noqa: E731
    else:
        monkeypatch.setenv("MSM_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        run = lambda: it(path)  # noqa: E731
    got, ran = counted(run)
    if source == "stdin":
        stdin.close()
    path_kind = "mapped" if source == "path" else "read"
    assert ran == {"mapped": 0, "read": 0, path_kind: len(want)}
    if source == "pcapng":  # another container: the same packets, another layout
        for g, w in zip(got, want):
            assert [g.packet(k).tobytes() for k in range(g.num_packets)] == [
                w.packet(k).tobytes() for k in range(w.num_packets)]
        return
    if source.startswith("no-native"):  # the Python walk drops the record headers
        assert_same_payloads(got, want)
        return
    assert_same(got, want)
    assert_same_payloads(got, want)


@pytest.mark.parametrize("host_workers", [0, 2])
def test_count_pcap_streamed_equal_through_both_paths(tmp_path, packets, host_workers):
    path = tmp_path / "count.pcap"
    path.write_bytes(encode(packets))
    m = Matcher(STANDIN, device="cpu")
    kw = dict(batch_packets=32, tile_rows=8, pack_width=256, host_workers=host_workers)
    mapped, ran_m = counted(lambda: pipeline.count_pcap_streamed(m, path, "udp", **kw))
    with open(path, "rb") as f:
        read, ran_r = counted(lambda: pipeline.count_pcap_streamed(m, f, "udp", **kw))
    batches = -(-packets.num_packets // 32)
    assert ran_m == {"mapped": batches, "read": 0}
    assert ran_r == {"mapped": 0, "read": batches}
    assert np.array_equal(mapped, read)
    assert np.array_equal(mapped, m.count_pcap(path, "udp"))
    assert mapped.sum() > 0
