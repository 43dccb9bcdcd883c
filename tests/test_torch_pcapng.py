"""pcapng in the torch package against the JAX package: ``read_pcap``,
``iter_pcap`` and ``read_pcap_range`` field by field, the native and the
Python walks, the malformed and truncated cases, and ``match`` counts on a
pcapng capture equal to the classic one in both command lines.

The pcapng files are re-encoded here from synthesized classic captures
(SHB + IDB + EPB/SPB/PB blocks, either byte order, junk blocks, several
sections).  Every comparison is exact.
"""

import gzip
import json
import pathlib
import struct

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.cli import main as jax_main
from multithreading_string_matching_tpu.io import pcap as jax_pcap
from multithreading_string_matching_tpu.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io import pcap as pt_pcap
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = REPO / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"

FIELDS = ("offsets", "caplens", "origlens", "ts_sec", "ts_frac")


def _block(end, btype, body):
    pad = (-len(body)) % 4
    blen = 12 + len(body) + pad
    return struct.pack(end + "II", btype, blen) + body + b"\x00" * pad + struct.pack(end + "I", blen)


def _shb(end):
    return _block(end, 0x0A0D0D0A, struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1))


def _idb(end, linktype, snaplen, tsresol=None):
    body = struct.pack(end + "HHI", linktype, 0, snaplen)
    if tsresol is not None:
        body += struct.pack(end + "HH", 9, 1) + bytes([tsresol, 0, 0, 0])
        body += struct.pack(end + "HH", 0, 0)
    return _block(end, 0x00000001, body)


def pcapng_from(pcap, end="<", kind="epb", junk=False, tsresol=None, idx=None):
    """Re-encode a classic capture's packets (``idx``, default all) as one
    pcapng section: ``kind`` is epb, spb or pb; ``tsresol`` an if_tsresol
    byte (timestamps re-scaled to it)."""
    out = bytearray(_shb(end))
    out += _idb(end, pcap.linktype, pcap.snaplen, tsresol)
    if junk:
        out += _block(end, 0x0BADF00D, b"\x00" * 16)  # unknown blocks are skipped
    per_sec = 1_000_000 if tsresol is None else 10 ** tsresol
    for i in range(pcap.num_packets) if idx is None else idx:
        data = pcap.packet(i).tobytes()
        ticks = int(pcap.ts_sec[i]) * per_sec + int(pcap.ts_frac[i]) * per_sec // 1_000_000
        hi, lo = (ticks >> 32) & 0xFFFFFFFF, ticks & 0xFFFFFFFF
        orig = int(pcap.origlens[i])
        if kind == "spb":
            out += _block(end, 0x00000003, struct.pack(end + "I", orig) + data)
        elif kind == "pb":
            out += _block(end, 0x00000002,
                          struct.pack(end + "HHIIII", 0, 0, hi, lo, len(data), orig) + data)
        else:
            out += _block(end, 0x00000006,
                          struct.pack(end + "IIIII", 0, hi, lo, len(data), orig) + data)
        if junk and i % 17 == 3:
            out += _block(end, 0x00000005, b"\x01" * 28)  # an ISB between packets
    return bytes(out)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_pcapng") / "synth.pcap"
    synth_udp_pcap(path, 300, payload_len=160, payload_len_jitter=120,
                   patterns=load_patterns(STANDIN), plant_rate=0.5, invalid_rate=0.03, seed=6)
    return path


@pytest.fixture(scope="module")
def classic(capture):
    return pt_pcap.read_pcap(capture)


def assert_same(got, want):
    """Two PcapFiles, field by field (one from each package, or two reads)."""
    assert got.num_packets == want.num_packets
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert np.array_equal(got.buf, want.buf)
    assert (got.linktype, got.snaplen, got.nanos) == (want.linktype, want.snaplen, want.nanos)


def assert_same_packets(got, want):
    """The same packets whatever the buffer layout."""
    assert got.num_packets == want.num_packets
    for i in range(want.num_packets):
        assert got.packet(i).tobytes() == want.packet(i).tobytes(), i
    for f in ("caplens", "origlens"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


LAYOUTS = [("<", "epb", False), (">", "epb", True), ("<", "spb", True), (">", "spb", False),
           ("<", "pb", False)]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("end,kind,junk", LAYOUTS)
def test_read_pcap_equals_jax(tmp_path, classic, end, kind, junk, native):
    path = tmp_path / "c.pcapng"
    path.write_bytes(pcapng_from(classic, end=end, kind=kind, junk=junk))
    got = pt_pcap.read_pcap(path, use_native=native)
    assert_same(got, jax_pcap.read_pcap(path, use_native=native))
    assert_same_packets(got, classic)
    if kind != "spb":  # an SPB carries no timestamp
        assert np.array_equal(got.ts_sec, classic.ts_sec)
        assert np.array_equal(got.ts_frac, classic.ts_frac)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("batch,read_size", [(7, 512), (64, 1 << 20), (1000, 4096)])
def test_iter_pcap_equals_jax(tmp_path, classic, batch, read_size, native):
    path = tmp_path / "c.pcapng"
    path.write_bytes(pcapng_from(classic, end=">", junk=True))
    kw = dict(batch_packets=batch, read_size=read_size, use_native=native)
    got = list(pt_pcap.iter_pcap(path, **kw))
    want = list(jax_pcap.iter_pcap(path, **kw))
    assert len(got) == len(want) == -(-classic.num_packets // batch)
    for g, w in zip(got, want):
        assert_same(g, w)
    assert_same_packets(pt_pcap.concat_pcaps(got), pt_pcap.read_pcap(path))


@pytest.mark.parametrize("ng", [False, True])
@pytest.mark.parametrize("rng", [(0, 10), (5, 50), (290, 400), (10, 5), (0, 300)])
def test_read_pcap_range_equals_jax(tmp_path, capture, classic, ng, rng):
    path = capture
    if ng:
        path = tmp_path / "c.pcapng"
        path.write_bytes(pcapng_from(classic))
    got = pt_pcap.read_pcap_range(path, *rng)
    assert_same(got, jax_pcap.read_pcap_range(path, *rng))
    assert_same_packets(got, pt_pcap.slice_pcap(classic, *rng))


def _two_sections(classic):
    """Section 1 little-endian with microsecond ticks, section 2 big-endian
    with nanosecond ticks (if_tsresol 9): interface state is per section."""
    half = classic.num_packets // 2
    one = pcapng_from(classic, end="<", idx=range(half))
    two = pcapng_from(classic, end=">", tsresol=9, idx=range(half, classic.num_packets))
    return one + two


@pytest.mark.parametrize("native", [True, False])
def test_two_sections_equal_jax(tmp_path, classic, native):
    path = tmp_path / "two.pcapng"
    path.write_bytes(_two_sections(classic))
    got = pt_pcap.read_pcap(path, use_native=native)
    assert_same(got, jax_pcap.read_pcap(path, use_native=native))
    assert_same_packets(got, classic)
    assert np.array_equal(got.ts_sec, classic.ts_sec)
    assert np.array_equal(got.ts_frac, classic.ts_frac)
    for g, w in zip(pt_pcap.iter_pcap(path, batch_packets=11, use_native=native),
                    jax_pcap.iter_pcap(path, batch_packets=11, use_native=native)):
        assert_same(g, w)


def test_gzip_pcapng_reads_like_plain(tmp_path, classic):
    blob = pcapng_from(classic, junk=True)
    plain, packed = tmp_path / "c.pcapng", tmp_path / "c.pcapng.gz"
    plain.write_bytes(blob)
    packed.write_bytes(gzip.compress(blob))
    assert_same(pt_pcap.read_pcap(packed), pt_pcap.read_pcap(plain))
    assert_same(pt_pcap.concat_pcaps(list(pt_pcap.iter_pcap(packed, batch_packets=50))),
                pt_pcap.concat_pcaps(list(jax_pcap.iter_pcap(packed, batch_packets=50))))


def _malformed():
    end = "<"
    return _shb(end) + _idb(end, 1, 65535) + _block(end, 0x00000006, b"")


def _truncated(classic):
    blob = pcapng_from(classic)
    return blob[: len(blob) - 7]


def _bad_idb_option():
    end = "<"
    body = struct.pack(end + "HHI", 1, 0, 65535) + struct.pack(end + "HH", 9, 1)
    return _shb(end) + _block(end, 0x00000001, body)


def _no_idb(classic):
    data = classic.packet(0).tobytes()
    return _shb("<") + _block("<", 0x00000006,
                              struct.pack("<IIIII", 0, 0, 1, len(data), len(data)) + data)


BROKEN = {"malformed EPB": lambda c: _malformed(), "truncated": _truncated,
          "truncated IDB option": lambda c: _bad_idb_option(), "no IDB": _no_idb}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", list(BROKEN))
def test_broken_captures_like_jax(tmp_path, classic, name, native):
    """strict: the same ValueError from both packages and both readers;
    strict=False: the same complete prefix."""
    path = tmp_path / "bad.pcapng"
    path.write_bytes(BROKEN[name](classic))
    for reader in ("read_pcap", "iter_pcap"):
        def run(mod, **kw):
            fn = getattr(mod, reader)
            return fn(path, use_native=native, **kw) if reader == "read_pcap" else (
                mod.concat_pcaps(list(fn(path, batch_packets=13, use_native=native, **kw))
                                 or [mod.read_pcap(path, strict=False)]))

        with pytest.raises(ValueError) as got:
            run(pt_pcap)
        with pytest.raises(ValueError) as want:
            run(jax_pcap)
        assert str(got.value) == str(want.value)
        if name != "no IDB":
            assert_same(run(pt_pcap, strict=False), run(jax_pcap, strict=False))


def _json(main, argv, capsys):
    assert main(argv) == 0
    blob = json.loads(capsys.readouterr().out)
    return {k: v for k, v in blob.items() if k not in ("phases", "execution")}


@pytest.mark.parametrize("flags", [[], ["--stream"], ["--engine", "ac"], ["--flows"],
                                   ["--strict"], ["--dump-matches", "@dump"]])
def test_match_pcapng_equals_classic_both_clis(tmp_path, capture, classic, capsys, monkeypatch,
                                               flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    ng = tmp_path / "c.pcapng"
    ng.write_bytes(pcapng_from(classic, end=">", junk=True))

    def argv(path, tag):
        fl = [str(tmp_path / f"{tag}.pcap") if f == "@dump" else f for f in flags]
        return ["match", "--pcap", str(path), "--patterns", str(STANDIN), "--json", *fl]

    want = _json(jax_main, argv(capture, "jc"), capsys)
    for main, tag in ((pt_main, "t"), (jax_main, "j")):
        got = _json(main, argv(ng, tag + "n"), capsys)
        got.pop("dump_path", None)
        assert got == {k: v for k, v in want.items() if k != "dump_path"}, tag
    assert sum(want["counts"]) > 0
    if "@dump" in flags:
        # pcapng in, classic out: the same hit packets from both packages.
        t, j = (pt_pcap.read_pcap(tmp_path / f"{x}n.pcap") for x in ("t", "j"))
        assert_same(t, j)


@pytest.mark.parametrize("stream", [False, True])
def test_match_mixed_containers_one_corpus(tmp_path, capture, classic, capsys, monkeypatch,
                                           stream):
    """Repeated --pcap may mix classic and pcapng: one corpus, packets
    numbered in input order."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    ng = tmp_path / "c.pcapng.gz"
    ng.write_bytes(gzip.compress(pcapng_from(classic)))
    extra = ["--stream"] if stream else []
    base = ["match", "--patterns", str(STANDIN), "--json", *extra]
    mixed = _json(pt_main, base + ["--pcap", str(capture), "--pcap", str(ng)], capsys)
    twice = _json(jax_main, base + ["--pcap", str(capture), "--pcap", str(capture)], capsys)
    assert mixed == twice
    single = _json(pt_main, base + ["--pcap", str(capture)], capsys)
    assert mixed["counts"] == [2 * c for c in single["counts"]]


def test_match_truncated_pcapng_strict_like_jax(tmp_path, classic, capsys, monkeypatch):
    """A truncated capture stops both command lines with the same error;
    --strict (the decode checks) does not change that."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    path = tmp_path / "trunc.pcapng"
    path.write_bytes(_truncated(classic))
    for flags in ([], ["--strict"], ["--stream", "--strict"]):
        argv = ["match", "--pcap", str(path), "--patterns", str(STANDIN), *flags]
        assert pt_main(argv) == 1
        got = capsys.readouterr()
        assert jax_main(argv) == 1
        want = capsys.readouterr()
        assert got.err == want.err and "pcapng block" in got.err
