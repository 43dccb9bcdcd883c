"""Torch package host layer against the JAX package's: synthetic captures,
pcap ingest, payload decode, staging plans and pattern files.

Every comparison is exact (bytes and integers: tolerance 0).  Both packages
run with the native C++ ingest and with ``MSM_NO_NATIVE=1``.
"""

import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.io import native as jax_native
from multithreading_string_matching_tpu.io import synth as jax_synth
from multithreading_string_matching_tpu.io.decode import extract_payloads as jax_extract
from multithreading_string_matching_tpu.io.patterns import load_patterns as jax_load
from multithreading_string_matching_tpu.io.pcap import read_pcap as jax_read
from multithreading_string_matching_tpu.ops import bucketing as jax_bucketing
from multithreading_string_matching_tpu_torch.io import native as pt_native
from multithreading_string_matching_tpu_torch.io import synth as pt_synth
from multithreading_string_matching_tpu_torch.io.decode import extract_payloads as pt_extract
from multithreading_string_matching_tpu_torch.io.patterns import (
    load_patterns as pt_load,
    split_c_tokens,
    unescape_token,
)
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap as pt_read
from multithreading_string_matching_tpu_torch.ops import bucketing as pt_bucketing

torch.set_num_threads(1)

STANDIN = (
    pathlib.Path(__file__).resolve().parent.parent
    / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"
)

# (packets, payload_len, jitter, invalid_rate, plant_rate, seed)
CORPORA = {
    "fixed": (120, 64, 0, 0.0, 0.3, 0),
    "jitter-invalid": (300, 200, 180, 0.15, 0.5, 7),
    "tiny-payloads": (200, 6, 6, 0.05, 0.5, 3),
}


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    """Run both packages with the native ingest, or with MSM_NO_NATIVE=1."""
    if request.param == "numpy":
        monkeypatch.setenv("MSM_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("MSM_NO_NATIVE", raising=False)
    for mod in (jax_native, pt_native):
        mod._lib, mod._tried = None, False
    if request.param == "native":
        assert pt_native.available() and jax_native.available()
    yield request.param
    for mod in (jax_native, pt_native):
        mod._lib, mod._tried = None, False


def _synth_both(tmp_path, name):
    n, ln, jit, inv, plant, seed = CORPORA[name]
    pats = pt_load(STANDIN)
    paths = []
    for tag, mod in (("jax", jax_synth), ("torch", pt_synth)):
        path = tmp_path / f"{name}-{tag}.pcap"
        total = mod.synth_udp_pcap(
            path, n, payload_len=ln, payload_len_jitter=jit, patterns=pats,
            plant_rate=plant, invalid_rate=inv, seed=seed,
        )
        paths.append((path, total))
    return paths


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_synth_writes_identical_bytes(tmp_path, name):
    (pj, tj), (pt, tt) = _synth_both(tmp_path, name)
    assert tj == tt
    assert pj.read_bytes() == pt.read_bytes()


@pytest.mark.parametrize("mode", ["udp", "tcp"])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_read_and_extract_identical(tmp_path, native_mode, name, mode):
    (path, _), _ = _synth_both(tmp_path, name)
    jp, tp = jax_read(path), pt_read(path)
    for field in ("buf", "offsets", "caplens", "origlens", "ts_sec", "ts_frac"):
        assert np.array_equal(getattr(jp, field), getattr(tp, field)), field
    assert (jp.linktype, jp.snaplen, jp.nanos) == (tp.linktype, tp.snaplen, tp.nanos)
    for kw in ({}, {"pad_n_to": 128, "pad_len_to": 8}, {"keep_invalid": True}):
        jb, tb = jax_extract(jp, mode, **kw), pt_extract(tp, mode, **kw)
        assert jb.payloads.dtype == tb.payloads.dtype == np.uint8
        assert jb.lengths.dtype == tb.lengths.dtype == np.int32
        assert np.array_equal(jb.payloads, tb.payloads)
        assert np.array_equal(jb.lengths, tb.lengths)
        assert np.array_equal(jb.valid, tb.valid)
        assert jb.num_packets == tb.num_packets


def test_corpus_exercises_ihl6_and_invalid(tmp_path):
    """The synthetic corpus really carries IP options and undecodable packets."""
    (path, _), _ = _synth_both(tmp_path, "jitter-invalid")
    pc = pt_read(path)
    ihl = np.array([pc.packet(i)[14] & 0x0F for i in range(pc.num_packets)
                    if pc.caplens[i] > 14])
    assert (ihl == 6).sum() >= 10
    assert (~pt_extract(pc, "udp").valid).sum() >= 10


@pytest.mark.parametrize("n_tile,l_quant", [(2048, 128), (64, 32), (16, 8)])
def test_bucket_plan_identical(tmp_path, n_tile, l_quant):
    (path, _), _ = _synth_both(tmp_path, "jitter-invalid")
    lengths = pt_extract(pt_read(path), "udp").lengths
    jplan = jax_bucketing.bucket_plan(lengths, n_tile=n_tile, l_quant=l_quant)
    tplan = pt_bucketing.bucket_plan(lengths, n_tile=n_tile, l_quant=l_quant)
    assert len(jplan) == len(tplan)
    for (ji, jl), (ti, tl) in zip(jplan, tplan):
        assert jl == tl and np.array_equal(ji, ti)
    for n in (0, 1, 7, 8, 9, 1000, 1025, 5000):
        assert jax_bucketing.quantize_rows(n) == pt_bucketing.quantize_rows(n)


@pytest.mark.parametrize("width", [400, 2048])
def test_pack_rows_identical(tmp_path, native_mode, width):
    (path, _), _ = _synth_both(tmp_path, "jitter-invalid")
    b = pt_extract(pt_read(path), "udp")
    jp, jf = jax_bucketing.pack_rows(b.payloads, b.lengths, width=width)
    tp, tf = pt_bucketing.pack_rows(b.payloads, b.lengths, width=width)
    assert np.array_equal(jp, tp) and np.array_equal(jf, tf)
    assert jax_bucketing.pack_plan(b.lengths, width) == pt_bucketing.pack_plan(b.lengths, width)


def test_pack_rows_refuses_oversized_payload():
    payloads = np.ones((2, 300), np.uint8)
    with pytest.raises(ValueError):
        pt_bucketing.pack_rows(payloads, np.array([300, 10]), width=256)


def test_pattern_loading_identical(tmp_path):
    assert jax_load(STANDIN) == pt_load(STANDIN)
    f = tmp_path / "esc.txt"
    f.write_bytes(b"GET\\x20/ \\x00\\x01 a\\\\b\n plain\ttab")
    assert jax_load(f, syntax="escaped") == pt_load(f, syntax="escaped")
    assert pt_load(f, syntax="escaped")[:2] == [b"GET /", b"\x00\x01"]
    assert split_c_tokens(b" a\tb\n\vc ") == [b"a", b"b", b"c"]
    with pytest.raises(ValueError):
        unescape_token(b"\\x+1")


def test_standin_pattern_file_shape(monkeypatch):
    """97 NUL-free tokens of 2-12 bytes with the reference's duplicate
    counts, small enough that the JAX package picks its unrolled kernel."""
    from collections import Counter

    from multithreading_string_matching_tpu.api import Matcher as JaxMatcher

    pats = pt_load(STANDIN)
    assert len(pats) == 97
    assert all(2 <= len(p) <= 12 and 0 not in p for p in pats)
    dups = {p: c for p, c in Counter(pats).items() if c > 1}
    assert dups == {b"ack": 3, b"content": 2, b"seq": 2, b"dsize": 2, b"icode": 2,
                    b"offset": 2, b"depth": 2, b"nocase": 2, b"alert": 2}
    for name in (b"http", b"Linux", b"NOTIFY", b"LOCATION", b"id", b"rpc", b"xml",
                 b"ubuntu", b"youtube", b"msg", b"flow", b"sid", b"classtype",
                 b"within", b"distance"):
        assert name in pats
    # MSM_PALLAS_INTERPRET=1 keeps engine 'pallas' on a CPU host, so
    # explain() names the kernel the set would compile to.
    monkeypatch.setenv("MSM_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("MSM_PALLAS_TABLE", raising=False)
    assert JaxMatcher(pats).explain()["pallas_kernel"] == "unrolled"


def test_pcapng_is_refused_clearly(tmp_path):
    """pcapng reads now (tests/test_torch_pcapng.py); a section header with
    no byte-order magic is refused with the JAX package's ValueError."""
    f = tmp_path / "x.pcapng"
    f.write_bytes(b"\x0a\x0d\x0d\x0a" + b"\x00" * 40)
    for read in (pt_read, jax_read):
        with pytest.raises(ValueError, match="pcapng SHB with invalid byte-order magic"):
            read(f)


@pytest.mark.parametrize("codec", ["gzip", "bz2", "lzma"])
def test_compressed_capture_reads_identically(tmp_path, codec):
    import importlib

    (path, _), _ = _synth_both(tmp_path, "fixed")
    packed = tmp_path / f"fixed.pcap.{codec}"
    packed.write_bytes(importlib.import_module(codec).compress(path.read_bytes()))
    a, b = pt_read(path), pt_read(packed)
    assert np.array_equal(a.buf, b.buf) and np.array_equal(a.offsets, b.offsets)
    c = pt_read(packed, strict=False)
    assert np.array_equal(a.offsets, c.offsets)


def _flows_capture(path):
    """TCP flows over IPv4 and IPv6, some VLAN/QinQ-tagged, plus UDP noise."""
    from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap

    flows = [
        (("10.0.0.1", "10.0.0.2", 1000 + i, 80), b"GET /index.html ack flow " * (i + 1))
        for i in range(6)
    ] + [
        (("2001:db8::1", "2001:db8::2", 2000 + i, 443), b"youtube content seq " * (i + 2))
        for i in range(4)
    ]
    synth_tcp_flows_pcap(path, flows, segment_len=17, interleave_seed=1,
                         noise_packets=20, seed=4, vlan_rate=0.4)
    return path


@pytest.mark.parametrize("linktype", [None, 113, 0, 101])
@pytest.mark.parametrize("mode", ["udp", "tcp"])
def test_decode_options_and_linktypes_identical(tmp_path, native_mode, mode, linktype):
    """strict / vlan / ipv6 and the SLL, NULL and raw-IP link layers decode
    the same bytes to the same payloads in both packages."""
    path = _flows_capture(tmp_path / "flows.pcap")
    if linktype is not None:
        raw = bytearray(path.read_bytes())
        raw[20:24] = linktype.to_bytes(4, "little")
        path.write_bytes(bytes(raw))
    jp, tp = jax_read(path), pt_read(path)
    for kw in ({}, {"strict": True}, {"vlan": True}, {"ipv6": True},
               {"vlan": True, "ipv6": True, "strict": True}):
        jb, tb = jax_extract(jp, mode, **kw), pt_extract(tp, mode, **kw)
        assert np.array_equal(jb.payloads, tb.payloads), kw
        assert np.array_equal(jb.lengths, tb.lengths), kw
        assert np.array_equal(jb.valid, tb.valid), kw
    if linktype is None and mode == "tcp":
        both = pt_extract(tp, "tcp", vlan=True, ipv6=True)
        assert both.valid.sum() > pt_extract(tp, "tcp").valid.sum()  # the options matter
