"""The torch package's flow layer against the JAX package's: TCP flow
captures (``synth_tcp_flows_pcap``), streamed ingest (``iter_pcap``,
``slice_pcap``), link-layer sizes (``l2_sizes``) and every function of
``io/flows.py``.

Inputs are made from seeds with numpy; every comparison is exact (bytes and
integers: tolerance 0).  Both packages run with the native C++ ingest and
with ``MSM_NO_NATIVE=1``.
"""

import filecmp
import gzip
import os
import struct
import threading

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.io import flows as jf
from multithreading_string_matching_tpu.io import native as jax_native
from multithreading_string_matching_tpu.io import pcap as jp
from multithreading_string_matching_tpu.io.decode import l2_sizes as jax_l2
from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap as jax_synth
from multithreading_string_matching_tpu_torch.io import flows as pf
from multithreading_string_matching_tpu_torch.io import native as pt_native
from multithreading_string_matching_tpu_torch.io import pcap as pp
from multithreading_string_matching_tpu_torch.io import synth as pt_synth
from multithreading_string_matching_tpu_torch.io.decode import l2_sizes as pt_l2
from multithreading_string_matching_tpu_torch.ops import _build

torch.set_num_threads(1)

ALPHABET = np.frombuffer(b"abcSIGNATURExyz\x00", np.uint8)
KEY_V6 = ("2001:db8::1", "2001:db8::2", 4444, 443)


def _flows(seed, n, lo=40, hi=500, v6_every=0):
    """``n`` flows of random streams, each planted with a split-prone
    signature; every ``v6_every``-th flow is IPv6."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pay = bytearray(ALPHABET[rng.integers(0, len(ALPHABET), size=int(rng.integers(lo, hi)))])
        o = int(rng.integers(0, len(pay) - 9))
        pay[o : o + 9] = b"SIGNATURE"
        if v6_every and i % v6_every == v6_every - 1:
            key = (f"2001:db8::{i + 1:x}", KEY_V6[1], 2000 + i, 443)
        else:
            key = (f"10.0.{i // 200}.{i % 200 + 1}", "10.9.0.1", 1000 + i, 80)
        out.append((key, bytes(pay)))
    return out


# name: (flows, synth kwargs, decode kwargs)
CAPTURES = {
    "v4-interleaved-noise": (_flows(1, 7), dict(segment_len=23, interleave_seed=9,
                                                noise_packets=5, seed=2), {}),
    "v4-explicit-segments": ([(("10.0.0.1", "10.0.0.2", 1111, 80), b"xxxxSIGNATUREyyySIGNATUREzz",
                               [8, 8, 7, 4]),
                              (("10.0.0.3", "10.0.0.2", 2222, 80), b"ppppSIGNATUREqq", [5, 5, 5])],
                             dict(interleave_seed=9, noise_packets=3), {}),
    "v6-mixed": (_flows(3, 6, v6_every=2), dict(segment_len=31, interleave_seed=4, seed=5),
                 dict(ipv6=True)),
    "vlan": (_flows(6, 6), dict(segment_len=19, interleave_seed=1, vlan_rate=0.5, seed=7),
             dict(vlan=True)),
    "reorder-retransmit-overlap": (_flows(8, 5), dict(segment_len=17, interleave_seed=2,
                                                      reorder_seed=3, retransmit_rate=0.2,
                                                      overlap_rate=0.2, seed=11),
                                   dict(reorder=True)),
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


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_flows")
    out = {}
    for name, (flows, kw, dec) in CAPTURES.items():
        path = d / f"{name}.pcap"
        jax_synth(path, flows, **kw)
        out[name] = (path, dec)
    return out


def _truncated_capture(path):
    """Three TCP segments of one flow: the middle record's caplen cuts
    inside the TCP sequence number, the last one's inside the payload
    (origlen stays the wire length)."""
    key = ("10.1.0.1", "10.1.0.2", 5555, 80)
    frames = [pt_synth._eth_ipv4_tcp(b"abcSIGNA", key, 100),
              pt_synth._eth_ipv4_tcp(b"TUREabcd", key, 108),
              pt_synth._eth_ipv4_tcp(b"SIGNATURE", key, 116)]
    caps = [len(frames[0]), 14 + 20 + 6, len(frames[2]) - 4]
    with open(path, "wb") as f:
        f.write(pp.classic_global_header())
        for i, (fr, cap) in enumerate(zip(frames, caps)):
            f.write(struct.pack("<IIII", i, 0, cap, len(fr)))
            f.write(fr[:cap])


@pytest.mark.parametrize("name", sorted(CAPTURES))
def test_synth_tcp_flows_bytes_equal_jax(tmp_path, name):
    flows, kw, _ = CAPTURES[name]
    a, b = tmp_path / "jax.pcap", tmp_path / "port.pcap"
    assert jax_synth(a, flows, **kw) == pt_synth.synth_tcp_flows_pcap(b, flows, **kw)
    assert filecmp.cmp(a, b, shallow=False)


def test_synth_rejects_short_segment_lists(tmp_path):
    with pytest.raises(ValueError, match="segment_lens"):
        pt_synth.synth_tcp_flows_pcap(tmp_path / "x.pcap", [(("1.1.1.1", "2.2.2.2", 1, 2),
                                                             b"abcdef", [2, 2])])


@pytest.mark.parametrize("vlan", [False, True])
def test_l2_sizes_equal_jax(captures, vlan):
    path, _ = captures["vlan"]
    got = pt_l2(pp.read_pcap(path), vlan=vlan)
    want = jax_l2(jp.read_pcap(path), vlan=vlan)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got > 14).any() == vlan


@pytest.mark.parametrize("batch", [1, 7, 64, 100_000])
@pytest.mark.parametrize("name", ["v4-interleaved-noise", "vlan"])
def test_iter_pcap_batches_concatenate_to_read_pcap(captures, native_mode, name, batch):
    path, _ = captures[name]
    whole = pp.read_pcap(path)
    got = list(pp.iter_pcap(path, batch_packets=batch, read_size=997))
    want = list(jp.iter_pcap(path, batch_packets=batch, read_size=997))
    assert [b.num_packets for b in got] == [b.num_packets for b in want]
    assert all(b.num_packets <= batch for b in got)
    assert sum(b.num_packets for b in got) == whole.num_packets
    i = 0
    for g, w in zip(got, want):
        for field in ("caplens", "origlens", "ts_sec", "ts_frac"):
            assert np.array_equal(getattr(g, field), getattr(w, field)), field
            assert np.array_equal(getattr(g, field), getattr(whole, field)[i : i + g.num_packets])
        for k in range(g.num_packets):
            assert np.array_equal(g.packet(k), whole.packet(i + k))
            assert np.array_equal(g.packet(k), w.packet(k))
        i += g.num_packets


def test_iter_pcap_native_equals_numpy_walk(captures):
    path, _ = captures["reorder-retransmit-overlap"]
    nat = list(pp.iter_pcap(path, batch_packets=5, read_size=301, use_native=True))
    py = list(pp.iter_pcap(path, batch_packets=5, read_size=301, use_native=False))
    assert pt_native.available() and len(nat) == len(py)
    for a, b in zip(nat, py):
        assert np.array_equal(a.caplens, b.caplens)
        for k in range(a.num_packets):
            assert np.array_equal(a.packet(k), b.packet(k))


def test_iter_pcap_truncation_and_refusals(captures, tmp_path):
    path, _ = captures["v4-interleaved-noise"]
    raw = path.read_bytes()
    cut = tmp_path / "cut.pcap"
    cut.write_bytes(raw[:-5])
    with pytest.raises(ValueError):
        list(pp.iter_pcap(cut))
    got = list(pp.iter_pcap(cut, strict=False))
    want = list(jp.iter_pcap(cut, strict=False))
    assert sum(b.num_packets for b in got) == sum(b.num_packets for b in want) > 0
    with open(cut, "rb") as f:  # a file object reads like a path
        assert sum(b.num_packets for b in pp.iter_pcap(f, strict=False)) == sum(
            b.num_packets for b in got)
    with pytest.raises(ValueError, match="batch_packets"):
        list(pp.iter_pcap(path, batch_packets=0))
    # pcapng streams now; a section header with no byte-order magic is
    # refused as the JAX package refuses it.
    ng = tmp_path / "x.pcapng"
    ng.write_bytes(b"\x0a\x0d\x0d\x0a" + b"\x00" * 40)
    for mod in (pp, jp):
        with pytest.raises(ValueError, match="pcapng SHB with invalid byte-order magic"):
            list(mod.iter_pcap(ng))


@pytest.mark.parametrize("source", ["pipe", "gzip-file", "gzip-pipe"])
def test_iter_pcap_pipes_and_codecs(captures, tmp_path, source):
    """A pipe refills with whatever has arrived, a codec streams through
    its decompressor; both give read_pcap's packets."""
    path, _ = captures["vlan"]
    raw = path.read_bytes()
    whole = pp.read_pcap(path)
    data = gzip.compress(raw) if source.startswith("gzip") else raw
    if source == "gzip-file":
        src = tmp_path / "cap.pcap.gz"
        src.write_bytes(data)
        batches = list(pp.iter_pcap(src, batch_packets=9, read_size=333))
    else:
        r, w = os.pipe()

        def writer():
            with os.fdopen(w, "wb") as f:
                for i in range(0, len(data), 1000):
                    f.write(data[i : i + 1000])
                    f.flush()

        t = threading.Thread(target=writer)
        t.start()
        with os.fdopen(r, "rb") as f:
            batches = list(pp.iter_pcap(f, batch_packets=9, read_size=333))
        t.join(timeout=30)
        assert not t.is_alive()
    assert sum(b.num_packets for b in batches) == whole.num_packets
    i = 0
    for b in batches:
        for k in range(b.num_packets):
            assert np.array_equal(b.packet(k), whole.packet(i + k))
        i += b.num_packets


@pytest.mark.parametrize("copy", [True, False])
def test_slice_pcap_equals_jax(captures, copy):
    path, _ = captures["vlan"]
    full_p, full_j = pp.read_pcap(path), jp.read_pcap(path)
    for start, stop in ((0, 5), (3, 11), (10, 3), (-4, 2), (full_p.num_packets - 2, 10**6)):
        g = pp.slice_pcap(full_p, start, stop, copy=copy)
        w = jp.slice_pcap(full_j, start, stop, copy=copy)
        for field in ("offsets", "caplens", "origlens", "ts_sec", "ts_frac", "buf"):
            assert np.array_equal(getattr(g, field), getattr(w, field)), field
        assert (g.linktype, g.snaplen, g.nanos) == (w.linktype, w.snaplen, w.nanos)


@pytest.mark.parametrize("ipv6", [False, True])
@pytest.mark.parametrize("name", sorted(CAPTURES))
def test_flow_header_reads_equal_jax(captures, native_mode, name, ipv6):
    path, dec = captures[name]
    vlan = dec.get("vlan", False)
    pcap_p, pcap_j = pp.read_pcap(path), jp.read_pcap(path)
    for g, w in zip(pf._flow_geom(pcap_p, ipv6, vlan), jf._flow_geom(pcap_j, ipv6, vlan)):
        assert np.array_equal(g, w)
    got = pf.flow_keys(pcap_p, "tcp", ipv6=ipv6, vlan=vlan)
    want = jf.flow_keys(pcap_j, "tcp", ipv6=ipv6, vlan=vlan)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    valid = got[0]
    assert np.array_equal(pf.tcp_seqs(pcap_p, valid, ipv6=ipv6, vlan=vlan),
                          jf.tcp_seqs(pcap_j, valid, ipv6=ipv6, vlan=vlan))
    assert np.array_equal(pf.tcp_flags(pcap_p, ipv6=ipv6, vlan=vlan),
                          jf.tcp_flags(pcap_j, ipv6=ipv6, vlan=vlan))
    for k in got[1][valid]:
        assert pf.key_tuple_bytes(k) == jf.key_tuple_bytes(k)
        assert pf.key_tuple_bytes(k.tobytes()) == jf.key_tuple_bytes(k)


def _assert_batches_equal(g, w):
    for field in ("payloads", "lengths", "keys", "segments", "flow_of_packet",
                  "seg_packets", "seg_starts", "seg_bounds"):
        a, b = getattr(g, field), getattr(w, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (g.num_packets, g.num_flows) == (w.num_packets, w.num_flows)


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("name", sorted(CAPTURES))
def test_extract_flows_equals_jax(captures, native_mode, name, reorder):
    path, dec = captures[name]
    kw = dict(dec, reorder=reorder)
    for mode in ("tcp", "udp"):
        if reorder and mode == "udp":
            with pytest.raises(ValueError, match="TCP"):
                pf.extract_flows(pp.read_pcap(path), mode, **kw)
            continue
        g = pf.extract_flows(pp.read_pcap(path), mode, **kw)
        w = jf.extract_flows(jp.read_pcap(path), mode, **kw)
        _assert_batches_equal(g, w)
        for f in range(g.num_flows):
            assert g.stream(f) == w.stream(f)
            assert g.key_tuple(f) == w.key_tuple(f)
            lo, hi = g.seg_bounds[f], g.seg_bounds[f + 1]
            for off in (0, int(g.lengths[f]) - 1):
                if hi > lo:
                    assert g.packet_of_offset(f, off) == w.packet_of_offset(f, off)


def test_extract_flows_recovers_true_streams(captures):
    """Sequence order with first-bytes-win gives back each flow's stream
    exactly; capture order does not (the knobs scramble it)."""
    flows, _, _ = CAPTURES["reorder-retransmit-overlap"]
    path, _ = captures["reorder-retransmit-overlap"]
    fb = pf.extract_flows(pp.read_pcap(path), "tcp", reorder=True)
    assert {fb.key_tuple(f): fb.stream(f) for f in range(fb.num_flows)} == dict(flows)
    plain = pf.extract_flows(pp.read_pcap(path), "tcp")
    assert {plain.key_tuple(f): plain.stream(f) for f in range(plain.num_flows)} != dict(flows)


def test_extract_flows_native_scatter_equals_python(captures, monkeypatch):
    path, dec = captures["v6-mixed"]
    native = pf.extract_flows(pp.read_pcap(path), "tcp", **dec)
    monkeypatch.setattr(pt_native, "available", lambda: False)
    _assert_batches_equal(pf.extract_flows(pp.read_pcap(path), "tcp", **dec), native)
    with pytest.raises(ValueError, match="C-contiguous"):
        pt_native.scatter_segments(np.zeros(4, np.uint8), [0], [1], [0], [0],
                                   np.zeros((2, 4), np.int64))


def test_truncated_tcp_header(tmp_path):
    path = tmp_path / "trunc.pcap"
    _truncated_capture(path)
    g = pf.extract_flows(pp.read_pcap(path), "tcp")
    w = jf.extract_flows(jp.read_pcap(path), "tcp")
    _assert_batches_equal(g, w)
    # The cut header makes its packet no flow segment; the cut payload
    # gives its captured bytes only.
    assert g.num_flows == 1 and g.stream(0) == b"abcSIGNASIGNA"
    assert g.flow_of_packet.tolist() == [0, -1, 0]
    _assert_batches_equal(pf.extract_flows(pp.read_pcap(path), "tcp", reorder=True),
                          jf.extract_flows(jp.read_pcap(path), "tcp", reorder=True))


def test_extract_flows_without_flows(tmp_path):
    path = tmp_path / "noise.pcap"
    pt_synth.synth_tcp_flows_pcap(path, [], noise_packets=6, seed=3)
    g = pf.extract_flows(pp.read_pcap(path), "tcp")
    _assert_batches_equal(g, jf.extract_flows(jp.read_pcap(path), "tcp"))
    assert g.num_flows == 0 and g.num_packets == 6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reorder_plan_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 200
    f = np.sort(rng.integers(0, 6, size=n))[rng.permutation(n)].astype(np.int64)
    seq = (rng.integers(0, 3000, size=n) + (2**32 - 1500) * (f % 2)) % 2**32  # wraps for odd flows
    ln = rng.integers(1, 80, size=n).astype(np.int64)
    for g, w in zip(pf.reorder_plan(f, seq, ln), jf.reorder_plan(f, seq, ln)):
        assert np.array_equal(g, w)
    empty = pf.reorder_plan(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert all(a.size == 0 for a in empty)
    with pytest.raises(ValueError, match="2 GiB"):
        pf.reorder_plan(np.array([0, 0]), np.array([0, 2**31 - 10]), np.array([5, 20]))


def test_compile_timeout_raises_naming_the_command(tmp_path, monkeypatch):
    """A stuck compiler raises instead of hanging its caller (the native
    ingest here; the CUDA kernels on the card take the same path)."""
    src = tmp_path / "slow.cpp"
    src.write_text("template <int N> struct F { enum { v = F<N - 1>::v + F<N - 2>::v }; };\n"
                   "template <> struct F<1> { enum { v = 1 }; };\n"
                   "template <> struct F<0> { enum { v = 0 }; };\n"
                   "int x = F<30>::v;\n")
    monkeypatch.setattr(_build, "COMPILE_TIMEOUT_S", 1e-3)
    with pytest.raises(RuntimeError, match="g\\+\\+ .* timed out"):
        _build.compile_to(["g++", "-O2", "-shared", "-fPIC"], [src], tmp_path / "libslow.so")
    assert not list(tmp_path.glob(".libslow*"))


@pytest.mark.parametrize("trailer", [True, False], ids=["padded", "unpadded"])
def test_a_frame_trailer_is_no_stream_byte(tmp_path, trailer):
    """A flow payload ends at the IP total length: the zeros that pad a
    short frame to 60 bytes stay out of the port's stream.  The JAX package
    runs the payload to the wire length (a difference on purpose); without
    a trailer the two are equal."""
    key = ("10.1.0.1", "10.1.0.2", 5555, 80)
    frames = [pt_synth._eth_ipv4_tcp(b"SIG", key, 100), pt_synth._eth_ipv4_tcp(b"NAL", key, 103)]
    if trailer:
        frames = [fr + bytes(60 - len(fr)) for fr in frames]
    path = tmp_path / "trailer.pcap"
    with open(path, "wb") as f:
        f.write(pp.classic_global_header())
        for i, fr in enumerate(frames):
            f.write(struct.pack("<IIII", i, 0, len(fr), len(fr)))
            f.write(fr)
    g = pf.extract_flows(pp.read_pcap(path), "tcp")
    w = jf.extract_flows(jp.read_pcap(path), "tcp")
    assert g.stream(0) == b"SIGNAL"
    if trailer:
        assert w.stream(0) == b"SIG\x00\x00\x00NAL\x00\x00\x00"
    else:
        _assert_batches_equal(g, w)
