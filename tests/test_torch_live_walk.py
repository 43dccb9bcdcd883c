"""The live feed's one native header walk (``io/live_walk.walk``) against
the two numpy walks it replaces: ``extract_payloads(..., keep_invalid=True)``
masked by ``bpf_protocol_mask`` (the spec, left as it was), in udp and tcp
mode, with the capture filter on and off:

- seeded fuzzed Ethernet captures: frames cut below 14, 24 and 34 B,
  caplen below origlen, IHL below and above 5, origlens shorter than the
  headers, ARP, IPv4 ICMP, IPv6 UDP and TCP, IPv6 fragments (next header
  44) with each inner protocol, random bytes; walked whole and as views of
  the whole buffer, as ``FileReplaySource`` hands them over;
- each kind of frame alone, and an empty slice;
- the feed: other linktypes and ``MSM_NO_NATIVE=1`` take the old path
  (``LIVE["walked"]`` stays), ``run_live`` counts equal the benchmark's
  plain reference on both paths, and ``live --dump-matches`` writes the
  same bytes and prints the same lines on both.

Rows are compared up to each length, with every byte past it zero;
lengths (int32) and source indices exactly.  The file imports no JAX.
"""

import pathlib
import struct

import numpy as np
import pytest
import torch

from gpubench.gen.inputs import load_rules
from gpubench.gen.synth import classic_global_header
from gpubench.reference.udp_packets import capture_counts
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io import live_walk, native
from multithreading_string_matching_tpu_torch.io.decode import bpf_protocol_mask, extract_payloads
from multithreading_string_matching_tpu_torch.io.pcap import PcapFile
from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu_torch.parallel import stream as pt_stream

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RULES = ROOT / "gpubench" / "gen" / "strings_standin.txt"
PATTERNS = load_rules({"rules": {"file": "gpubench/gen/strings_standin.txt"}}, ROOT)
MODES = ["udp", "tcp"]
FILTERS = pytest.mark.parametrize("bpf_filter", [True, False], ids=["filter", "no-filter"])


# -- frames ------------------------------------------------------------------


def eth(ethertype: int, body: bytes) -> bytes:
    return bytes(range(12)) + struct.pack(">H", ethertype) + body


def ipv4(proto: int, body: bytes, ihl: int = 5) -> bytes:
    """An IPv4 header whose IHL nibble is ``ihl``, with ``ihl - 5`` words of
    options when above 5 (and the 20 bytes whatever the nibble says)."""
    hdr = bytearray(20 + max(ihl - 5, 0) * 4)
    hdr[0] = 0x40 | (ihl & 0x0F)
    hdr[2:4] = (len(hdr) + len(body)).to_bytes(2, "big")
    hdr[8], hdr[9] = 64, proto
    return bytes(hdr) + body


def ipv6(next_hdr: int, body: bytes) -> bytes:
    hdr = bytearray(40)
    hdr[0] = 0x60
    hdr[4:6] = len(body).to_bytes(2, "big")
    hdr[6], hdr[7] = next_hdr, 64
    return bytes(hdr) + body


def fragment(inner: int, body: bytes) -> bytes:
    """An IPv6 fragment header (next header 44) in front of ``inner``."""
    return ipv6(44, bytes([inner, 0, 0, 1, 0, 0, 0, 7]) + body)


def udp(payload: bytes) -> bytes:
    return struct.pack(">HHHH", 5353, 53, 8 + len(payload), 0) + payload


def tcp(payload: bytes, doff: int = 5) -> bytes:
    hdr = bytearray(max(doff, 5) * 4)
    hdr[0:4] = struct.pack(">HH", 40000, 80)
    hdr[12] = (doff & 0x0F) << 4
    return bytes(hdr) + payload


ARP = eth(0x0806, struct.pack(">HHBBH6s4s6s4s", 1, 0x0800, 6, 4, 1, bytes(6), bytes(4),
                              bytes(6), bytes(4)) + bytes(18))


def kinds(payload: bytes):
    """Every kind of frame the fuzz draws from, as ``(name, frame)``."""
    return [
        ("udp4", eth(0x0800, ipv4(17, udp(payload)))),
        ("tcp4", eth(0x0800, ipv4(6, tcp(payload)))),
        ("udp4 ihl 6", eth(0x0800, ipv4(17, udp(payload), ihl=6))),
        ("udp4 ihl 4", eth(0x0800, ipv4(17, udp(payload), ihl=4))),
        ("udp4 ihl 15", eth(0x0800, ipv4(17, udp(payload), ihl=15))),
        ("tcp4 ihl 7 doff 8", eth(0x0800, ipv4(6, tcp(payload, doff=8), ihl=7))),
        ("tcp4 doff 3", eth(0x0800, ipv4(6, tcp(payload, doff=3)))),
        ("icmp4", eth(0x0800, ipv4(1, payload))),
        ("udp6", eth(0x86DD, ipv6(17, udp(payload)))),
        ("tcp6", eth(0x86DD, ipv6(6, tcp(payload)))),
        ("udp6 fragment", eth(0x86DD, fragment(17, udp(payload)))),
        ("tcp6 fragment", eth(0x86DD, fragment(6, tcp(payload)))),
        ("icmp6 fragment", eth(0x86DD, fragment(58, payload))),
        ("arp", ARP),
        ("vlan udp4", eth(0x8100, b"\x00\x05\x08\x00" + ipv4(17, udp(payload)))),
        ("noise", bytes((7 * i + 3) % 256 for i in range(60 + len(payload)))),
    ]


def pcap_of(records, linktype: int = 1) -> PcapFile:
    """A capture of ``(frame, caplen, origlen)`` records: the buffer holds
    each frame's first ``caplen`` bytes, as the parser leaves it."""
    buf = b"".join(fr[:cap] for fr, cap, _ in records)
    caps = np.array([cap for _, cap, _ in records], np.int64)
    offsets = np.cumsum(caps) - caps
    z = np.zeros(len(records), np.int64)
    return PcapFile(buf=np.frombuffer(buf, np.uint8), offsets=offsets, caplens=caps,
                    origlens=np.array([o for _, _, o in records], np.int64), ts_sec=z,
                    ts_frac=z, linktype=linktype, snaplen=65535, nanos=False)


def view(pcap: PcapFile, start: int, stop: int) -> PcapFile:
    """Frames ``[start, stop)`` over the whole buffer (a replay's slice)."""
    cols = {f: getattr(pcap, f)[start:stop]
            for f in ("offsets", "caplens", "origlens", "ts_sec", "ts_frac")}
    return PcapFile(buf=pcap.buf, linktype=pcap.linktype, snaplen=pcap.snaplen,
                    nanos=pcap.nanos, **cols)


def fuzzed(seed: int, n: int = 400):
    """``n`` records of random kinds, payloads of 0-300 B, and cuts: below
    14, 24 or 34 B, a snap below the wire length, an origlen that lies
    short of the headers or of the payload, or none."""
    rng = np.random.default_rng(seed)
    records = []
    for _ in range(n):
        payload = rng.integers(0, 256, int(rng.integers(0, 300))).astype(np.uint8).tobytes()
        ks = kinds(payload)
        fr = ks[int(rng.integers(len(ks)))][1]
        full = len(fr)
        cut = int(rng.integers(8))
        if cut == 0:
            cap = int(rng.integers(0, 14))
        elif cut == 1:
            cap = int(rng.integers(14, 24))
        elif cut == 2:
            cap = int(rng.integers(24, 34))
        elif cut == 3:
            cap = int(rng.integers(34, full + 1)) if full > 34 else full
        else:
            cap = full
        cap = min(cap, full)
        lie = int(rng.integers(6))
        if lie == 0:
            orig = int(rng.integers(0, 46))          # short of the headers
        elif lie == 1:
            orig = int(rng.integers(0, full + 1))    # short of the payload
        elif lie == 2:
            orig = full + int(rng.integers(1, 500))  # a snapped frame
        else:
            orig = full
        records.append((fr, cap, orig))
    return records


# -- the two walks -------------------------------------------------------------


def reference(pcap: PcapFile, mode: str, bpf_filter: bool):
    """The live feed's rows as the numpy walks give them."""
    batch = extract_payloads(pcap, mode, keep_invalid=True)
    n = pcap.num_packets
    payloads, lengths, src_idx = batch.payloads[:n], batch.lengths[:n], np.arange(n)
    if bpf_filter:
        mask = bpf_protocol_mask(pcap, mode)
        payloads, lengths, src_idx = payloads[mask], lengths[mask], src_idx[mask]
    return payloads, lengths, src_idx


def assert_same_rows(pcap: PcapFile, mode: str, bpf_filter: bool):
    want_p, want_l, want_i = reference(pcap, mode, bpf_filter)
    got_p, got_l, got_i = live_walk.walk(pcap, mode, bpf_filter)
    assert got_l.dtype == np.int32 and got_i.dtype == np.int64 and got_p.dtype == np.uint8
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_i, want_i)
    assert got_p.flags.c_contiguous and got_p.shape[0] == want_p.shape[0]
    assert got_p.shape[1] == max(int(want_l.max()) if want_l.size else 0, 1)
    for r, ln in enumerate(want_l.tolist()):
        np.testing.assert_array_equal(got_p[r, :ln], want_p[r, :ln])
        assert not got_p[r, ln:].any()
    if not bpf_filter:
        # Every frame kept: the width is today's too, byte for byte.
        np.testing.assert_array_equal(got_p, want_p)
    return want_l, want_i


@pytest.fixture(autouse=True)
def _walk_lib():
    if not live_walk.applies(pcap_of([(ARP, len(ARP), len(ARP))])):
        pytest.fail("the walk's library did not build: g++ must be on the PATH")


@FILTERS
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1, 2, 2**31 + 27])
def test_fuzzed_captures_walk_as_the_numpy_walks(seed, mode, bpf_filter):
    pcap = pcap_of(fuzzed(seed))
    lengths, src_idx = assert_same_rows(pcap, mode, bpf_filter)
    # The draw reaches every outcome: rows with payloads, zero-length rows,
    # and (behind the filter) frames dropped.
    assert (lengths > 0).sum() >= 10 and (lengths == 0).sum() >= 10
    assert (src_idx.size < pcap.num_packets) == bpf_filter
    rng = np.random.default_rng(seed)
    start = 0
    while start < pcap.num_packets:
        stop = start + int(rng.integers(1, 18))
        assert_same_rows(view(pcap, start, stop), mode, bpf_filter)
        start = stop


KIND_NAMES = [name for name, _ in kinds(b"")]


@FILTERS
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KIND_NAMES)
def test_each_kind_of_frame_walks_as_the_numpy_walks(kind, mode, bpf_filter):
    """Each kind alone, whole, cut at 13, 23 and 33 B, snapped short of its
    wire length, and with an origlen short of its headers."""
    fr = dict(kinds(b"GET /youtube ubuntu id"))[kind]
    records = [(fr, len(fr), len(fr))]
    records += [(fr, cut, len(fr)) for cut in (13, 23, 33) if cut < len(fr)]
    records += [(fr, len(fr) - 5, len(fr) + 40), (fr, len(fr), 30)]
    assert_same_rows(pcap_of(records), mode, bpf_filter)


@FILTERS
@pytest.mark.parametrize("mode", MODES)
def test_an_empty_slice_walks_to_no_rows(mode, bpf_filter):
    pcap = view(pcap_of(fuzzed(3, 20)), 5, 5)
    payloads, lengths, src_idx = live_walk.walk(pcap, mode, bpf_filter)
    assert payloads.shape == (0, 1) and lengths.size == src_idx.size == 0
    assert_same_rows(pcap, mode, bpf_filter)
    assert_same_rows(pcap_of([]), mode, bpf_filter)


def test_a_dropped_frame_does_not_widen_the_rows():
    """The width is the longest passed payload: a longer frame the filter
    drops leaves it alone (the numpy walks kept its width).  The long frame
    is untagged IPv4 UDP behind a VLAN ethertype: it decodes, and the
    filter drops it."""
    short = eth(0x0800, ipv4(17, udp(b"ubuntu")))
    long = eth(0x8100, ipv4(17, udp(b"x" * 500)))
    pcap = pcap_of([(fr, len(fr), len(fr)) for fr in (short, long, short)])
    payloads, lengths, src_idx = live_walk.walk(pcap, "udp", True)
    assert payloads.shape == (2, 6) and lengths.tolist() == [6, 6]
    assert src_idx.tolist() == [0, 2]
    assert reference(pcap, "udp", True)[0].shape[1] == 500
    with pytest.raises(ValueError):
        live_walk.walk(pcap, "icmp", True)


# -- the feed on both paths ------------------------------------------------------


def records_of(path):
    """The frames of a classic capture, in order."""
    data = pathlib.Path(path).read_bytes()
    out, pos = [], 24
    while pos < len(data):
        incl = struct.unpack_from("<I", data, pos + 8)[0]
        out.append(data[pos + 16 : pos + 16 + incl])
        pos += 16 + incl
    return out


def write_frames(path, frames, linktype: int = 1):
    with open(path, "wb") as f:
        f.write(classic_global_header(linktype))
        for i, fr in enumerate(frames):
            f.write(struct.pack("<IIII", i, 0, len(fr), len(fr)) + fr)
    return path


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """A UDP capture with planted rules, and the same frames with TCP,
    ARP, IPv6 and runt frames between them."""
    d = tmp_path_factory.mktemp("live_walk")
    udp_path = d / "udp.pcap"
    synth_udp_pcap(udp_path, 600, payload_len=120, payload_len_jitter=100, patterns=PATTERNS,
                   plant_rate=0.6, seed=11)
    frames = records_of(udp_path)
    mixed = []
    for i, fr in enumerate(frames):
        mixed.append(fr)
        p = PATTERNS[i % len(PATTERNS)]
        if i % 3 == 0:
            mixed.append(eth(0x0800, ipv4(6, tcp(b"x" + p + b" youtube"))))
        if i % 5 == 0:
            mixed.append(ARP)
        if i % 7 == 0:
            mixed.append(eth(0x86DD, ipv6(6, tcp(p * 3))))
        if i % 11 == 0:
            mixed.append(fr[:20])
    return {"udp": udp_path, "mixed": write_frames(d / "mixed.pcap", mixed),
            "raw": write_frames(d / "raw.pcap", [fr[14:] for fr in frames], linktype=101),
            "n_udp": len(frames), "n_mixed": len(mixed), "dir": d}


def without_native(monkeypatch):
    """``MSM_NO_NATIVE=1`` for both native libraries, as a new process
    would read it."""
    monkeypatch.setenv("MSM_NO_NATIVE", "1")
    for mod in (live_walk, native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)


def live_pass(path, mode="udp", batch=10):
    """``run_live`` over ``path``: counts, packets seen, and what ``LIVE``
    counted."""
    before = dict(pt_stream.LIVE)
    sm = pt_stream.StreamMatcher(Matcher(PATTERNS, engine="pallas", device="cpu"),
                                 batch_size=batch, tile_rows=64, pack_width=512)
    pt_stream.run_live(sm, str(path), mode)
    fed = {k: pt_stream.LIVE[k] - before[k] for k in before}
    return sm.counts(), sm.packets_seen, fed


@pytest.mark.parametrize("path", ["walk", "no-native"])
def test_run_live_counts_equal_the_reference_on_both_paths(captures, monkeypatch, path):
    if path == "no-native":
        without_native(monkeypatch)
    want = capture_counts(captures["udp"], PATTERNS, "udp")[0]
    counts, seen, fed = live_pass(captures["mixed"])
    np.testing.assert_array_equal(counts, want)
    assert want.sum() > 300
    feeds = -(-captures["n_mixed"] // 10)
    # The capture filter passes the UDP frames and the cut ones (a runt of
    # 20 B has no protocol byte: it is dropped).
    assert seen == fed["passed"] == captures["n_udp"]
    assert fed["batches"] == feeds and fed["frames"] == captures["n_mixed"]
    assert fed["walked"] == (feeds if path == "walk" else 0)


@pytest.mark.parametrize("linktype", [101, 113, 0], ids=["raw-ip", "sll", "null"])
def test_other_linktypes_take_the_numpy_walks(captures, tmp_path, linktype):
    """Raw IP, Linux cooked and BSD loopback captures keep the old path: no
    feed is walked, and the counts equal the Ethernet capture's."""
    frames = [fr[14:] for fr in records_of(captures["udp"])]
    if linktype == 113:
        frames = [bytes(14) + b"\x08\x00" + fr for fr in frames]
    elif linktype == 0:
        frames = [struct.pack("<I", 2) + fr for fr in frames]
    path = write_frames(tmp_path / "cap.pcap", frames, linktype=linktype)
    counts, seen, fed = live_pass(path, batch=7)
    np.testing.assert_array_equal(counts, capture_counts(captures["udp"], PATTERNS, "udp")[0])
    assert seen == captures["n_udp"] and fed["walked"] == 0
    assert fed["batches"] == -(-captures["n_udp"] // 7)


@pytest.mark.parametrize("env", [{}, {"MSM_STREAM_PACKED": "0"}], ids=["packed", "unpacked"])
@pytest.mark.parametrize("mode", MODES)
def test_live_dump_matches_is_byte_equal_on_both_paths(captures, tmp_path, capsys, monkeypatch,
                                                      mode, env):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outs, walked = {}, {}
    for path in ("walk", "no-native"):
        if path == "no-native":
            without_native(monkeypatch)
        dump = tmp_path / f"{path}.pcap"
        before = pt_stream.LIVE["walked"]
        assert pt_main(["live", str(captures["mixed"]), str(RULES), mode,
                        "--dump-matches", str(dump)]) == 0
        walked[path] = pt_stream.LIVE["walked"] - before
        cap = capsys.readouterr()
        outs[path] = (cap.out, cap.err.replace(str(dump), "DUMP"))
    assert walked["walk"] > 0 and walked["no-native"] == 0
    assert outs["walk"] == outs["no-native"] and " packet sniffed\n" in outs["walk"][0]
    got = (tmp_path / "walk.pcap").read_bytes()
    assert got == (tmp_path / "no-native.pcap").read_bytes()
    assert len(records_of(tmp_path / "walk.pcap")) > 20
