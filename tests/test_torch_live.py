"""The live path of the torch package against the JAX package's: the
capture filter (``bpf_protocol_program``, ``bpf_simulate``,
``bpf_protocol_mask``), ``FileReplaySource`` batches, and ``StreamMatcher``
on packed, unpacked, NUL-set, long-payload (window and ac), table-route,
case-folded and sharded feeds, its dump, its reload and its int32 drains;
then ``LiveSource`` over loopback (recv loop and TPACKET_V3 ring), skipped
exactly where the JAX package's tests skip (no raw sockets).

Inputs are made from seeds; counts, bytes and packet numbers are compared
exactly.  Every loopback test stops its source from a timer, so a quiet
interface cannot hang it.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.io import decode as jax_decode
from multithreading_string_matching_tpu.io import live as jax_live
from multithreading_string_matching_tpu.io.pcap import PcapFile as JaxPcapFile
from multithreading_string_matching_tpu.io.pcap import PcapWriter as JaxWriter
from multithreading_string_matching_tpu.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu.parallel import pipeline as jax_pipeline
from multithreading_string_matching_tpu.parallel.stream import StreamMatcher as JaxStream
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io import decode, live
from multithreading_string_matching_tpu_torch.io.pcap import PcapFile, PcapWriter
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.parallel import pipeline
from multithreading_string_matching_tpu_torch.parallel.stream import StreamMatcher

torch.set_num_threads(1)

STANDIN = load_patterns(
    __import__("pathlib").Path(__file__).resolve().parent.parent
    / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt")
NUL_SET = STANDIN[:20] + [b"a\x00b", b"\x00\x00"]


# -- the capture filter ---------------------------------------------------


def _ip4(proto, payload=b""):
    return struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + len(payload), 0, 0, 64, proto, 0,
                       b"\x01\x02\x03\x04", b"\x05\x06\x07\x08") + payload


def _ip6(proto, payload=b"", frag_next=None):
    if frag_next is not None:
        payload = struct.pack(">BBHI", frag_next, 0, 0, 7) + payload
        proto = 44
    return struct.pack(">IHBB16s16s", 0x6 << 28, len(payload), proto, 64,
                       b"\x00" * 16, b"\x00" * 16) + payload


def _eth(ip, ethertype):
    return b"\xaa" * 12 + struct.pack(">H", ethertype) + ip


# (name, ip bytes or None for a non-IP frame, ethertype)
IPS = [
    ("udp4", _ip4(17, b"\x00" * 16), 0x0800),
    ("tcp4", _ip4(6, b"\x00" * 28), 0x0800),
    ("icmp4", _ip4(1, b"\x00" * 8), 0x0800),
    ("udp6", _ip6(17, b"\x00" * 16), 0x86DD),
    ("tcp6", _ip6(6, b"\x00" * 28), 0x86DD),
    ("udp6 fragment", _ip6(None, b"\x00" * 16, frag_next=17), 0x86DD),
    ("tcp6 fragment", _ip6(None, b"\x00" * 28, frag_next=6), 0x86DD),
    ("truncated v4", _ip4(17)[:9], 0x0800),
    ("arp", b"\x00" * 28, 0x0806),
]


def _frames(linktype):
    """The crafted packets for one linktype, and whether each is IP at all."""
    out = []
    for _, ip, et in IPS:
        if linktype == 1:
            out.append(_eth(ip, et))
        elif linktype == 113:  # Linux cooked v1: ethertype at 14
            out.append(b"\x00" * 14 + struct.pack(">H", et) + ip)
        elif linktype == 0:  # BSD loopback: 4-byte family word
            fam = {0x0800: 2, 0x86DD: 30}.get(et, 99)
            out.append(struct.pack("<I", fam) + ip)
        else:  # raw IP
            out.append(ip)
    out.append(b"\xaa" * 13)  # a runt
    return out


def _pcap(cls, frames, linktype=1):
    lens = np.array([len(f) for f in frames], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return cls(buf=np.frombuffer(b"".join(frames), np.uint8).copy(), offsets=offs, caplens=lens,
               origlens=lens.copy(), ts_sec=np.zeros(len(frames), np.int64),
               ts_frac=np.zeros(len(frames), np.int64), linktype=linktype, snaplen=65535,
               nanos=False)


@pytest.mark.parametrize("mode", ["udp", "tcp"])
def test_bpf_program_and_simulator_equal_jax(mode):
    prog = live.bpf_protocol_program(mode)
    assert prog == jax_live.bpf_protocol_program(mode)
    for f in _frames(1):
        assert live.bpf_simulate(prog, f) == jax_live.bpf_simulate(prog, f)
    with pytest.raises(KeyError):
        live.bpf_protocol_program("icmp")


@pytest.mark.parametrize("linktype", [1, 101, 0, 113])
@pytest.mark.parametrize("mode", ["udp", "tcp"])
def test_bpf_protocol_mask_equals_jax(linktype, mode):
    frames = _frames(linktype)
    got = decode.bpf_protocol_mask(_pcap(PcapFile, frames, linktype), mode)
    want = jax_decode.bpf_protocol_mask(_pcap(JaxPcapFile, frames, linktype), mode)
    assert got.dtype == bool and np.array_equal(got, want)
    assert got.sum() == 3  # the protocol over v4, over v6 and in a v6 fragment
    if linktype == 1:  # the mask is the kernel program's verdict
        prog = live.bpf_protocol_program(mode)
        assert got.tolist() == [live.bpf_simulate(prog, f) > 0 for f in frames]


# -- FileReplaySource and StreamMatcher -----------------------------------


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_live")
    short, long_, nul = d / "short.pcap", d / "long.pcap", d / "nul.pcap"
    synth_udp_pcap(short, 420, payload_len=160, payload_len_jitter=150, patterns=STANDIN,
                   plant_rate=0.5, invalid_rate=0.05, seed=3)
    synth_udp_pcap(long_, 24, payload_len=5000, payload_len_jitter=900, patterns=STANDIN,
                   plant_rate=1.0, seed=4)
    synth_udp_pcap(nul, 200, payload_len=120, payload_len_jitter=100, patterns=NUL_SET,
                   plant_rate=0.6, seed=5)
    return {"short": short, "long": long_, "nul": nul}


@pytest.mark.parametrize("batch", [10, 7])
def test_file_replay_batches_equal_jax(caps, batch):
    got = list(live.FileReplaySource(caps["short"], batch_size=batch))
    want = list(jax_live.FileReplaySource(caps["short"], batch_size=batch))
    assert len(got) == len(want) == -(-420 // batch)
    for g, w in zip(got, want):
        for f in ("offsets", "caplens", "origlens", "ts_sec", "ts_frac"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
        assert np.array_equal(g.buf, w.buf)
        assert (g.linktype, g.snaplen, g.nanos) == (w.linktype, w.snaplen, w.nanos)


# name: (capture, patterns, matcher kw, stream kw, mode, bpf_filter, env)
FEEDS = {
    "packed": ("short", STANDIN, {}, {}, "udp", True, {}),
    "packed small tiles": ("short", STANDIN, {}, dict(tile_rows=16), "udp", True, {}),
    "packed tcp unfiltered": ("short", STANDIN, {}, {}, "tcp", False, {}),
    "unpacked": ("short", STANDIN, {}, dict(packed=False), "udp", True, {}),
    "unpacked ac": ("short", STANDIN, {}, dict(packed=False, engine="ac"), "udp", True, {}),
    "nul set": ("nul", NUL_SET, {}, {}, "udp", True, {}),
    "nul set ac": ("nul", NUL_SET, {}, dict(engine="ac"), "udp", True, {}),
    "long window": ("long", STANDIN, {}, dict(packed=False), "udp", True, {}),
    "long ac": ("long", STANDIN, {}, dict(packed=False, engine="ac"), "udp", True, {}),
    "long packed": ("long", STANDIN, {}, {}, "udp", True, {}),
    "long narrow window": ("short", STANDIN, {}, dict(packed=False, fixed_len=64), "udp", True,
                           {}),
    "table route packed": ("short", STANDIN, {}, {}, "udp", True, {"MSM_PALLAS_TABLE": "1"}),
    "table route unpacked": ("short", STANDIN, {}, dict(packed=False), "udp", True,
                             {"MSM_PALLAS_TABLE": "1"}),
    "nocase": ("short", STANDIN, dict(case_insensitive=True), {}, "udp", True, {}),
    "matcher engine ac": ("short", STANDIN, dict(engine="ac"), {}, "udp", True, {}),
    "sharded": ("short", STANDIN, {}, dict(sharded=True), "udp", True, {}),
}


def _run_feeds(caps, name, monkeypatch, tmp_path=None, dump=False):
    cap, pats, mkw, skw, mode, bpf, env = FEEDS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = []
    for tag, M, S, Src, W in (("pt", Matcher, StreamMatcher, live.FileReplaySource, PcapWriter),
                              ("jax", JaxMatcher, JaxStream, jax_live.FileReplaySource,
                               JaxWriter)):
        kw = dict(mkw, device="cpu") if tag == "pt" else mkw
        writer = W(tmp_path / f"{tag}.pcap") if dump else None
        s = S(M(pats, **kw), dump_writer=writer, **skw)
        for b in Src(caps[cap]):
            s.feed_pcap_slice(b, mode, bpf_filter=bpf)
        s.flush()
        if writer is not None:
            writer.close()
        out.append(s)
    return out


@pytest.mark.parametrize("name", list(FEEDS))
def test_stream_matcher_equals_jax(caps, monkeypatch, name):
    got, want = _run_feeds(caps, name, monkeypatch)
    c = got.counts()
    assert c.dtype == np.int32 and c.tolist() == want.counts().tolist()
    assert c.sum() > 0
    assert got.packets_seen == want.packets_seen > 0
    assert got.tiles_dispatched == want.tiles_dispatched
    assert (got.tiles_dispatched > 0) == (got._tiles is not None and name != "long packed")


@pytest.mark.parametrize("name", ["packed", "nul set", "long ac"])
def test_stream_dump_bytes_equal_jax(caps, monkeypatch, tmp_path, name):
    got, want = _run_feeds(caps, name, monkeypatch, tmp_path, dump=True)
    pt, jx = (tmp_path / "pt.pcap").read_bytes(), (tmp_path / "jax.pcap").read_bytes()
    assert pt == jx and len(pt) > 24


def test_stream_refusals_equal_jax():
    cases = [
        (lambda M, S, kw: S(M(NUL_SET, **kw), packed=True)),
        (lambda M, S, kw: S(M(STANDIN, **kw), engine="kmp")),
        (lambda M, S, kw: S(M(STANDIN, **kw), mesh=object())),
        (lambda M, S, kw: S(M(STANDIN, **kw), sharded=True, packed=False)),
        (lambda M, S, kw: S(M(NUL_SET, **kw), sharded=True)),
    ]
    for make in cases:
        with pytest.raises(ValueError) as got:
            make(Matcher, StreamMatcher, {"device": "cpu"})
        with pytest.raises(ValueError) as want:
            make(JaxMatcher, JaxStream, {})
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("packed", ["auto", False])
def test_reload_equals_jax_and_bad_reload_keeps_stream(caps, packed):
    set_a, set_b = STANDIN[:30], STANDIN[30:] + [b"zz"]
    outs = []
    for M, S, Src, kw in ((Matcher, StreamMatcher, live.FileReplaySource, {"device": "cpu"}),
                          (JaxMatcher, JaxStream, jax_live.FileReplaySource, {})):
        s = S(M(set_a, **kw), packed=packed)
        batches = list(Src(caps["short"]))
        for b in batches[:20]:
            s.feed_pcap_slice(b, "udp", bpf_filter=True)
        first = s.counts()
        prev = s.reload(M(set_b, **kw))
        for b in batches[20:30]:
            s.feed_pcap_slice(b, "udp", bpf_filter=True)
        mid = s.counts()
        # A reload that breaks the rules (NUL patterns under packed=True)
        # raises before anything changes.
        s2 = S(M(set_a, **kw), packed=True)
        for b in batches[:10]:
            s2.feed_pcap_slice(b, "udp")
        with pytest.raises(ValueError, match="NUL-free"):
            s2.reload(M(NUL_SET, **kw))
        for b in batches[10:]:  # the stream is untouched and usable
            s2.feed_pcap_slice(b, "udp")
        outs.append((first, prev, mid, s.counts(), s.packets_seen, s2.counts()))
    got, want = outs
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert np.array_equal(got[0], got[1]) and got[1].sum() > 0 and got[2].sum() > 0


def test_int32_drains_equal_jax(caps, monkeypatch):
    """Tiny drain thresholds: every feed drains the device accumulator into
    the host int64 base; the totals stay the JAX package's."""
    monkeypatch.setattr(pipeline, "DRAIN_POSITIONS", 1000)
    monkeypatch.setattr(jax_pipeline, "DRAIN_POSITIONS", 1000)
    for skw in (dict(packed=False), dict(packed=False, engine="ac"), dict(tile_rows=8)):
        got = StreamMatcher(Matcher(STANDIN, device="cpu"), **skw)
        want = JaxStream(JaxMatcher(STANDIN), **skw)
        for s, Src in ((got, live.FileReplaySource), (want, jax_live.FileReplaySource)):
            for b in Src(caps["short"]):
                s.feed_pcap_slice(b, "udp")
        assert got.counts().tolist() == want.counts().tolist()
        drained = got._host_counts if got._tiles is None else got._tiles._host_total
        assert drained is not None and drained.dtype == np.int64


def test_checkpoint_helpers_equal_jax(tmp_path):
    from multithreading_string_matching_tpu.parallel import stream as jax_stream
    from multithreading_string_matching_tpu_torch.parallel import stream

    pats = [b"ab\x00", b"x", b"\x00\x00", b"long pattern"]
    assert {k: v.tolist() for k, v in stream.patterns_npz_fields(pats).items()} == {
        k: v.tolist() for k, v in jax_stream.patterns_npz_fields(pats).items()}
    np.savez(tmp_path / "p", **stream.patterns_npz_fields(pats))
    assert stream.checkpoint_path(tmp_path / "p") == jax_stream.checkpoint_path(tmp_path / "p")
    data = np.load(stream.checkpoint_path(tmp_path / "p"))
    assert stream.patterns_from_npz(data) == jax_stream.patterns_from_npz(data) == pats


# -- LiveSource over loopback ---------------------------------------------


def _can_raw_socket() -> bool:
    try:
        s = socket.socket(socket.AF_PACKET, socket.SOCK_RAW, socket.htons(0x0003))
        s.close()
        return True
    except (PermissionError, OSError, AttributeError):
        return False


raw = pytest.mark.skipif(not _can_raw_socket(), reason="AF_PACKET raw sockets unavailable")


def _send_udp(port, payload, n, source, tcp_noise=False):
    """Send ``n`` datagrams to localhost after a short delay (optionally a
    TCP exchange first), then stop ``source`` half a second later: a quiet
    interface yields no batch, so the stop must not wait for one."""

    def sender():
        time.sleep(0.3)  # let the capture socket open first
        if tcp_noise:
            srv = socket.socket()
            srv.bind(("127.0.0.1", 0))
            srv.listen(1)
            cli = socket.socket()
            cli.connect(srv.getsockname())
            conn, _ = srv.accept()
            cli.sendall(b"tcp noise dropped in the kernel")
            conn.recv(64)
            cli.close(); conn.close(); srv.close()
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for _ in range(n):
            tx.sendto(payload, ("127.0.0.1", port))
            time.sleep(0.01)
        tx.close()
        time.sleep(0.5)
        source.stop()

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    return t


def _drive(source, fn):
    """Iterate ``source`` under a 15 s watchdog, calling ``fn`` per batch."""
    watchdog = threading.Timer(15.0, source.stop)
    watchdog.start()
    try:
        for batch in source:
            fn(batch)
    finally:
        watchdog.cancel()


@raw
@pytest.mark.parametrize("ring", [False, True])
def test_live_loopback_counts(ring):
    """Datagrams sent to 127.0.0.1 while capturing on lo: decoded and
    counted by the port's StreamMatcher (loopback may deliver a frame
    twice, so counts are lower bounds)."""
    stream = StreamMatcher(Matcher([b"needle", b"hay"], device="cpu"), batch_size=4)
    source = live.LiveSource("lo", batch_size=4, timeout_s=0.2, ring=ring)
    n = 12
    t = _send_udp(19989, b"xx needle yy hay needle zz", n, source)
    batches = []

    def feed(batch):
        batches.append(batch)
        stream.feed_pcap_slice(batch, "udp")

    _drive(source, feed)
    t.join(timeout=5)
    counts = stream.counts()
    assert counts[0] >= 2 * n and counts[1] >= n, counts
    assert source._sock is None and source._ring_map is None  # closed clean
    if ring:
        assert all(b.nanos for b in batches)  # kernel nanosecond timestamps
        assert all(np.all(b.origlens >= b.caplens) for b in batches)


@raw
@pytest.mark.parametrize("ring", [False, True])
def test_kernel_filter_drops_tcp_before_userspace(ring):
    source = live.LiveSource("lo", batch_size=4, timeout_s=0.2, filter_mode="udp", ring=ring,
                             promiscuous=not ring)
    t = _send_udp(19988, b"udp marker frame", 6, source, tcp_noise=True)
    seen = []

    def check(batch):
        assert decode.bpf_protocol_mask(batch, "udp").all(), "a non-UDP frame passed the filter"
        seen.append(batch.num_packets)

    _drive(source, check)
    t.join(timeout=5)
    assert sum(seen) >= 6
    assert source._sock is None and not source._promisc_on


class _FakeRing(bytearray):
    def close(self):
        pass


def _fake_ring_source(snaplen=65535):
    """A LiveSource over an in-memory ring: the block walk without a kernel."""
    source = live.LiveSource("lo", snaplen=snaplen, timeout_s=0.05, ring=True)
    source._ring_map = _FakeRing(live._RING_BLOCK_SIZE * live._RING_BLOCK_NR)
    a, b = socket.socketpair()
    source._sock = a
    return source, b


def _write_fake_block(mm, blk, frames):
    struct.pack_into("<I", mm, blk + live._BD_STATUS, live.TP_STATUS_USER)
    first = 48
    struct.pack_into("<II", mm, blk + live._BD_NUM_PKTS, len(frames), first)
    off, mac = blk + first, 64
    for frame, tp_len in frames:
        nxt = mac + len(frame) + (-(mac + len(frame)) % 16)
        struct.pack_into(live._T3_FIXED, mm, off, nxt, 1_700_000_000, 42, len(frame), tp_len, 0,
                         mac, mac + 14)
        mm[off + mac : off + mac + len(frame)] = frame
        off += nxt


def test_ring_block_walk_truncates_to_snaplen():
    source, peer = _fake_ring_source(snaplen=64)
    try:
        frame = bytes(range(256)) * 4
        _write_fake_block(source._ring_map, 0, [(frame, 1024), (b"tiny", 4)])
        batch = source._read_block(0)
    finally:
        source._sock.close()
        peer.close()
    assert batch.caplens.tolist() == [64, 4] and batch.origlens.tolist() == [1024, 4]
    assert bytes(batch.buf[:64]) == frame[:64] and batch.nanos
    assert (batch.ts_sec.tolist(), batch.ts_frac.tolist()) == ([1_700_000_000] * 2, [42, 42])


def test_ring_stop_drain_is_one_pass():
    """The stop drain ends after one ring pass even when every returned
    block is refilled at once (sustained traffic)."""
    source, peer = _fake_ring_source()
    mm = source._ring_map
    for i in range(live._RING_BLOCK_NR):
        _write_fake_block(mm, i * live._RING_BLOCK_SIZE, [(b"x" * 60, 60)])
    reads = []
    real = live.LiveSource._read_block

    def refilling(self, blk):
        if len(reads) > 4 * live._RING_BLOCK_NR:
            raise AssertionError("drain did not end after one ring pass")
        reads.append(blk)
        batch = real(self, blk)
        _write_fake_block(mm, blk, [(b"x" * 60, 60)])
        return batch

    source._read_block = refilling.__get__(source)
    source.stopped = True
    try:
        batches = list(source._iter_ring())
    finally:
        peer.close()
    assert len(reads) == len(batches) == live._RING_BLOCK_NR
    assert source._ring_map is None and source._sock is None
