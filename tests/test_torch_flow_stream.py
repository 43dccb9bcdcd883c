"""The torch package's streamed flow path against the JAX package's: the
window count's ``min_end``/``min_start`` masks, ``window_stream_chunk``,
the halo kernel's plain version (against the interpret-mode Pallas halo
kernel), the ragged sub-lane layout of a round (against a flat padded
round built in the test, and no larger than the JAX package's padded tile), and ``FlowStreamMatcher`` with
the window engine, also against the concatenated-flow oracle.

Inputs are made from seeds with numpy; every comparison is exact (integer
counts and bytes: tolerance 0).  The halo kernel itself needs a card:
tests/test_torch_kernels.py.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import count_overlapping
from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.io.pcap import read_pcap as jax_read
from multithreading_string_matching_tpu.io.pcap import slice_pcap as jax_slice
from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap
from multithreading_string_matching_tpu.ops.pallas_window import PallasWindowMatcher
from multithreading_string_matching_tpu.ops.window import StreamHalo as JaxHalo
from multithreading_string_matching_tpu.ops.window import WindowProgram as JaxProgram
from multithreading_string_matching_tpu.ops.window import _window_one
from multithreading_string_matching_tpu.ops.window import window_stream_chunk as jax_chunk
from multithreading_string_matching_tpu.parallel.flow_stream import (
    FlowStreamMatcher as JaxFlowStream,
)
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.flows import extract_flows
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
from multithreading_string_matching_tpu_torch.ops.window import (
    StreamHalo,
    WindowProgram,
    window_count,
    window_count_halo_plain,
    window_stream_chunk,
)
from multithreading_string_matching_tpu_torch.parallel import flow_stream
from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher, _pow2

torch.set_num_threads(1)

PATS = [b"SIGNATURE", b"zz", b"pp", b"abcab", b"ATU", b"SIGNATURE", b"a\x00b"]
NUL_PATS = [b"a\x00b", b"\x00c", b"ca", b"\x00\x01\x01", b"\x00\x00\x01\x02"]
ALPHABET = np.frombuffer(b"abcpzSIGNATURE\x00", np.uint8)


def _flows(seed, n, lo=200, hi=1500, v6_every=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pay = bytearray(ALPHABET[rng.integers(0, len(ALPHABET), size=int(rng.integers(lo, hi)))])
        for _ in range(3):
            o = int(rng.integers(0, len(pay) - 9))
            pay[o : o + 9] = b"SIGNATURE"
        if v6_every and i % v6_every == 0:
            key = (f"2001:db8::{i + 1:x}", "2001:db8::ff", 3000 + i, 443)
        else:
            key = (f"10.0.0.{i + 1}", "10.9.0.1", 1000 + i, 80)
        out.append((key, bytes(pay)))
    return out


# name: (flows, synth kwargs, stream kwargs)
CAPTURES = {
    "v4": (_flows(1, 10), dict(segment_len=53, interleave_seed=3, noise_packets=6, seed=1), {}),
    "reorder": (_flows(2, 6), dict(segment_len=41, interleave_seed=4, reorder_seed=5,
                                   retransmit_rate=0.15, overlap_rate=0.15, seed=2),
                dict(reorder=True)),
    "ipv6": (_flows(3, 6, v6_every=2), dict(segment_len=61, interleave_seed=5, seed=3),
             dict(ipv6=True)),
    "vlan": (_flows(4, 6), dict(segment_len=47, interleave_seed=6, vlan_rate=0.5, seed=4),
             dict(vlan=True)),
}


def _with_fin(src, dst, every: int):
    """Copy a capture, setting FIN on every ``every``-th TCP frame."""
    raw = bytearray(src.read_bytes())
    pos, i = 24, 0
    while pos + 16 <= len(raw):
        incl = struct.unpack_from("<I", raw, pos + 8)[0]
        pkt = pos + 16
        if raw[pkt + 12 : pkt + 14] == b"\x08\x00" and raw[pkt + 23] == 6 and i % every == 0:
            raw[pkt + 14 + 20 + 13] |= 0x01
        i += 1
        pos = pkt + incl
    dst.write_bytes(bytes(raw))


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_flow_stream")
    out = {}
    for name, (flows, kw, _) in CAPTURES.items():
        out[name] = d / f"{name}.pcap"
        synth_tcp_flows_pcap(out[name], flows, **kw)
    out["fin"] = d / "fin.pcap"
    _with_fin(out["v4"], out["fin"], 9)
    return out


def _oracle(path, pats, **kw):
    fb = extract_flows(read_pcap(path), "tcp", reorder=kw.get("reorder", False),
                       ipv6=kw.get("ipv6", False), vlan=kw.get("vlan", False))
    return [sum(count_overlapping(fb.stream(f), p) for f in range(fb.num_flows)) for p in pats]


def _feed(fs, pcap, step, slicer):
    for s in range(0, pcap.num_packets, step):
        fs.feed_pcap_slice(slicer(pcap, s, s + step, copy=False))
    fs.flush()
    return fs.counts()


def _run_both(path, pats, step=7, *, nocase=False, budget=None, monkeypatch=None, **kw):
    """JAX stream counts and the port's, for the port matcher engines
    ``pallas`` (the halo kernel's plain version) and ``window`` (the
    kernel's plain form), both over the round's ragged sub-lanes."""
    if budget is not None:
        monkeypatch.setattr(JaxFlowStream, "ROUND_BUDGET_BYTES", budget)
        monkeypatch.setattr(FlowStreamMatcher, "ROUND_BUDGET_BYTES", budget)
    jfs = JaxFlowStream(JaxMatcher(pats, engine="window", case_insensitive=nocase), "tcp",
                        engine="window", **kw)
    want = _feed(jfs, jax_read(path), step, jax_slice)
    got = {}
    for eng in ("pallas", "window"):
        fs = FlowStreamMatcher(Matcher(pats, engine=eng, case_insensitive=nocase, device="cpu"),
                               "tcp", engine="window", **kw)
        got[eng] = _feed(fs, read_pcap(path), step, slice_pcap)
        assert (fs.flows_seen, fs.packets_seen, fs.bytes_seen, fs.flows_evicted) == (
            jfs.flows_seen, jfs.packets_seen, jfs.bytes_seen, jfs.flows_evicted)
        assert got[eng].dtype == np.int64
    return want, got


# name: (capture, stream kwargs, feed step)
STREAMS = {
    "small-rounds": ("v4", dict(scan_bytes=256, width=16, min_lanes=4), 5),
    "one-round": ("v4", dict(scan_bytes=1 << 30), 1000),
    "narrow-width": ("v4", dict(scan_bytes=900, width=8, min_lanes=8), 11),
    "wide-width": ("v4", dict(scan_bytes=4000, width=1024, min_lanes=2), 13),
    # The reorder window is one round: small rounds see the JAX package's
    # counts, not the oracle's (a documented reference behaviour).
    "reorder": ("reorder", dict(scan_bytes=300, width=32, min_lanes=4, reorder=True), 6),
    "reorder-one-round": ("reorder", dict(scan_bytes=1 << 30, width=32, min_lanes=4,
                                          reorder=True), 6),
    "ipv6": ("ipv6", dict(scan_bytes=500, width=64, min_lanes=4, ipv6=True), 9),
    "vlan": ("vlan", dict(scan_bytes=500, width=64, min_lanes=4, vlan=True), 9),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_flow_stream_equals_jax_and_oracle(captures, name):
    cap, kw, step = STREAMS[name]
    want, got = _run_both(captures[cap], PATS, step, **kw)
    for eng, counts in got.items():
        assert counts.tolist() == want.tolist(), eng
    oracle = _oracle(captures[cap], PATS, **kw)
    assert sum(oracle) > 0
    if name != "reorder":
        assert want.tolist() == oracle


@pytest.mark.parametrize("policy", [dict(max_flows=2), dict(idle_rounds=1), dict(fin_evict=True),
                                    dict(max_flows=3, idle_rounds=2, fin_evict=True)])
def test_eviction_equals_jax(captures, policy):
    want, got = _run_both(captures["fin"], PATS, 5, scan_bytes=300, width=32, min_lanes=4,
                          **policy)
    for counts in got.values():
        assert counts.tolist() == want.tolist()


def test_eviction_forgets_state_only(captures):
    """An evicted flow loses its tail (a match across the eviction is
    missed), never counted bytes: counts stay at or below the oracle."""
    fs = FlowStreamMatcher(Matcher(PATS, device="cpu"), "tcp", engine="window",
                           scan_bytes=300, width=32, min_lanes=4, fin_evict=True)
    got = _feed(fs, read_pcap(captures["fin"]), 5, slice_pcap)
    assert fs.flows_evicted > 0
    assert all(g <= w for g, w in zip(got.tolist(), _oracle(captures["fin"], PATS)))
    fs.evict([b"\x00" * 12])  # unknown keys are ignored


def test_skew_fallback_equals_jax(captures, monkeypatch):
    """A budget of one byte: each ragged row is a launch of its own (the
    JAX package's round runs its chunk loop)."""
    want, got = _run_both(captures["v4"], PATS, 17, budget=1, monkeypatch=monkeypatch,
                          scan_bytes=700, width=16, min_lanes=4)
    assert want.tolist() == _oracle(captures["v4"], PATS)
    for counts in got.values():
        assert counts.tolist() == want.tolist()


def test_window_matcher_rounds_split_over_ragged_slices(captures, monkeypatch):
    """A ``window`` matcher's round takes the ragged sub-lanes too: past a
    budget of a few rows it splits them over several launches
    (``msm.flow.dispatch`` spans), each an exact slice of whole ``H +
    width`` rows, and the counts stay the oracle's."""
    matcher = Matcher(PATS, engine="window", device="cpu")
    row = max(int(matcher.window.max_len) - 1, 1) + 16
    monkeypatch.setattr(FlowStreamMatcher, "ROUND_BUDGET_BYTES", 3 * row)
    names, real_span = [], flow_stream.span

    def recording(name):
        names.append(name)
        return real_span(name)

    monkeypatch.setattr(flow_stream, "span", recording)
    before = flow_stream.FLOWS["tile_bytes"]
    fs = FlowStreamMatcher(matcher, "tcp", engine="window", scan_bytes=5000, width=16,
                           min_lanes=4)
    assert _feed(fs, read_pcap(captures["v4"]), 40, slice_pcap).tolist() == _oracle(
        captures["v4"], PATS)
    assert names.count("msm.flow.dispatch") > fs._round > 0
    tile_bytes = flow_stream.FLOWS["tile_bytes"] - before
    assert tile_bytes > 0 and tile_bytes % row == 0


def test_forced_drain_equals_oracle(captures):
    fs = FlowStreamMatcher(Matcher(PATS, device="cpu"), "tcp", engine="window",
                           scan_bytes=256, width=16, min_lanes=4)
    drains = []
    orig = fs._acc_device

    def acc(counts, *, positions):
        orig(counts, positions=positions)
        drains.append(fs._dev_counts is not None)
        fs._drain_device()  # drain every round

    fs._acc_device = acc
    assert _feed(fs, read_pcap(captures["v4"]), 5, slice_pcap).tolist() == _oracle(
        captures["v4"], PATS)
    assert len(drains) > 3 and all(drains) and fs._dev_counts is None


def test_nocase_and_nul_across_rounds(tmp_path):
    """The fabricated-zeros boundary and fold idempotence (tails are stored
    raw and folded at round time)."""
    key_a = ("10.0.0.1", "10.0.0.2", 1111, 80)
    key_b = ("10.0.0.3", "10.0.0.2", 2222, 80)
    p1, p2 = tmp_path / "s1.pcap", tmp_path / "s2.pcap"
    synth_tcp_flows_pcap(p1, [(key_a, b"xxE\x00", [4])])
    synth_tcp_flows_pcap(p2, [(key_a, b"Fyy", [3]), (key_b, b"qAb", [3])])
    pats = [b"E\x00F", b"ab"]
    jfs = JaxFlowStream(JaxMatcher(pats, engine="window", case_insensitive=True), "tcp",
                        engine="window", scan_bytes=1, width=4, min_lanes=4)
    for eng in ("pallas", "window"):
        fs = FlowStreamMatcher(Matcher(pats, engine=eng, case_insensitive=True, device="cpu"),
                               "tcp", engine="window", scan_bytes=1, width=4, min_lanes=4)
        for f in (fs, jfs) if eng == "pallas" else (fs,):
            rd = read_pcap if f is fs else jax_read
            f.feed_pcap_slice(rd(p1))
            f.flush()
            f.feed_pcap_slice(rd(p2))
            f.flush()
        assert fs.counts().tolist() == jfs.counts().tolist() == [1, 1], eng


@pytest.mark.parametrize("nocase", [False, True])
def test_nul_patterns_stream_equals_jax(captures, nocase):
    want, got = _run_both(captures["v4"], NUL_PATS + [b"\x00\x00"], 7, nocase=nocase,
                          scan_bytes=200, width=8, min_lanes=4)
    for counts in got.values():
        assert counts.tolist() == want.tolist()


def test_reload_equals_jax(captures):
    """Counts before the swap come back; tails carry over trimmed to the
    new halo; counts after equal the JAX stream's."""
    new_pats = [b"SIG", b"NATURE", b"zzz"]
    pcap_j, pcap_p = jax_read(captures["v4"]), read_pcap(captures["v4"])
    half = pcap_p.num_packets // 2
    kw = dict(scan_bytes=300, width=16, min_lanes=4)
    jfs = JaxFlowStream(JaxMatcher(PATS, engine="window"), "tcp", engine="window", **kw)
    jfs.feed_pcap_slice(jax_slice(pcap_j, 0, half))
    jfirst = jfs.reload(JaxMatcher(new_pats, engine="window"))
    jfs.feed_pcap_slice(jax_slice(pcap_j, half, 10**9))
    jfs.flush()
    for eng in ("pallas", "window"):
        fs = FlowStreamMatcher(Matcher(PATS, engine=eng, device="cpu"), "tcp",
                               engine="window", **kw)
        fs.feed_pcap_slice(slice_pcap(pcap_p, 0, half))
        first = fs.reload(Matcher(new_pats, engine=eng, device="cpu"))
        assert first.tolist() == jfirst.tolist()
        assert all(len(t) == f <= 5 for t, f in fs._states.values())
        fs.feed_pcap_slice(slice_pcap(pcap_p, half, 10**9))
        fs.flush()
        assert fs.counts().tolist() == jfs.counts().tolist()
        assert len(fs.counts()) == len(new_pats)


def test_unported_options_raise(captures, tmp_path):
    m = Matcher(PATS, device="cpu")
    pcap_p, pcap_j = read_pcap(captures["v4"]), jax_read(captures["v4"])
    # The AC engine (the JAX default), once refused here, unsharded and with
    # sharded lanes, counts what the JAX package's does.
    for kw in (dict(), dict(sharded=True)):
        got, want = FlowStreamMatcher(m, "tcp", scan_bytes=64, **kw), JaxFlowStream(
            JaxMatcher(PATS), "tcp", scan_bytes=64, **kw)
        assert got.engine == "ac"
        _feed(got, pcap_p, 5, slice_pcap)
        _feed(want, pcap_j, 5, jax_slice)
        got.flush()
        want.flush()
        assert got.counts().tolist() == want.counts().tolist() and got.counts().sum() > 0
    # collect_offsets (once refused here) drains what the JAX package's does;
    # the AC engine with it is refused with the JAX package's ValueError.
    drained = []
    for fs_cls, mm, pc, slicer in ((FlowStreamMatcher, m, pcap_p, slice_pcap),
                                   (JaxFlowStream, JaxMatcher(PATS), pcap_j, jax_slice)):
        fs = fs_cls(mm, "tcp", engine="window", collect_offsets=True, scan_bytes=64)
        _feed(fs, pc, 5, slicer)
        drained.append([(bytes(k), int(o), int(u)) for k, o, u in fs.drain_offsets()])
        with pytest.raises(ValueError, match="collect_offsets=True needs engine='window'"):
            fs_cls(mm, "tcp", engine="ac", collect_offsets=True)
    assert drained[0] == drained[1] and len(drained[0]) > 0
    # Checkpoints (once refused here) resume to the uninterrupted counts;
    # tests/test_torch_checkpoint.py holds them against the JAX package.
    half = pcap_p.num_packets // 2
    fs = FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=64)
    for s in range(0, half, 5):
        fs.feed_pcap_slice(slice_pcap(pcap_p, s, min(s + 5, half), copy=False))
    resumed = FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=64)
    resumed.load(fs.save(tmp_path / "fs"))
    for s in range(half, pcap_p.num_packets, 5):
        resumed.feed_pcap_slice(slice_pcap(pcap_p, s, s + 5, copy=False))
    resumed.flush()
    whole = _feed(FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=64), pcap_p, 5,
                  slice_pcap)
    assert resumed.counts().tolist() == whole.tolist() and whole.sum() > 0
    for kw in (dict(engine="kmp"), dict(mode="icmp"), dict(mesh=object()),
               dict(reorder=True, mode="udp"), dict(fin_evict=True, mode="udp"),
               dict(max_flows=0)):
        args = {"engine": "window", "mode": "tcp", **kw}
        with pytest.raises(ValueError):
            FlowStreamMatcher(m, args.pop("mode"), **args)


# -- the halo algebra ------------------------------------------------------


def _lanes(seed, F, C, H, alphabet=b"abc\x00"):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    rel = rng.integers(-3, C + 5, size=F).astype(np.int32)
    fill = rng.integers(0, H + 1, size=F).astype(np.int32)
    buf = letters[rng.integers(0, len(letters), size=(F, C))]
    buf = np.where(np.arange(C)[None, :] < rel[:, None], buf, 0).astype(np.uint8)
    halo = np.zeros((F, H), np.uint8)
    for i in range(F):
        if fill[i]:
            halo[i, H - fill[i] :] = letters[rng.integers(0, len(letters), size=fill[i])]
    return buf, rel, halo, fill


@pytest.mark.parametrize("pats", [PATS, NUL_PATS], ids=["nul-free-ish", "nul"])
@pytest.mark.parametrize("min_end", [0, 3, 9])
def test_window_count_masks_equal_jax(pats, min_end):
    rng = np.random.default_rng(min_end)
    payloads = np.frombuffer(b"abcSIGNATURE\x00zp", np.uint8)[rng.integers(0, 15, size=(9, 40))]
    lengths = rng.integers(0, 41, size=9).astype(np.int32)
    jw = JaxProgram.build(pats)
    words, masks, lens = WindowProgram.build(pats).tables("cpu")
    for ms in (0, 4, rng.integers(0, 12, size=9).astype(np.int32)):
        jms = jnp.asarray(ms).reshape(1, -1, 1) if np.ndim(ms) else ms
        for per_packet in (False, True):
            want = np.asarray(_window_one(
                jnp.asarray(jw.pat_words), jnp.asarray(jw.pat_masks), jnp.asarray(jw.pat_lens),
                jnp.asarray(payloads), jnp.asarray(lengths), per_packet,
                min_end=min_end, min_start=jms))
            got = window_count(words, masks, lens, torch.from_numpy(payloads),
                               torch.from_numpy(lengths), per_packet, min_end=min_end,
                               min_start=torch.from_numpy(np.asarray(ms)) if np.ndim(ms) else ms)
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("pats", [[b"\x00\x01\x01", b"\x00\x00\x01\x02"], [b"\x00\x00a"],
                                  [b"ab", b"aba", b"b", b"abab", b"ca", b"abcdefgh", b"\x00ab"]])
def test_window_stream_chunk_equals_jax(pats, chunk):
    rng = np.random.default_rng(chunk)
    payloads = rng.integers(0, 3, size=(6, 40)).astype(np.uint8)
    payloads[0, :6] = [1, 0, 1, 1, 7, 7]
    payloads[1, :3] = [97, 0, 0]
    lengths = rng.integers(0, 41, size=6).astype(np.int32)
    jw, pw = JaxProgram.build(pats), WindowProgram.build(pats)
    jh = ph = None
    total = np.zeros(len(pats), np.int64)
    for start in range(0, 40, chunk):
        c = payloads[:, start : start + chunk]
        rel = (lengths - start).astype(np.int32)
        jc, jh = jax_chunk(jw, c, rel, jh)
        pc, ph = window_stream_chunk(pw, c, rel, ph)
        assert np.array_equal(pc.numpy(), np.asarray(jc))
        assert np.array_equal(ph.data.numpy(), np.asarray(jh.data))
        assert np.array_equal(ph.fill.numpy(), np.asarray(jh.fill))
        total += pc.numpy()
    want = [sum(count_overlapping(payloads[r, : lengths[r]].tobytes(), p) for r in range(6))
            for p in pats]
    assert total.tolist() == want


def test_window_stream_chunk_per_lane_fill_and_raw_halo():
    pats = [b"a\x00b", b"\x00c", b"ca"]
    jw, pw = JaxProgram.build(pats), WindowProgram.build(pats)
    buf, rel, halo, fill = _lanes(5, 12, 16, 2)
    jc, jh = jax_chunk(jw, buf, rel, JaxHalo(jnp.asarray(halo), jnp.asarray(fill)),
                       expand_duplicates=False)
    pc, ph = window_stream_chunk(pw, buf, rel, StreamHalo(torch.from_numpy(halo),
                                                          torch.from_numpy(fill)),
                                 expand_duplicates=False)
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    assert np.array_equal(ph.fill.numpy(), np.asarray(jh.fill))
    jc, _ = jax_chunk(jw, buf, rel, halo)  # a bare array: every halo byte real
    pc, ph = window_stream_chunk(pw, buf, rel, halo)
    assert np.array_equal(pc.numpy(), np.asarray(jc)) and int(ph.fill) == 2


@pytest.mark.parametrize("pats", [[b"ab", b"bca", b"aaaa", b"abcab"], [b"a\x00b", b"\x00c", b"ca"],
                                  [b"rs%04d" % i for i in range(40)]], ids=["plain", "nul", "rs40"])
def test_halo_plain_equals_pallas_interpret(pats):
    """The halo kernel's plain version (and the CPU route of its wrapper)
    against the interpret-mode Pallas halo kernel, on random lanes with
    random halo fills and pending lengths."""
    wp, jw = WindowProgram.build(pats), JaxProgram.build(pats)
    pm = PallasWindowMatcher(jw, row_tile=8, interpret=True, assume_zero_padded=True)
    cm = cw.CudaWindowMatcher(wp, "cpu")
    H = pm.halo_width
    assert cm.halo_width == H
    for trial in range(3):
        buf, rel, halo, fill = _lanes(trial, 16, 64, H, alphabet=b"abcrs0123\x00")
        rel = np.clip(rel, 0, None)
        x = np.concatenate([halo, buf], axis=1)
        eff = np.minimum(rel.astype(np.int64) + H, x.shape[1]).astype(np.int32)
        ms = (H - fill).astype(np.int32)
        want = np.asarray(pm.count_tile_halo(x, eff, ms))
        words, masks, lens = wp.tables("cpu")
        tx, te, tm = (torch.from_numpy(a) for a in (x, eff, ms))
        before = dict(cw.LAUNCHES)
        assert np.array_equal(window_count_halo_plain(tx, te, tm, H, (words, masks, lens)).numpy(),
                              want)
        assert np.array_equal(cw.window_count_halo(tx, te, tm, words, masks, lens, H).numpy(),
                              want)
        assert np.array_equal(cm.count_tile_halo(x, eff, ms).numpy(), want)
        assert cw.LAUNCHES == before  # the plain version is not a launch


def _round(fs, rng, H, alphabet=b"abc\x00"):
    """A random round on ``fs``: 1-11 flows of 1-59 pending bytes, one of
    100-399 (longer than every other), the first with an empty tail, the
    second with a tail of ``0 < fill < H`` bytes where ``H > 1``, the rest
    of any fill.  Returns ``(keys, lens)``."""
    letters = np.frombuffer(alphabet, np.uint8)
    n = int(rng.integers(1, 12))
    lens = rng.integers(1, 60, size=n)
    lens[int(rng.integers(n))] = rng.integers(100, 400)
    fills = rng.integers(0, H + 1, size=n)
    fills[0] = 0
    if n > 1 and H > 1:
        fills[1] = int(rng.integers(1, H))
    fs._states, fs._pending = {}, {}
    keys = [struct.pack(">I", i) * 3 for i in range(n)]
    for k, ln, fl in zip(keys, lens, fills):
        fs._pending[k] = bytearray(letters[rng.integers(0, len(letters), size=int(ln))])
        if fl:
            fs._states[k] = (letters[rng.integers(0, len(letters), size=int(fl))].tobytes(),
                             int(fl))
    return keys, lens.astype(np.int64)


@pytest.mark.parametrize("width", [16, 5])
@pytest.mark.parametrize("pats", [PATS, [b"ab"], NUL_PATS], ids=["pats", "ab", "nul"])
def test_ragged_round_equals_the_flat_round(pats, width):
    """A round's ragged sub-lanes (each flow its own ``ceil(n / width)``
    rows), counted by the halo kernel's plain version, equal
    ``window_stream_chunk`` over the round as one flat padded buffer, the
    test's own reference built here (the matcher has no such round); the
    ragged tile is
    no larger than the JAX package's padded sub-lane tile of the same
    round (``_expand_round_lanes``); and a budget of a few rows splits the
    rows over several slices that together are the same tile."""
    rng = np.random.default_rng(91 + width + len(pats))
    fs = FlowStreamMatcher(Matcher(pats, device="cpu"), "tcp", engine="window", width=width,
                           min_lanes=8)
    jfs = JaxFlowStream(JaxMatcher(pats, engine="window"), "tcp", engine="window", width=width,
                        min_lanes=8)
    H = max(len(max(pats, key=len)) - 1, 1)
    total = 0
    for _ in range(4):
        keys, lens = _round(fs, rng, H, bytes(sorted(set(b"".join(pats)))))
        x, eff, ms = (np.concatenate(a) for a in zip(*fs._ragged_tiles(keys, lens, H)))
        assert x.shape == (int(sum(-(-lens // width))), H + width)
        # The round as the padded layout lays it out: pow2 lanes, every
        # lane as wide as the pow2 of the longest flow.
        F = _pow2(len(keys), fs.min_lanes)
        buf = np.zeros((F, max(width, 1 << (int(lens.max()) - 1).bit_length())), np.uint8)
        rel = np.zeros(F, np.int32)
        halo = np.zeros((F, H), np.uint8)
        fill = np.zeros(F, np.int32)
        for i, k in enumerate(keys):
            buf[i, : lens[i]] = np.frombuffer(fs._pending[k], np.uint8)
            rel[i] = lens[i]
            tail, fill[i] = fs._states.get(k, (b"", 0))
            halo[i, H - fill[i] :] = np.frombuffer(tail, np.uint8)
        flat, _ = window_stream_chunk(fs.matcher.window, buf, rel,
                                      StreamHalo(torch.from_numpy(halo), torch.from_numpy(fill)),
                                      expand_duplicates=False)
        sub = fs.matcher.halo_kernels.count_tile_halo(x, eff, ms)
        assert np.array_equal(sub.numpy(), flat.numpy())
        total += int(flat.sum())
        padded = jfs._expand_round_lanes(buf, rel, halo, fill, width)[0]
        assert x.nbytes <= padded.nbytes
        fs.ROUND_BUDGET_BYTES = 3 * (H + width)
        parts = list(fs._ragged_tiles(keys, lens, H))
        del fs.ROUND_BUDGET_BYTES
        assert len(parts) == -(-x.shape[0] // 3) > 1 or x.shape[0] <= 3
        for got, want in zip(zip(*parts), (x, eff, ms)):
            assert np.array_equal(np.concatenate(got), want)
    assert total > 0
