"""The DFA scan engines: the torch package's Aho-Corasick and KMP scans
(``models/``, ``ops/scan.py``) and every path they carry, against the JAX
package on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
automata are built by the JAX package and fed to the port as numpy tables
(``CompiledAC.from_numpy``).  Counts and states are integers: every
comparison is exact (tolerance 0).  Shapes stay small (N <= 64, L <= 512):
the plain versions loop over byte columns in Python.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from oracle import count_overlapping
from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.io.flows import count_flows_chunked as jax_chunked
from multithreading_string_matching_tpu.io.flows import extract_flows as jax_extract_flows
from multithreading_string_matching_tpu.io.pcap import read_pcap as jax_read
from multithreading_string_matching_tpu.io.pcap import slice_pcap as jax_slice
from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap, synth_udp_pcap
from multithreading_string_matching_tpu.models import aho_corasick as jac
from multithreading_string_matching_tpu.models import kmp as jkmp
from multithreading_string_matching_tpu.ops import scan as jscan
from multithreading_string_matching_tpu.parallel import mesh as jmesh
from multithreading_string_matching_tpu.parallel import pipeline as jpp
from multithreading_string_matching_tpu.parallel.flow_stream import (
    FlowStreamMatcher as JaxFlowStream,
)
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.flows import count_flows_chunked, extract_flows
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching_tpu_torch.models import aho_corasick as tac
from multithreading_string_matching_tpu_torch.models import kmp as tkmp
from multithreading_string_matching_tpu_torch.ops import scan as tscan
from multithreading_string_matching_tpu_torch.parallel import mesh as pmesh
from multithreading_string_matching_tpu_torch.parallel import pipeline as pp
from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher

torch.set_num_threads(1)

STANDIN_PATH = (pathlib.Path(__file__).resolve().parent.parent
                / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt")
STANDIN = load_patterns(STANDIN_PATH)
PATS = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"a\x00b", b"\x00", b"cab" * 4]
_R = np.random.default_rng(99)
SETS = {
    "small": PATS,
    "standin": STANDIN,
    "nul": [b"\x00", b"\x00\x00", b"a\x00", b"\x00a\x00", b"a"],
    "random": [bytes(_R.integers(97, 100, size=int(_R.integers(1, 9)), dtype=np.uint8))
               for _ in range(60)],
    "long": [b"x" * 300, b"xy" * 140, b"y", b"xyx"],
}


def _batch(seed, n, L, alphabet=b"abc\x00", pats=(), lo=0, hi=None):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    payloads = letters[rng.integers(0, len(letters), size=(n, L))].astype(np.uint8)
    for r in range(n):
        for p in pats[: 3]:
            if len(p) < L and rng.random() < 0.5:
                o = int(rng.integers(0, L - len(p)))
                payloads[r, o:o + len(p)] = np.frombuffer(p, np.uint8)
    lengths = rng.integers(lo, (L + 1) if hi is None else hi, size=n).astype(np.int32)
    return payloads, lengths


def _jax_cac(pats):
    ac = jac.AhoCorasick.build(pats)
    return ac, jscan.CompiledAC.from_automaton(ac)


def _port_cac(ac):
    return tscan.CompiledAC.from_numpy(ac.goto, ac.emit, ac.dup_map)


# -- the host builders -----------------------------------------------------


@pytest.mark.parametrize("name", sorted(SETS))
def test_aho_corasick_arrays_equal_jax(name):
    want = jac.AhoCorasick.build(SETS[name])
    got = tac.AhoCorasick.build(SETS[name])
    for field in ("goto", "emit", "dup_map"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.patterns == want.patterns and got.unique_patterns == want.unique_patterns
    assert np.array_equal(got.emitting_states, want.emitting_states)
    assert got.dead_state == want.dead_state and got.num_states == want.num_states
    counts = np.arange(len(got.unique_patterns))
    assert np.array_equal(got.expand_counts(counts), want.expand_counts(counts))


@pytest.mark.parametrize("name", sorted(SETS))
def test_kmp_tables_equal_jax(name):
    pats = SETS[name]
    got, want = tkmp.stack_kmp_dfas(pats), jkmp.stack_kmp_dfas(pats)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for p in pats[:8]:
        assert np.array_equal(tkmp.lps_table(p), jkmp.lps_table(p))
        assert np.array_equal(tkmp.kmp_dfa(p), jkmp.kmp_dfa(p))
        text = bytes(np.random.default_rng(len(p)).choice(list(set(p)) + [0], 200).astype(np.uint8))
        assert tkmp.count_occurrences_host(text, p) == jkmp.count_occurrences_host(text, p)


def test_builders_refuse_what_jax_refuses():
    for build in (tac.AhoCorasick.build, tkmp.stack_kmp_dfas):
        with pytest.raises(ValueError):
            build([])
    with pytest.raises(ValueError):
        tac.AhoCorasick.build([b"a", b""])
    with pytest.raises(ValueError):
        tkmp.lps_table(b"")


@pytest.mark.parametrize("name", ["small", "standin", "long"])
def test_compiled_ac_equals_jax(name):
    ac, jc = _jax_cac(SETS[name])
    c = _port_cac(ac)
    assert np.array_equal(c.goto_flat.numpy(), np.asarray(jc.goto_flat))
    assert np.array_equal(c.emit_sub.numpy(), np.asarray(jc.emit_sub))
    assert np.array_equal(c.emit_ids.numpy(), np.asarray(jc.emit_ids))
    assert (c.dead, c.num_unique) == (jc.dead, jc.num_unique)
    assert c.table.dtype == torch.int16  # uint16 states below 65,536
    assert tscan.CompiledAC.from_automaton(tac.AhoCorasick.build(SETS[name])).table.equal(c.table)


def test_compiled_tables_refuse_bad_shapes():
    ac = jac.AhoCorasick.build(PATS)
    with pytest.raises(ValueError):
        tscan.CompiledAC.from_numpy(ac.goto[:, :8], ac.emit)
    bad = ac.goto.copy()
    bad[0, 0] = bad.shape[0]
    with pytest.raises(ValueError):
        tscan.CompiledAC.from_numpy(bad, ac.emit)
    dfas, accept = jkmp.stack_kmp_dfas(PATS)
    with pytest.raises(ValueError):
        tscan.CompiledKMP.from_numpy(dfas, accept[:-1])
    with pytest.raises(ValueError):
        tscan.CompiledKMP.from_numpy(dfas, accept + 100)


def test_int32_table_above_uint16_states(monkeypatch):
    """Sets of UINT16_STATES states or more keep an int32 table; the counts
    do not change (the limit is lowered so a small set crosses it)."""
    ac, jc = _jax_cac(SETS["standin"])
    monkeypatch.setattr(tscan, "UINT16_STATES", 64)
    c = _port_cac(ac)
    assert c.table.dtype == torch.int32
    payloads, lengths = _batch(3, 24, 200, alphabet=b"LinuxAHTP \x00", pats=STANDIN)
    got = tscan.count_matches_ac(c, payloads, lengths, dup_map=ac.dup_map)
    want = np.asarray(jscan.count_matches_ac(jc, payloads, lengths, dup_map=ac.dup_map))
    assert np.array_equal(got.numpy(), want)


# -- count_matches_ac / count_matches_kmp ----------------------------------


@pytest.mark.parametrize("per_packet", [False, True])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("states", ["root", "carried", "dead"])
def test_count_matches_ac_equals_jax(per_packet, dup, states):
    """Totals and rows, with and without dup_map, from the root, carried or
    dead states, over lengths <= 0 and past L."""
    ac, jc = _jax_cac(PATS)
    c = _port_cac(ac)
    payloads, lengths = _batch(11, 40, 64, pats=PATS, lo=-6, hi=90)
    init = {"root": None,
            "carried": np.random.default_rng(4).integers(0, ac.goto.shape[0], 40).astype(np.int32),
            "dead": np.full(40, ac.dead_state, np.int32)}[states]
    kw = dict(per_packet=per_packet, dup_map=ac.dup_map if dup else None, return_states=True)
    got, got_st = tscan.count_matches_ac(c, payloads, lengths, initial_states=init, **kw)
    want, want_st = jscan.count_matches_ac(jc, payloads, lengths, initial_states=init, **kw)
    assert got.dtype == torch.int32 and got_st.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_st.numpy(), np.asarray(want_st))
    if states == "dead":
        assert not got.numpy().any()
    elif states == "root":
        assert got.numpy().sum() > 20
        assert np.array_equal(tscan.count_matches_ac(c, payloads, lengths).numpy(),
                              np.asarray(jscan.count_matches_ac(jc, payloads, lengths)))


def test_ac_states_hold_past_the_length():
    """A lane past its length holds the state of its last real byte, so a
    revived lane continues exactly: two scans equal one."""
    ac, jc = _jax_cac(PATS)
    c = _port_cac(ac)
    payloads, lengths = _batch(21, 30, 48, pats=PATS, lo=0, hi=49)
    cut = np.random.default_rng(3).integers(0, 49, 30).astype(np.int32)
    first, st = tscan.count_matches_ac(c, payloads, np.minimum(cut, lengths),
                                       dup_map=ac.dup_map, return_states=True)
    _, jst = jscan.count_matches_ac(jc, payloads, np.minimum(cut, lengths), dup_map=ac.dup_map,
                                    return_states=True)
    assert np.array_equal(st.numpy(), np.asarray(jst))
    # The rest of each lane, shifted to the front of a second chunk.
    rest = np.zeros_like(payloads)
    for r in range(30):
        k = int(min(cut[r], lengths[r]))
        rest[r, : 48 - k] = payloads[r, k:]
    second = tscan.count_matches_ac(c, rest, lengths - np.minimum(cut, lengths),
                                    initial_states=st, dup_map=ac.dup_map)
    whole = tscan.count_matches_ac(c, payloads, lengths, dup_map=ac.dup_map)
    assert np.array_equal((first + second).numpy(), whole.numpy()) and whole.sum() > 10


@pytest.mark.parametrize("name", ["small", "nul", "long"])
@pytest.mark.parametrize("per_packet", [False, True])
def test_count_matches_kmp_equals_jax(name, per_packet):
    """Totals and rows over the full pattern list, duplicates included."""
    pats = SETS[name]
    dfas, accept = jkmp.stack_kmp_dfas(pats)
    payloads, lengths = _batch(7, 24, 320, alphabet=b"abcxy\x00", pats=pats, lo=-3, hi=400)
    got = tscan.count_matches_kmp(dfas, accept, payloads, lengths, per_packet=per_packet)
    want = np.asarray(jscan.count_matches_kmp(dfas, accept, payloads, lengths,
                                              per_packet=per_packet))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want) and want.sum() > 0
    compiled = tscan.CompiledKMP.from_numpy(dfas, accept)
    assert compiled.table.dtype == (torch.uint8 if dfas.shape[1] <= 256 else torch.int32)
    assert np.array_equal(tscan.count_matches_kmp(compiled, None, payloads, lengths,
                                                  per_packet=per_packet).numpy(), want)


def test_ac_equals_kmp_equals_oracle():
    ac, jc = _jax_cac(PATS)
    c = _port_cac(ac)
    dfas, accept = jkmp.stack_kmp_dfas(PATS)
    payloads, lengths = _batch(8, 16, 60, pats=PATS)
    a = tscan.count_matches_ac(c, payloads, lengths, dup_map=ac.dup_map, per_packet=True)
    k = tscan.count_matches_kmp(dfas, accept, payloads, lengths, per_packet=True)
    texts = [payloads[i, : lengths[i]].tobytes() for i in range(16)]
    want = np.array([[count_overlapping(t, p) for p in PATS] for t in texts])
    assert np.array_equal(a.numpy(), want) and np.array_equal(k.numpy(), want)


def test_wrappers_refuse_other_devices():
    ac, _ = _jax_cac(PATS)
    c = _port_cac(ac)
    meta = torch.empty((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="ac-scan"):
        tscan.ac_scan(c, meta, torch.empty(2, dtype=torch.int32, device="meta"),
                      torch.empty(2, dtype=torch.int32, device="meta"))
    dfas, accept = jkmp.stack_kmp_dfas(PATS)
    with pytest.raises(ValueError, match="kmp-scan"):
        tscan.kmp_scan(tscan.CompiledKMP.from_numpy(dfas, accept), meta,
                       torch.empty(2, dtype=torch.int32, device="meta"))


# -- the matcher --------------------------------------------------------------


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_scan") / "synth.pcap"
    synth_udp_pcap(path, 160, payload_len=200, payload_len_jitter=150, patterns=STANDIN,
                   plant_rate=0.6, invalid_rate=0.05, seed=9)
    return path


@pytest.fixture(scope="module")
def batch(capture):
    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads

    return extract_payloads(read_pcap(capture), "udp", pad_n_to=128, pad_len_to=8)


@pytest.mark.parametrize("engine", ["ac", "kmp"])
@pytest.mark.parametrize("nocase", [False, True])
@pytest.mark.parametrize("bucketed", [True, False])
def test_matcher_count_equals_jax(batch, engine, nocase, bucketed):
    m = Matcher(STANDIN, engine=engine, case_insensitive=nocase, device="cpu")
    jm = JaxMatcher(STANDIN, engine=engine, case_insensitive=nocase)
    for per_packet in (False, True):
        got = m.count(batch.payloads, batch.lengths, per_packet=per_packet, bucketed=bucketed)
        want = np.asarray(jm.count(batch.payloads, batch.lengths, per_packet=per_packet,
                                   bucketed=bucketed))
        assert got.dtype == want.dtype and np.array_equal(got, want) and got.sum() > 50


@pytest.mark.parametrize("engine", ["ac", "kmp"])
def test_count_prepared_and_count_pcap_equal_jax(capture, batch, engine):
    m, jm = Matcher(STANDIN, engine=engine, device="cpu"), JaxMatcher(STANDIN, engine=engine)
    prep, jprep = m.prepare(batch.payloads, batch.lengths), jm.prepare(batch.payloads, batch.lengths)
    assert np.array_equal(m.count_prepared(prep), np.asarray(jm.count_prepared(jprep)))
    assert np.array_equal(m.count_prepared(prep, per_packet=True),
                          np.asarray(jm.count_prepared(jprep, per_packet=True)))
    # A packed batch (NUL-free set): the DFA state resets at each 0x00.
    packed = m.prepare(batch.payloads, batch.lengths, packed=True)
    assert np.array_equal(m.count_prepared(packed), np.asarray(jm.count_prepared(jprep)))
    assert np.array_equal(m.count_pcap(capture), np.asarray(jm.count_pcap(capture)))
    t = m.count_prepared(prep, block=False)
    assert torch.is_tensor(t) and np.array_equal(t.numpy(), m.count_prepared(prep))


@pytest.mark.parametrize("engine", ["ac", "kmp"])
def test_matcher_nul_patterns_and_swap(engine):
    pats = SETS["nul"] + [b"ab"]
    payloads, lengths = _batch(5, 20, 96, pats=pats)
    m, jm = Matcher(pats, engine=engine, device="cpu"), JaxMatcher(pats, engine=engine)
    assert np.array_equal(m.count(payloads, lengths), np.asarray(jm.count(payloads, lengths)))
    m.count(payloads, lengths)  # builds the automata
    new = [b"ca", b"a\x00b", b"ca"]
    m.swap_patterns(new)
    jm.swap_patterns(new)
    assert m._ac is None and m._cac is None and m._kmp is None and m._kmp_dev is None
    for per_packet in (False, True):
        got = m.count(payloads, lengths, per_packet=per_packet)
        assert np.array_equal(got, np.asarray(jm.count(payloads, lengths, per_packet=per_packet)))
    assert m.ac.unique_patterns == (b"ca", b"a\x00b")


@pytest.mark.parametrize("chunk", [1, 5, 16, 48])
def test_count_chunk_carries_state(chunk):
    """Chunks with carried states count chunk-straddling matches once: the
    one-shot counts and the JAX package's chunked counts and states."""
    m, jm = Matcher(PATS, device="cpu"), JaxMatcher(PATS)
    payloads, lengths = _batch(5, 16, 48, pats=PATS)
    want = np.asarray(jm.count(payloads, lengths, engine="ac"))
    states, jstates = m.streaming_state(16), jm.streaming_state(16)
    total = np.zeros(len(PATS), np.int64)
    for start in range(0, 48, chunk):
        rel = np.clip(lengths - start, 0, None).astype(np.int32)
        counts, states = m.count_chunk(payloads[:, start:start + chunk], rel, states)
        jcounts, jstates = jm.count_chunk(payloads[:, start:start + chunk], rel, jstates)
        assert np.array_equal(counts, np.asarray(jcounts))
        total += counts
    assert np.array_equal(total, want) and np.array_equal(states.numpy(), np.asarray(jstates))


def test_straddling_match_counted_once():
    m = Matcher(PATS, device="cpu")
    payloads = np.frombuffer(b"cacab", np.uint8)[None, :].copy()
    lengths = np.array([5], np.int32)
    want = m.count(payloads, lengths, engine="ac")
    c1, st = m.count_chunk(payloads[:, :3], lengths, m.streaming_state(1))
    c2, _ = m.count_chunk(payloads[:, 3:], lengths - 3, st)
    assert np.array_equal(c1 + c2, want) and want[PATS.index(b"ca")] == 2
    # A tensor chunk on the matcher's device, folded for a nocase matcher.
    mc = Matcher([b"CA"], device="cpu", case_insensitive=True)
    c, _ = mc.count_chunk(torch.from_numpy(payloads), lengths, mc.streaming_state(1))
    assert c.tolist() == [2]


def test_explain_auto_routes_long_patterns_to_ac():
    """auto takes ac for a set with a pattern over 256 bytes (a library set:
    the CLI caps patterns at 99 bytes); explain()'s keys equal JAX's."""
    pats = [b"q" * 300, b"ab", b"abc"]
    m, jm = Matcher(pats, engine="auto", device="cpu"), JaxMatcher(pats, engine="auto")
    got, want = m.explain(), jm.explain()
    assert got["engine_resolved"] == want["engine_resolved"] == "ac"
    assert set(got) - {"device"} == set(want)
    assert {k: got[k] for k in want} == want
    payloads, lengths = _batch(2, 6, 400, alphabet=b"qab", lo=200)
    assert np.array_equal(m.count(payloads, lengths), np.asarray(jm.count(payloads, lengths)))


# -- flows ----------------------------------------------------------------


@pytest.fixture(scope="module")
def flow_capture(tmp_path_factory):
    """Eight TCP flows planted with PATS across 29-byte segments, reordered
    and retransmitted on the wire, plus noise packets."""
    rng = np.random.default_rng(17)
    flows = []
    for i in range(8):
        pay = bytearray(rng.choice(np.frombuffer(b"abcx", np.uint8), int(rng.integers(80, 400))))
        for _ in range(5):
            p = PATS[int(rng.integers(0, len(PATS)))]
            o = int(rng.integers(0, len(pay) - len(p)))
            pay[o:o + len(p)] = p
        flows.append(((f"10.1.0.{i + 1}", "10.2.0.1", 5000 + i, 80), bytes(pay)))
    path = tmp_path_factory.mktemp("torch_scan_flows") / "flows.pcap"
    synth_tcp_flows_pcap(path, flows, segment_len=29, interleave_seed=2, noise_packets=4,
                         reorder_seed=3, retransmit_rate=0.1, seed=4)
    return path


@pytest.mark.parametrize("width", [7, 64, 2048])
def test_count_flows_chunked_equals_jax(flow_capture, width):
    m, jm = Matcher(PATS, device="cpu"), JaxMatcher(PATS)
    fb, jfb = extract_flows(read_pcap(flow_capture), "tcp"), jax_extract_flows(
        jax_read(flow_capture), "tcp")
    got = count_flows_chunked(m, fb, chunk_width=width)
    want = jax_chunked(jm, jfb, chunk_width=width)
    assert got.dtype == np.int64 and np.array_equal(got, want) and got.sum() > 0
    assert np.array_equal(got, m.count(fb.payloads, fb.lengths))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(reorder=True),
    dict(sharded=True),
    dict(reorder=True, width=16),
    dict(nocase=True),
], ids=["plain", "reorder", "sharded-2", "reorder-narrow", "nocase"])
def test_flow_stream_ac_equals_jax(flow_capture, kw):
    """The AC flow engine with small rounds (flows revived round after round
    from their stored states) against the JAX package's."""
    kw = dict(kw)
    nocase = kw.pop("nocase", False)
    pats = [p.upper() for p in PATS] if nocase else PATS
    m = Matcher(pats, device="cpu", case_insensitive=nocase)
    jm = JaxMatcher(pats, case_insensitive=nocase)
    extra = {}
    if kw.pop("sharded", False):
        extra = dict(sharded=True)
        kw_p = dict(kw, mesh=pmesh.make_mesh(["cpu"] * 2), **extra)
        kw_j = dict(kw, mesh=jmesh.make_mesh(jax.devices("cpu")[:2]), **extra)
    else:
        kw_p = kw_j = kw
    fs = FlowStreamMatcher(m, "tcp", engine="ac", scan_bytes=200, **kw_p)
    jfs = JaxFlowStream(jm, "tcp", engine="ac", scan_bytes=200, **kw_j)
    pcap, jpcap = read_pcap(flow_capture), jax_read(flow_capture)
    for s in range(0, pcap.num_packets, 7):
        fs.feed_pcap_slice(slice_pcap(pcap, s, s + 7))
        jfs.feed_pcap_slice(jax_slice(jpcap, s, s + 7))
        assert fs._states == jfs._states
    fs.flush()
    jfs.flush()
    assert fs.counts().tolist() == jfs.counts().tolist() and fs.counts().sum() > 0
    assert fs._round > 3 and fs.flows_seen == jfs.flows_seen == 8
    assert (fs.packets_seen, fs.bytes_seen) == (jfs.packets_seen, jfs.bytes_seen)


def test_flow_stream_ac_revival_eviction_and_reload(flow_capture):
    """An evicted flow restarts at the root; a revived one goes on from its
    state; reload restarts every state at the root, as in the JAX package."""
    m, jm = Matcher(PATS, device="cpu"), JaxMatcher(PATS)
    fs = FlowStreamMatcher(m, "tcp", engine="ac", scan_bytes=150, idle_rounds=2)
    jfs = JaxFlowStream(jm, "tcp", engine="ac", scan_bytes=150, idle_rounds=2)
    pcap, jpcap = read_pcap(flow_capture), jax_read(flow_capture)
    half = pcap.num_packets // 2
    fs.feed_pcap_slice(slice_pcap(pcap, 0, half))
    jfs.feed_pcap_slice(jax_slice(jpcap, 0, half))
    fs.evict(list(fs._states)[:2])
    jfs.evict(list(jfs._states)[:2])
    new = [b"ab", b"xa"]
    assert fs.reload(Matcher(new, device="cpu")).tolist() == jfs.reload(JaxMatcher(new)).tolist()
    assert set(fs._states.values()) == {0}
    fs.feed_pcap_slice(slice_pcap(pcap, half, 10**9))
    jfs.feed_pcap_slice(jax_slice(jpcap, half, 10**9))
    fs.flush()
    jfs.flush()
    assert fs.counts().tolist() == jfs.counts().tolist()
    assert fs.flows_evicted == jfs.flows_evicted


# -- the mesh -----------------------------------------------------------------


@pytest.mark.parametrize("ndev", [1, 2, 3])
def test_count_matches_and_chunk_sharded_equal_jax(ndev):
    m, jm = Matcher(PATS, device="cpu"), JaxMatcher(PATS)
    jmsh, pmsh = jmesh.make_mesh(jax.devices("cpu")[:ndev]), pmesh.make_mesh(["cpu"] * ndev)
    payloads, lengths = _batch(31, 13, 40, pats=PATS, lo=-2, hi=50)
    got = pmesh.count_matches_sharded(m.cac, payloads, lengths, pmsh, dup_map=m.ac.dup_map)
    want = np.asarray(jmesh.count_matches_sharded(jm.cac, payloads, lengths, jmsh,
                                                  dup_map=jm.ac.dup_map))
    assert np.array_equal(got, want) and want.sum() > 0
    F = 12
    states = np.zeros(F, np.int32)
    jstates = np.zeros(F, np.int32)
    total = np.zeros(len(PATS), np.int64)
    jtotal = np.zeros(len(PATS), np.int64)
    for c in range(0, 40, 9):
        rel = np.clip(lengths[:F] - c, 0, 9).astype(np.int32)
        counts, states = pmesh.count_chunk_sharded(m.cac, payloads[:F, c:c + 9], rel, states,
                                                   pmsh, dup_map=m.ac.dup_map)
        jcounts, jstates = jmesh.count_chunk_sharded(jm.cac, payloads[:F, c:c + 9], rel, jstates,
                                                     jmsh, dup_map=jm.ac.dup_map)
        total += counts.numpy()
        jtotal += np.asarray(jcounts)
    assert np.array_equal(total, jtotal) and np.array_equal(states.numpy(), np.asarray(jstates))
    assert np.array_equal(total, m.count(payloads[:F], lengths[:F], engine="ac"))
    with pytest.raises(ValueError, match="divide"):
        pmesh.count_chunk_sharded(m.cac, payloads[:F + 1], lengths[:F + 1],
                                  np.zeros(F + 1, np.int32), pmesh.make_mesh(["cpu"] * 2))


def test_count_tile_sharded_ac():
    m = Matcher(PATS, device="cpu")
    payloads, lengths = _batch(2, 12, 32, pats=PATS)
    p, l = torch.from_numpy(payloads), torch.from_numpy(lengths)
    got = pmesh.count_tile_sharded(m, p, l, pmesh.make_mesh(["cpu"] * 3), engine="ac")
    assert np.array_equal(got.numpy()[m.ac.dup_map], m.count(payloads, lengths, engine="ac"))


# -- the streamed paths ----------------------------------------------------


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scan_stream")
    synth_udp_pcap(d / "a.pcap", 150, payload_len=300, payload_len_jitter=250, patterns=STANDIN,
                   plant_rate=0.5, invalid_rate=0.05, seed=21)
    return d / "a.pcap"


@pytest.mark.parametrize("engine", ["ac", "kmp"])
@pytest.mark.parametrize("kw", [dict(), dict(sharded=True), dict(tile_rows=8, pack_width=256),
                                dict(host_workers=2)],
                         ids=["default", "sharded", "small-tiles", "host-workers"])
def test_count_pcap_streamed_equals_jax(caps, engine, kw):
    m, jm = Matcher(STANDIN, engine=engine, device="cpu"), JaxMatcher(STANDIN, engine=engine)
    stats, jstats = {}, {}
    got = pp.count_pcap_streamed(m, caps, stats=stats, **kw)
    want = np.asarray(jpp.count_pcap_streamed(jm, caps, stats=jstats, **kw))
    assert got.tolist() == want.tolist() and got.sum() > 50
    assert stats == jstats


@pytest.mark.parametrize("engine", ["ac", "kmp"])
def test_pipelined_and_scan_streamed_equal_jax(caps, tmp_path, engine):
    m, jm = Matcher(STANDIN, engine=engine, device="cpu"), JaxMatcher(STANDIN, engine=engine)
    want = np.asarray(jm.count_pcap(caps))
    assert pp.count_pcap_pipelined(m, caps, batch_size=37).tolist() == want.tolist()
    stats, jstats = {}, {}
    got = pp.scan_pcap_streamed(m, caps, dump_path=tmp_path / "pt.pcap", stats=stats)
    jgot = jpp.scan_pcap_streamed(jm, caps, dump_path=tmp_path / "jax.pcap", stats=jstats)
    assert got.tolist() == np.asarray(jgot).tolist() == want.tolist()
    assert stats == jstats and stats["engine_resolved"] == engine
    assert (tmp_path / "pt.pcap").read_bytes() == (tmp_path / "jax.pcap").read_bytes()
    counts, offs = pp.scan_pcap_streamed(m, caps, offsets=True)
    jcounts, joffs = jpp.scan_pcap_streamed(jm, caps, offsets=True)
    assert counts.tolist() == np.asarray(jcounts).tolist()
    assert np.array_equal(offs, np.asarray(joffs)) and len(offs) > 50
