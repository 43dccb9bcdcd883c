"""Match attribution in the torch package against the JAX package, on the
CPU: ``find_matches`` (the plain version of the ``window_find`` kernel),
``counts_from_match_rows``, the pcap writers, ``scan_pcap_streamed``'s
offsets and dump, and ``FlowStreamMatcher(collect_offsets=True)``.

Inputs are made from seeds with numpy and handed to both packages.  The
results are integer triples, counts and file bytes: every comparison is
exact equality (tolerance 0).
"""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.io import pcap as jax_pcap
from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap, synth_udp_pcap
from multithreading_string_matching_tpu.ops.window import WindowProgram as JaxProgram
from multithreading_string_matching_tpu.ops.window import find_matches as jax_find
from multithreading_string_matching_tpu.parallel import pipeline as jpp
from multithreading_string_matching_tpu.parallel.flow_stream import (
    FlowStreamMatcher as JaxFlowStream,
)
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io import pcap as pt_pcap
from multithreading_string_matching_tpu_torch.ops.window import WindowProgram, find_matches_plain
from multithreading_string_matching_tpu_torch.parallel import mesh as mesh_mod
from multithreading_string_matching_tpu_torch.parallel import pipeline as pp
from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher
from multithreading_string_matching_tpu_torch.parallel.pattern_shard import make_pattern_mesh

torch.set_num_threads(1)

ALPHA = np.frombuffer(b"abcdAB\x00", np.uint8)


def _rand_set(rng, n, lo=1, hi=9, alphabet=b"abcdAB"):
    letters = np.frombuffer(alphabet, np.uint8)
    return [bytes(letters[rng.integers(0, len(letters), size=int(rng.integers(lo, hi)))])
            for _ in range(n)]


def _tile(rng, n, L, alphabet=ALPHA, lmax=None):
    p = rng.choice(alphabet, size=(n, L)).astype(np.uint8)
    lens = rng.integers(0, (L if lmax is None else lmax) + 1, size=n).astype(np.int32)
    return p, lens


def _case(name):
    """(patterns, payloads, lengths, nocase) for one named case."""
    rng = np.random.default_rng(sum(name.encode()))
    if name == "random":
        return _rand_set(rng, 6) + [b"ab"], *_tile(rng, 23, 61), False
    if name == "random-dups":
        pats = _rand_set(rng, 5, 1, 4)
        return pats + pats[:2], *_tile(rng, 17, 40), False
    if name == "nul":
        return [b"a\x00", b"\x00", b"\x00\x00b", b"ab", b"a\x00b\x00"], *_tile(rng, 19, 33), False
    if name == "nocase":
        return [b"Ab", b"aB", b"bcd", b"ABCD", b"d"], *_tile(rng, 21, 37), True
    if name == "ragged-zero-rows":
        p, lens = _tile(rng, 30, 48)
        lens[::3] = 0
        return [b"ab", b"b", b"cab", b"\x00a"], p, lens, False
    if name == "zero-width":
        return [b"ab", b"b"], np.zeros((5, 0), np.uint8), np.zeros(5, np.int32), False
    if name == "zero-rows":
        return [b"ab", b"b"], np.zeros((0, 16), np.uint8), np.zeros(0, np.int32), False
    if name == "longer-than-row":
        return [b"abcabcabcabcab", b"ab", b"a" * 20], *_tile(rng, 9, 12, np.frombuffer(
            b"abc", np.uint8)), False
    if name == "many-groups":
        return _rand_set(rng, 29, 1, 6), *_tile(rng, 25, 50), False
    if name == "table-route":
        pats = _rand_set(rng, 140, 13, 21, b"abcdefghij")
        p, lens = _tile(rng, 20, 90, np.frombuffer(b"abcdefghij", np.uint8))
        for r in range(0, 20, 2):  # plant some so the set really matches
            q = pats[r]
            p[r, 5 : 5 + len(q)] = np.frombuffer(q, np.uint8)
            lens[r] = 90
        return pats, p, lens, False
    raise KeyError(name)


CASES = ["random", "random-dups", "nul", "nocase", "ragged-zero-rows", "zero-width",
         "zero-rows", "longer-than-row", "many-groups", "table-route"]


@pytest.mark.parametrize("name", CASES)
def test_find_matches_equals_jax(name):
    pats, p, lens, nocase = _case(name)
    m = Matcher(pats, case_insensitive=nocase, device="cpu")
    jm = JaxMatcher(pats, case_insensitive=nocase)
    got = m.find_matches(p, lens)
    want = np.asarray(jm.find_matches(p, lens))
    assert got.dtype == np.int64 and got.shape[1:] == (3,)
    assert np.array_equal(got, want)
    if name == "table-route":
        assert m.explain()["pallas_kernel"] == "table+filter" and len(got) >= 10
    if name not in ("zero-width", "zero-rows", "longer-than-row"):
        assert len(got) > 0
    # The plain function on the port's program equals the JAX function.
    folded = m._maybe_fold(p)
    assert np.array_equal(find_matches_plain(m.window, folded, lens),
                          np.asarray(jax_find(JaxProgram.build(m._match_patterns), folded, lens)))


@pytest.mark.parametrize("name", ["random", "nul", "many-groups"])
def test_find_matches_row_slices_equal_one_pass(name, monkeypatch):
    """Batches at or over the position bound are found in row slices whose
    rows are remapped to the caller's numbering."""
    pats, p, lens, nocase = _case(name)
    m = Matcher(pats, device="cpu")
    whole = m.find_matches(p, lens)
    monkeypatch.setattr(mesh_mod, "SUMMARY_MAX_POSITIONS", 3 * p.shape[1] + 1)
    assert np.array_equal(m.find_matches(p, lens), whole)
    monkeypatch.setattr(mesh_mod, "SUMMARY_MAX_POSITIONS", p.shape[1])
    with pytest.raises(ValueError, match="position bound"):
        m.find_matches(p, lens)


def test_find_matches_group_sizes():
    pats, p, lens, _ = _case("many-groups")
    wp = WindowProgram.build(pats)
    want = find_matches_plain(wp, p, lens)
    for group in (1, 3, 64):
        assert np.array_equal(find_matches_plain(wp, p, lens, group=group), want)
        assert np.array_equal(find_matches_plain(wp, torch.from_numpy(p), torch.from_numpy(lens),
                                                 group=group), want)


@pytest.mark.parametrize("name", ["random-dups", "nul", "nocase", "table-route"])
def test_counts_from_match_rows_equals_count(name):
    pats, p, lens, nocase = _case(name)
    m = Matcher(pats, case_insensitive=nocase, device="cpu")
    jm = JaxMatcher(pats, case_insensitive=nocase)
    rows = m.find_matches(p, lens)
    got = m.counts_from_match_rows(rows)
    assert got.dtype == np.int64
    assert np.array_equal(got, m.count(p, lens))
    assert np.array_equal(got, jm.counts_from_match_rows(jm.find_matches(p, lens)))
    empty = m.counts_from_match_rows(np.zeros((0, 3), np.int64))
    assert empty.tolist() == [0] * len(pats)


# -- pcap writers --------------------------------------------------------------


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_attribution")
    out = {}
    for name, n, seed in (("a", 140, 1), ("b", 60, 2), ("c", 30, 3)):
        out[name] = d / f"{name}.pcap"
        synth_udp_pcap(out[name], n, payload_len=120, payload_len_jitter=100,
                       patterns=[b"needle", b"ab\x00"], plant_rate=0.4, invalid_rate=0.1,
                       seed=seed)
    # A nanosecond-resolution copy of capture c.
    out["ns"] = d / "ns.pcap"
    jax_pcap.write_pcap(out["ns"], dataclasses.replace(jax_pcap.read_pcap(out["c"]),
                                                       nanos=True))
    out["dir"] = d
    return out


def _pair_read(path):
    return pt_pcap.read_pcap(path), jax_pcap.read_pcap(path)


@pytest.mark.parametrize("sel", ["all", "indices", "mask", "empty", "reversed"])
def test_write_pcap_bytes_equal_jax(captures, sel):
    pc, jc = _pair_read(captures["a"])
    idx = {"all": None, "indices": np.array([0, 3, 4, 17, 139]),
           "mask": np.arange(pc.num_packets) % 3 == 1, "empty": np.zeros(0, np.int64),
           "reversed": np.arange(pc.num_packets)[::-1][:40]}[sel]
    d = captures["dir"]
    assert pt_pcap.write_pcap(d / f"w_{sel}_pt.pcap", pc, idx) == jax_pcap.write_pcap(
        d / f"w_{sel}_jax.pcap", jc, idx)
    got = (d / f"w_{sel}_pt.pcap").read_bytes()
    assert got == (d / f"w_{sel}_jax.pcap").read_bytes()
    if sel == "all":
        assert got == captures["a"].read_bytes()  # a capture re-emits verbatim


def test_pcap_writer_chunks_and_header_equal_jax(captures):
    """Chunked writes (an empty first chunk still locks the header), the
    fallback header of a writer that saw no chunk, nanosecond captures, a
    compressed output, and the same refusals."""
    d = captures["dir"]
    pc, jc = _pair_read(captures["ns"])
    for mod, cap, tag in ((pt_pcap, pc, "pt"), (jax_pcap, jc, "jax")):
        with mod.PcapWriter(d / f"chunks_{tag}.pcap") as w:
            w.write(mod.slice_pcap(cap, 0, 10), np.zeros(0, np.int64))
            w.write(mod.slice_pcap(cap, 10, 30), [1, 2, 5])
            w.write(mod.slice_pcap(cap, 0, 4))
            assert w.packets_written == 7
        mod.PcapWriter(d / f"none_{tag}.pcap", linktype=101, snaplen=999, nanos=True).close()
        with mod.PcapWriter(d / f"z_{tag}.pcap.gz") as w:
            w.write(cap, np.arange(cap.num_packets) % 2 == 0)
    for name in ("chunks", "none"):
        assert (d / f"{name}_pt.pcap").read_bytes() == (d / f"{name}_jax.pcap").read_bytes()
    assert gzip.decompress((d / "z_pt.pcap.gz").read_bytes()) == gzip.decompress(
        (d / "z_jax.pcap.gz").read_bytes())
    assert pt_pcap.read_pcap(d / "z_pt.pcap.gz").num_packets == (pc.num_packets + 1) // 2
    pa, ja = _pair_read(captures["a"])
    for mod, ns, a in ((pt_pcap, pc, pa), (jax_pcap, jc, ja)):
        errs = []
        with mod.PcapWriter(d / "bad.pcap") as w:
            w.write(a, [0])
            for fn in (lambda: w.write(ns, [0]), lambda: w.write(a, [a.num_packets]),
                       lambda: w.write(a, np.ones(3, bool))):
                with pytest.raises(ValueError) as e:
                    fn()
                errs.append(str(e.value))
        if mod is pt_pcap:
            got_errs = errs
    assert got_errs == errs


def test_concat_pcaps_equal_jax(captures):
    parts = [_pair_read(captures[k]) for k in ("a", "b", "a")]
    got = pt_pcap.concat_pcaps([p for p, _ in parts])
    want = jax_pcap.concat_pcaps([j for _, j in parts])
    for f in ("buf", "offsets", "caplens", "origlens", "ts_sec", "ts_frac"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.linktype, got.snaplen, got.nanos) == (want.linktype, want.snaplen, want.nanos)
    assert got.num_packets == 340
    one = parts[0][0]
    assert pt_pcap.concat_pcaps([one]) is one
    d = captures["dir"]
    pt_pcap.write_pcap(d / "cat_pt.pcap", got, np.arange(0, 340, 7))
    jax_pcap.write_pcap(d / "cat_jax.pcap", want, np.arange(0, 340, 7))
    assert (d / "cat_pt.pcap").read_bytes() == (d / "cat_jax.pcap").read_bytes()
    for bad in ([], [parts[0][0], _pair_read(captures["ns"])[0]]):
        with pytest.raises(ValueError) as e:
            pt_pcap.concat_pcaps(bad)
        with pytest.raises(ValueError) as je:
            jax_pcap.concat_pcaps([jax_pcap.read_pcap(captures["a"]),
                                   jax_pcap.read_pcap(captures["ns"])] if bad else [])
        assert str(e.value) == str(je.value)


# -- the streamed scan ---------------------------------------------------------


STREAM_PATS = [b"needle", b"ab\x00", b"ee", b"needle"]


@pytest.mark.parametrize("kw", [
    dict(), dict(host_workers=2), dict(sharded=True),
    dict(sharded=True, shard_axis="patterns"), dict(engine="window"),
    dict(engine="window", host_workers=2),
], ids=["sequential", "host-workers-2", "sharded-packets", "sharded-patterns", "window",
        "window-host-workers-2"])
def test_scan_pcap_streamed_offsets_and_dump_equal_jax(captures, kw):
    kw = dict(kw)
    engine = kw.pop("engine", "pallas")
    d = captures["dir"]
    tag = "_".join(f"{k}{v}" for k, v in kw.items()) + engine
    if kw.get("sharded"):
        kw["mesh"] = (make_pattern_mesh(["cpu"] * 3) if kw.get("shard_axis") == "patterns"
                      else mesh_mod.make_mesh(["cpu"] * 2))
    paths = [captures["a"], captures["b"]]
    stats = {}
    got, got_off = pp.scan_pcap_streamed(
        Matcher(STREAM_PATS, engine=engine, device="cpu"), [str(p) for p in paths],
        offsets=True, dump_path=d / f"s_{tag}_pt.pcap", batch_packets=37, stats=stats, **kw)
    jstats = {}
    jkw = {k: v for k, v in kw.items() if k != "mesh"}
    want, want_off = jpp.scan_pcap_streamed(
        JaxMatcher(STREAM_PATS, engine=engine), [str(p) for p in paths], offsets=True,
        dump_path=d / f"s_{tag}_jax.pcap", batch_packets=37, stats=jstats, **jkw)
    assert got.tolist() == want.tolist() and got.dtype == want.dtype
    assert np.array_equal(got_off, want_off) and len(got_off) > 20
    assert (d / f"s_{tag}_pt.pcap").read_bytes() == (d / f"s_{tag}_jax.pcap").read_bytes()
    for key in ("packets", "valid_payloads", "payload_bytes", "dumped_packets", "host_workers"):
        assert stats.get(key) == jstats.get(key), key
    if engine == "window":  # JAX's pallas degrades to window on the CPU
        assert stats["engine_resolved"] == jstats["engine_resolved"] == "window"
    # Packet numbers are the capture's, global across chunks and files.
    assert got_off[:, 0].max() >= 140
    # Counts only, and the dump alone, agree with the full form.
    only = pp.scan_pcap_streamed(Matcher(STREAM_PATS, engine=engine, device="cpu"),
                                 [str(p) for p in paths], batch_packets=37, **kw)
    assert only.tolist() == got.tolist()
    dumped = pp.dump_matches_streamed(Matcher(STREAM_PATS, engine=engine, device="cpu"),
                                      [str(p) for p in paths], d / f"dm_{tag}.pcap",
                                      batch_packets=37, **kw)
    assert dumped.tolist() == got.tolist()
    assert (d / f"dm_{tag}.pcap").read_bytes() == (d / f"s_{tag}_jax.pcap").read_bytes()


def test_scan_pcap_streamed_all_invalid_locks_header(tmp_path):
    """A capture with no valid payload still dumps a header (the
    capture's own), as the JAX package's does."""
    cap = tmp_path / "ns.pcap"
    synth_udp_pcap(cap, 20, payload_len=50, invalid_rate=1.0, seed=5)
    for mod, m, tag in ((pp, Matcher([b"x"], device="cpu"), "pt"),
                        (jpp, JaxMatcher([b"x"]), "jax")):
        stats = {}
        counts, off = mod.scan_pcap_streamed(m, cap, offsets=True, stats=stats,
                                             dump_path=tmp_path / f"{tag}.pcap")
        assert counts.tolist() == [0] and off.shape == (0, 3) and stats["dumped_packets"] == 0
    assert (tmp_path / "pt.pcap").read_bytes() == (tmp_path / "jax.pcap").read_bytes()
    assert len((tmp_path / "pt.pcap").read_bytes()) == 24


# -- the flow monitor ----------------------------------------------------------

FLOWS = [
    (("10.0.0.1", "10.0.0.2", 1111, 80), b"xxSIGNATUREyySIGz", [4, 5, 4, 4]),
    (("10.0.0.3", "10.0.0.2", 2222, 80), b"SIGpqSIGr", [3, 3, 3]),
    (("10.0.0.4", "10.0.0.2", 3333, 80), b"quiet flow", [5, 5]),
]
PATS = [b"SIGNATURE", b"SIG"]


def _flow_capture(tmp_path, flows=FLOWS, name="off.pcap", **kw):
    cap = tmp_path / name
    synth_tcp_flows_pcap(cap, flows, interleave_seed=2, **kw)
    return pt_pcap.read_pcap(cap), jax_pcap.read_pcap(cap)


def _drain_both(caps, pats, step=2, **kw):
    """Both monitors fed the same slices; the drained triples of each."""
    pc, jc = caps
    out = []
    for mod, m, fs_cls, cap in ((pt_pcap, Matcher(pats, device="cpu"), FlowStreamMatcher, pc),
                                (jax_pcap, JaxMatcher(pats), JaxFlowStream, jc)):
        fs = fs_cls(m, "tcp", engine="window", collect_offsets=True, **kw)
        hits = []
        for s0 in range(0, cap.num_packets, step):
            fs.feed_pcap_slice(mod.slice_pcap(cap, s0, s0 + step, copy=False))
            hits += fs.drain_offsets()
        fs.flush()
        hits += fs.drain_offsets()
        out.append((fs, [(bytes(k), int(o), int(u)) for k, o, u in hits]))
    return out


@pytest.mark.parametrize("scan_bytes", [3, 16, 1 << 20])
@pytest.mark.parametrize("step", [1, 3])
def test_flow_offsets_equal_jax(tmp_path, scan_bytes, step):
    (fs, got), (jfs, want) = _drain_both(_flow_capture(tmp_path), PATS, step=step,
                                         scan_bytes=scan_bytes)
    assert got == want and len(got) == 5
    bc = np.bincount([u for _, _, u in got], minlength=2)[fs.matcher.window.dup_map]
    assert fs.counts().tolist() == jfs.counts().tolist() == bc.tolist()


def test_flow_offsets_reorder_equal_jax(tmp_path):
    flows = [
        (("10.0.0.1", "10.0.0.2", 1111, 80), b"xxSIGNATUREyy", [4, 5, 4]),
        (("10.0.0.5", "10.0.0.2", 4444, 80), b"SIGaSIGbSIG", [3, 3, 2, 3]),
    ]
    caps = _flow_capture(tmp_path, flows, name="ro.pcap", vlan_rate=1.0, reorder_seed=7,
                         retransmit_rate=0.4, overlap_rate=0.4, seed=3)
    (_, got), (_, want) = _drain_both(caps, PATS, reorder=True, vlan=True, scan_bytes=5)
    assert got == want and len(got) >= 4


def test_flow_offsets_nul_revival_equal_jax(tmp_path):
    caps = _flow_capture(tmp_path, [
        (("10.0.0.1", "10.0.0.2", 1111, 80), b"A\x00B" * 3, [3, 3, 3])], name="nul.pcap")
    (fs, got), (_, want) = _drain_both(caps, [b"\x00B", b"B"], step=1, scan_bytes=2)
    assert got == want
    assert fs.counts().tolist() == [3, 3]


def test_flow_offsets_eviction_equal_jax(tmp_path):
    """An evicted flow that comes back restarts at stream offset 0; idle
    eviction between rounds."""
    pc, jc = _flow_capture(tmp_path, [
        (("10.0.0.1", "10.0.0.2", 1111, 80), b"xxSIG", [5])], name="ev.pcap")
    got = []
    for m, fs_cls, cap in ((Matcher([b"SIG"], device="cpu"), FlowStreamMatcher, pc),
                           (JaxMatcher([b"SIG"]), JaxFlowStream, jc)):
        fs = fs_cls(m, "tcp", engine="window", scan_bytes=1, collect_offsets=True)
        fs.feed_pcap_slice(cap)
        fs.flush()
        first = fs.drain_offsets()
        fs.evict([first[0][0]])
        fs.feed_pcap_slice(cap)
        fs.flush()
        got.append((first, fs.drain_offsets(), fs.counts().tolist()))
    assert got[0] == got[1]
    assert got[0][1][0][1] == 2 and got[0][2] == [2]
    caps = _flow_capture(tmp_path, name="idle.pcap")
    (_, a), (_, b) = _drain_both(caps, PATS, step=1, scan_bytes=4, idle_rounds=1)
    assert a == b


def test_flow_offsets_small_offset_chunk_equal_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    pay = bytes(rng.integers(97, 105, size=4096, dtype=np.uint8))
    pay = pay[:100] + b"NEEDLE" + pay[100:2000] + b"NEEDLE" + pay[2000:]
    caps = _flow_capture(tmp_path, [(("10.0.0.1", "10.0.0.2", 1111, 80), pay, [512] * 9)],
                         name="big.pcap")
    monkeypatch.setattr(FlowStreamMatcher, "OFFSET_CHUNK", 256)
    monkeypatch.setattr(JaxFlowStream, "OFFSET_CHUNK", 256)
    (_, got), (_, want) = _drain_both(caps, [b"NEEDLE"], step=3)
    assert got == want and len(got) == 2
    sig = bytes(range(32, 132))  # H = 99 > the chunk: the stride clamps to H
    pay = b"z" * 40 + sig + b"z" * 300 + sig + b"z" * 20
    caps = _flow_capture(tmp_path, [(("10.0.0.1", "10.0.0.2", 1111, 80), pay, [64] * 9)],
                         name="sig.pcap")
    monkeypatch.setattr(FlowStreamMatcher, "OFFSET_CHUNK", 16)
    monkeypatch.setattr(JaxFlowStream, "OFFSET_CHUNK", 16)
    (_, got), (_, want) = _drain_both(caps, [sig], scan_bytes=128)
    assert got == want and len(got) == 2


def test_flow_offsets_reload_refusal_equal_jax(tmp_path):
    pc, jc = _flow_capture(tmp_path)
    errs = []
    for m, m2, fs_cls, cap in (
            (Matcher(PATS, device="cpu"), Matcher([b"SIG", b"q"], device="cpu"),
             FlowStreamMatcher, pc),
            (JaxMatcher(PATS), JaxMatcher([b"SIG", b"q"]), JaxFlowStream, jc)):
        fs = fs_cls(m, "tcp", engine="window", collect_offsets=True)
        fs.feed_pcap_slice(cap)
        with pytest.raises(ValueError) as e:
            fs.reload(m2)
        errs.append(str(e.value))
        drained = fs.drain_offsets()
        prev = fs.reload(m2)  # drained: the swap goes through
        errs.append((len(drained), prev.tolist()))
        with pytest.raises(ValueError) as e:
            fs_cls(m, "tcp", engine="ac", collect_offsets=True)
        errs.append(str(e.value))
    assert errs[:3] == errs[3:]
    assert "drain_offsets() before reload()" in errs[0]
