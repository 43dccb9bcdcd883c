"""The torch package's streamed packet paths against the JAX package's:
``count_pcap_streamed`` (the packed-tile serving path), its NUL-set
fallback ``scan_pcap_streamed`` (counts only) and ``count_pcap_pipelined``
(the task pipeline), on seeded synth captures.

The port runs on the CPU, where its stager hands the kernels' plain
versions plain CPU buffers; JAX runs on its 8-device CPU mesh (its pallas
engine degrades to the XLA window form there).  Counts are integers:
every comparison is exact (tolerance 0), against the JAX function and the
port's one-shot ``Matcher.count_pcap``, with equal ``stats``.  The one
field that names the platform, ``engine_resolved`` of a ``pallas``
matcher (the port reports ``pallas`` on the CPU, JAX ``window``), is
compared where both run the same engine.
"""

import io
import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap
from multithreading_string_matching_tpu.io.synth import synth_udp_pcap as jax_synth
from multithreading_string_matching_tpu.parallel import pipeline as jpp
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu_torch.parallel import pipeline as pp
from multithreading_string_matching_tpu_torch.parallel.mesh import make_mesh
from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
    make_2d_mesh,
    make_pattern_mesh,
)
from multithreading_string_matching_tpu_torch.parallel.stager import TileStager

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = load_patterns(REPO / "multithreading_string_matching_tpu_torch" / "data"
                        / "strings_standin.txt")
NUL_SET = STANDIN + [b"a\x00b", b"\x00"]
STATS = ("packets", "valid_payloads", "payload_bytes", "host_workers")


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    """UDP captures planted with the stand-in set (same bytes from both
    packages' synth), a second one for the two-file corpus, an empty one,
    and a TCP capture."""
    d = tmp_path_factory.mktemp("torch_pipeline")
    out = {}
    for name, n, seed in (("a", 300, 3), ("b", 120, 4), ("empty", 0, 5)):
        out[name] = d / f"{name}.pcap"
        synth_udp_pcap(out[name], n, payload_len=180, payload_len_jitter=170,
                       patterns=STANDIN + [b"a\x00b"], plant_rate=0.6, invalid_rate=0.05,
                       seed=seed)
    twin = d / "a_jax.pcap"
    jax_synth(twin, 300, payload_len=180, payload_len_jitter=170, patterns=STANDIN + [b"a\x00b"],
              plant_rate=0.6, invalid_rate=0.05, seed=3)
    out["twin"] = twin
    rng = np.random.default_rng(6)
    flows = []
    for i in range(12):
        pay = rng.integers(0x20, 0x7F, size=600, dtype=np.uint8)
        for _ in range(4):
            p = STANDIN[int(rng.integers(0, len(STANDIN)))]
            o = int(rng.integers(0, pay.size - len(p)))
            pay[o:o + len(p)] = np.frombuffer(p, np.uint8)
        flows.append(((f"10.0.{i}.1", "10.0.255.1", 1000 + i, 80), pay.tobytes()))
    out["tcp"] = d / "tcp.pcap"
    synth_tcp_flows_pcap(out["tcp"], flows, segment_len=150, interleave_seed=1)
    return out


def _pair(pats, **kw):
    return Matcher(pats, device="cpu", **kw), JaxMatcher(pats, **kw)


def _stats_equal(got, want, same_engine):
    assert {k: got.get(k) for k in STATS} == {k: want.get(k) for k in STATS}
    assert set(got) == set(want)
    if same_engine:
        assert got["engine_resolved"] == want["engine_resolved"]


def test_synth_bytes_equal_jax(caps):
    assert caps["a"].read_bytes() == caps["twin"].read_bytes()


STREAM_CASES = {
    "tiny-tiles": dict(kw=dict(tile_rows=8, pack_width=256, batch_packets=40)),
    "rows-wider-than-pack": dict(kw=dict(tile_rows=16, pack_width=128, batch_packets=64)),
    "default-tile": dict(kw=dict()),
    "nocase": dict(kw=dict(tile_rows=16, pack_width=512, batch_packets=50),
                   matcher=dict(case_insensitive=True)),
    "tcp": dict(kw=dict(tile_rows=8, pack_width=256), mode="tcp", cap="tcp"),
    "window-engine": dict(kw=dict(tile_rows=8, pack_width=256, batch_packets=64),
                          matcher=dict(engine="window")),
    "host-workers-2": dict(kw=dict(tile_rows=8, pack_width=256, batch_packets=32,
                                   host_workers=2)),
    "host-workers-4": dict(kw=dict(tile_rows=8, pack_width=256, batch_packets=32,
                                   host_workers=4)),
    "sync-dispatch": dict(kw=dict(tile_rows=8, pack_width=256, sync_dispatch=True)),
    "table-kernels": dict(kw=dict(tile_rows=16, pack_width=256), env={"MSM_PALLAS_TABLE": "1"}),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_count_pcap_streamed_equals_jax(caps, monkeypatch, case):
    spec = STREAM_CASES[case]
    for k, v in spec.get("env", {}).items():
        monkeypatch.setenv(k, v)
    mode = spec.get("mode", "udp")
    cap = caps[spec.get("cap", "a")]
    m, jm = _pair(STANDIN, **spec.get("matcher", {}))
    got_stats, want_stats = {}, {}
    got = pp.count_pcap_streamed(m, cap, mode, stats=got_stats, **spec["kw"])
    want = np.asarray(jpp.count_pcap_streamed(jm, cap, mode, stats=want_stats, **spec["kw"]))
    one_shot = m.count_pcap(cap, mode)
    assert got.dtype == np.int32 and got.shape == (len(STANDIN),)
    assert got.tolist() == want.tolist() == one_shot.tolist()
    assert got.sum() > 0
    _stats_equal(got_stats, want_stats, same_engine="matcher" in spec
                 and spec["matcher"].get("engine") == "window")


def test_streamed_host_workers_identical_to_sequential(caps):
    m = Matcher(STANDIN, device="cpu")
    seq = pp.count_pcap_streamed(m, caps["a"], batch_packets=16, tile_rows=8, pack_width=256)
    for workers in (2, 4):
        stats = {}
        par = pp.count_pcap_streamed(m, caps["a"], batch_packets=16, tile_rows=8,
                                     pack_width=256, host_workers=workers, stats=stats)
        assert par.tolist() == seq.tolist()
        assert stats["host_workers"] == workers and stats["packets"] == 300


def test_two_paths_file_object_and_empty(caps):
    m, jm = _pair(STANDIN)
    kw = dict(tile_rows=8, pack_width=256, batch_packets=50)
    got = pp.count_pcap_streamed(m, [caps["a"], caps["b"]], **kw)
    want = np.asarray(jpp.count_pcap_streamed(jm, [caps["a"], caps["b"]], **kw))
    assert got.tolist() == want.tolist() == (m.count_pcap(caps["a"]) + m.count_pcap(caps["b"])
                                              ).tolist()
    with open(caps["a"], "rb") as f:
        assert pp.count_pcap_streamed(m, f, **kw).tolist() == m.count_pcap(caps["a"]).tolist()
    buf = io.BytesIO(caps["b"].read_bytes())
    assert pp.count_pcap_pipelined(m, buf).tolist() == m.count_pcap(caps["b"]).tolist()
    stats = {}
    empty = pp.count_pcap_streamed(m, caps["empty"], stats=stats, **kw)
    assert empty.dtype == np.int32 and not empty.any()
    assert stats["packets"] == 0
    assert not pp.count_pcap_pipelined(m, caps["empty"]).any()
    assert not pp.scan_pcap_streamed(m, caps["empty"]).any()


@pytest.mark.parametrize("engine", ["pallas", "window"])
def test_nul_fallback_equals_jax(caps, engine):
    m, jm = _pair(NUL_SET, engine=engine)
    got_stats, want_stats = {}, {}
    got = pp.count_pcap_streamed(m, caps["a"], batch_packets=70, stats=got_stats)
    want = np.asarray(jpp.count_pcap_streamed(jm, caps["a"], batch_packets=70,
                                              stats=want_stats))
    assert got.tolist() == want.tolist() == m.count_pcap(caps["a"]).tolist()
    assert got[-1] > 0  # the NUL pattern itself was counted
    _stats_equal(got_stats, want_stats, same_engine=engine == "window")
    scan_stats = {}
    assert pp.scan_pcap_streamed(m, caps["a"], batch_packets=33, host_workers=2,
                                 stats=scan_stats).tolist() == got.tolist()
    assert scan_stats["host_workers"] == 2


def test_nul_refuses_sync_dispatch_like_jax(caps):
    m, jm = _pair(NUL_SET)
    with pytest.raises(ValueError) as got:
        pp.count_pcap_streamed(m, caps["a"], sync_dispatch=True)
    with pytest.raises(ValueError) as want:
        jpp.count_pcap_streamed(jm, caps["a"], sync_dispatch=True)
    assert str(got.value) == str(want.value)
    assert "sync_dispatch requires the packed-tile path" in str(got.value)


def test_guards_and_unported_attribution(caps, tmp_path):
    """The guards, and the attribution forms (once refused here): offsets
    and the dump equal the JAX package's."""
    m = Matcher(STANDIN, device="cpu")
    with pytest.raises(ValueError, match="mesh= is only meaningful"):
        pp.count_pcap_streamed(m, caps["a"], mesh=make_mesh(["cpu"]))
    with pytest.raises(ValueError, match="unknown shard_axis"):
        pp.count_pcap_streamed(m, caps["a"], sharded=True, shard_axis="rows")
    jm = JaxMatcher(STANDIN)
    for kw in (dict(offsets=True), dict(dump_path="out.pcap")):
        got_kw = {k: tmp_path / f"pt_{v}" if k == "dump_path" else v for k, v in kw.items()}
        want_kw = {k: tmp_path / f"jax_{v}" if k == "dump_path" else v for k, v in kw.items()}
        got = pp.scan_pcap_streamed(m, caps["a"], **got_kw)
        want = jpp.scan_pcap_streamed(jm, caps["a"], **want_kw)
        if kw.get("offsets"):
            assert got[0].tolist() == want[0].tolist()
            assert np.array_equal(got[1], want[1]) and len(got[1]) > 50
        else:
            assert got.tolist() == want.tolist()
            assert (tmp_path / "pt_out.pcap").read_bytes() == (
                tmp_path / "jax_out.pcap").read_bytes()
    # The AC engine (once refused here) counts what the JAX package's does.
    got = pp.count_pcap_streamed(m, caps["a"], engine="ac")
    assert got.tolist() == np.asarray(jpp.count_pcap_streamed(jm, caps["a"], engine="ac")).tolist()


@pytest.mark.parametrize("kw", [dict(), dict(host_workers=2), dict(batch_size=37)],
                         ids=["sequential", "host-workers-2", "batch-37"])
@pytest.mark.parametrize("engine", ["pallas", "window"])
def test_count_pcap_pipelined_equals_jax(caps, engine, kw):
    m, jm = _pair(STANDIN, engine=engine)
    got = pp.count_pcap_pipelined(m, caps["a"], **kw)
    want = np.asarray(jpp.count_pcap_pipelined(jm, caps["a"], **kw))
    assert got.dtype == np.int32
    assert got.tolist() == want.tolist() == m.count_pcap(caps["a"]).tolist()


def test_pipelined_nocase_tcp_and_nul(caps):
    for pats, kw, cap, mode in ((STANDIN, dict(case_insensitive=True), "a", "udp"),
                                (STANDIN, {}, "tcp", "tcp"), (NUL_SET, {}, "a", "udp")):
        m, jm = _pair(pats, **kw)
        got = pp.count_pcap_pipelined(m, caps[cap], mode)
        want = np.asarray(jpp.count_pcap_pipelined(jm, caps[cap], mode))
        assert got.tolist() == want.tolist() == m.count_pcap(caps[cap], mode).tolist()


def test_lowered_drain_positions(caps, monkeypatch):
    """Many drains in one pass (the int32 wrap guard) change no count."""
    m = Matcher(STANDIN, device="cpu")
    want = m.count_pcap(caps["a"])
    monkeypatch.setattr(pp, "DRAIN_POSITIONS", 8 * 256 * 2)  # every second tile
    counter = pp.PackedTileCounter(m, tile_rows=8, pack_width=256)
    drains = []
    orig = counter._drain
    counter._drain = lambda: (drains.append(counter._total is not None), orig())
    for _chunk, batch in pp._iter_extracted(caps["a"], "udp", 64, False, False, False, 0):
        counter.add(batch.payloads, batch.lengths)
    assert counter.totals().tolist() == want.tolist()
    assert sum(drains) >= counter.tiles_dispatched // 2 > 3
    monkeypatch.setattr(pp, "DRAIN_POSITIONS", 1)
    assert pp.count_pcap_pipelined(m, caps["a"]).tolist() == want.tolist()
    assert pp.count_pcap_streamed(m, caps["a"], tile_rows=8, pack_width=256
                                  ).tolist() == want.tolist()


def test_int64_totals_past_int32(caps, monkeypatch):
    """Past 2^31 the drained host int64 totals come back exact, as in the
    JAX package's test_pipelined_int64_totals."""
    m = Matcher([b"http", b"udp"], engine="window", device="cpu")
    big = 2**30

    def fake_window(words, masks, lens, payloads, lengths, per_packet=False):
        return torch.full((words.shape[0],), big, dtype=torch.int32)

    monkeypatch.setattr(pp, "window_count", fake_window)
    monkeypatch.setattr(pp, "DRAIN_POSITIONS", 1)  # drain every batch / tile
    counts = pp.count_pcap_pipelined(m, caps["a"], batch_size=100)
    assert counts.dtype == np.int64 and counts.tolist() == [big * 3] * 2
    counter = pp.PackedTileCounter(m, tile_rows=8, pack_width=512)  # no oversized rows
    for _chunk, batch in pp._iter_extracted(caps["a"], "udp", 64, False, False, False, 0):
        counter.add(batch.payloads, batch.lengths)
    n = counter.totals()
    assert n.dtype == np.int64 and n.tolist() == [big * counter.tiles_dispatched] * 2
    got = pp.count_pcap_streamed(m, caps["a"], tile_rows=8, pack_width=512)
    assert got.dtype == np.int64 and got.tolist() == n.tolist()


def test_stale_slot_bytes_never_count(caps):
    """Every slot of the ring starts full of pattern bytes with full fills;
    hundreds of 2-row tiles and partial tiles turn the ring, and the counts
    stay exact."""
    m = Matcher(STANDIN, device="cpu")
    want = m.count_pcap(caps["a"])
    counter = pp.PackedTileCounter(m, tile_rows=2, pack_width=256)
    junk = np.frombuffer((b"NOTIFY http " * 30)[:256], np.uint8)
    for p, f in counter.stager._host:
        p.numpy().reshape(-1, 256)[:] = junk
        f.numpy()[:] = 256
    for _chunk, batch in pp._iter_extracted(caps["a"], "udp", 3, False, False, False, 0):
        counter.add(batch.payloads, batch.lengths)
        counter.flush()  # a partial tile after every feed
    assert counter.totals().tolist() == want.tolist()
    assert counter.tiles_dispatched > 100


def test_stager_cpu_slots_growth_and_guards():
    """The explicit CPU stager: ``fn`` gets the slot's own buffers, a larger
    tile grows every slot, ``rows`` dispatches a prefix, and a CUDA stager
    without a card raises instead of falling back."""
    stager = TileStager("cpu", 4, 16)
    with pytest.raises(RuntimeError, match="dispatch\\(\\) before host\\(\\)"):
        stager.dispatch(lambda p, l: None)
    seen = []
    for i in range(7):
        hp, hf = stager.host(4, 16)
        hp[:] = i
        hf[:] = 16
        seen.append(int(stager.dispatch(lambda p, l: p.sum(dtype=torch.int64) + l.sum())))
    assert seen == [4 * 16 * i + 64 for i in range(7)]
    hp, hf = stager.host(9, 32)  # grows every slot
    hp[:] = 1
    hf[:] = 2
    assert stager.dispatch(lambda p, l: (tuple(p.shape), int(l.sum())), rows=5) == ((5, 32), 10)
    with pytest.raises(ValueError, match="outside the slot"):
        stager.dispatch(lambda p, l: None, rows=10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            TileStager("cuda", 4, 16)


MESHES = {
    "packets-1": lambda: make_mesh(["cpu"]),
    "packets-4": lambda: make_mesh(["cpu"] * 4),
    "patterns-1": lambda: make_pattern_mesh(["cpu"]),
    "patterns-4": lambda: make_pattern_mesh(["cpu"] * 4),
    "both-2x2": lambda: make_2d_mesh(2, 2, ["cpu"] * 4),
}


@pytest.mark.parametrize("pats", ["standin", "nul"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_streamed_equals_unsharded(caps, mesh, pats):
    patterns = STANDIN if pats == "standin" else NUL_SET
    m = Matcher(patterns, device="cpu")
    stats = {}
    got = pp.count_pcap_streamed(m, caps["a"], tile_rows=10, pack_width=256, batch_packets=64,
                                 sharded=True, mesh=MESHES[mesh](), stats=stats)
    assert got.tolist() == m.count_pcap(caps["a"]).tolist()
    assert stats["engine_resolved"] == "pallas" and stats["packets"] == 300


@pytest.mark.parametrize("axis", ["packets", "patterns", "both"])
def test_sharded_streamed_equals_jax(caps, axis):
    m, jm = _pair(STANDIN, engine="window")
    got_stats, want_stats = {}, {}
    kw = dict(tile_rows=16, pack_width=256, batch_packets=100, sharded=True, shard_axis=axis)
    got = pp.count_pcap_streamed(m, caps["a"], stats=got_stats, **kw)
    want = np.asarray(jpp.count_pcap_streamed(jm, caps["a"], stats=want_stats, **kw))
    assert got.tolist() == want.tolist()
    _stats_equal(got_stats, want_stats, same_engine=True)
    nm, njm = _pair(NUL_SET, engine="window")
    got = pp.scan_pcap_streamed(nm, caps["a"], sharded=True, shard_axis=axis)
    want = np.asarray(jpp.scan_pcap_streamed(njm, caps["a"], sharded=True, shard_axis=axis))
    assert got.tolist() == want.tolist() == nm.count_pcap(caps["a"]).tolist()
