"""The streamed packet paths on the card: the pinned tile stager's ring,
the packed-tile counter and the live path's ``StreamMatcher`` (packed,
unpacked and long-payload feeds, with their launch counts) against the
plain version.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without one;
the card is looked for inside a fixture.  This file imports no jax, so it
runs where jax is not installed::

    python -m pytest --noconftest tests/test_torch_stream_gpu.py -q -m gpu

Counts are integers: every comparison is exact (tolerance 0).
"""

import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.decode import bpf_protocol_mask
from multithreading_string_matching_tpu_torch.io.live import FileReplaySource
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
from multithreading_string_matching_tpu_torch.ops import scan as sc
from multithreading_string_matching_tpu_torch.parallel import pipeline as pp
from multithreading_string_matching_tpu_torch.parallel.stager import TileStager
from multithreading_string_matching_tpu_torch.parallel.stream import StreamMatcher

pytestmark = pytest.mark.gpu

STANDIN = load_patterns(pathlib.Path(__file__).resolve().parent.parent
                        / "multithreading_string_matching_tpu_torch" / "data"
                        / "strings_standin.txt")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cap(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream_gpu") / "synth.pcap"
    synth_udp_pcap(path, 2000, payload_len=100, payload_len_jitter=90,
                   patterns=STANDIN + [b"a\x00b"], plant_rate=0.5, invalid_rate=0.03, seed=9)
    return path


def _reset():
    for m in (cw, ct, sc):
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


def _plain(pats, path, dev):
    """The plain version's counts on the card (the window engine)."""
    return Matcher(pats, engine="window", device=dev).count_pcap(path)


def test_ring_turns_with_stale_slots_and_partial_tiles(dev, cap):
    """tile_rows=8 over hundreds of tiles, every slot prefilled with pattern
    bytes and full fills, a partial tile after every feed.  No payload is
    wider than the rows, so every launch is a staged tile's."""
    m = Matcher(STANDIN, device=dev)
    want = _plain(STANDIN, cap, dev)
    counter = pp.PackedTileCounter(m, tile_rows=8, pack_width=256)
    junk = np.frombuffer((b"NOTIFY http " * 24)[:256], np.uint8)
    for p, f in counter.stager._host:
        p.numpy().reshape(-1, 256)[:] = junk
        f.numpy()[:] = 256
    _reset()
    for _chunk, batch in pp._iter_extracted(cap, "udp", 8, False, False, False, 0):
        counter.add(batch.payloads, batch.lengths)
        counter.flush()
    got = counter.totals()
    assert got.tolist() == want.tolist() and got.sum() > 0
    assert counter.tiles_dispatched > 200
    assert cw.LAUNCHES["window_count_totals"] == counter.tiles_dispatched


@pytest.mark.parametrize("kw", [dict(), dict(sync_dispatch=True), dict(host_workers=3),
                                dict(tile_rows=8, pack_width=128)],
                         ids=["default", "sync", "host-workers", "small-tiles"])
def test_streamed_equals_plain(dev, cap, kw):
    m = Matcher(STANDIN, device=dev)
    stats = {}
    _reset()
    got = pp.count_pcap_streamed(m, cap, batch_packets=100, stats=stats, **kw)
    assert got.tolist() == _plain(STANDIN, cap, dev).tolist()
    assert stats["engine_resolved"] == "pallas" and stats["packets"] == 2000
    assert cw.LAUNCHES["window_count_totals"] > 0 and not any(ct.LAUNCHES.values())


def test_table_route_and_nul_and_pipelined(dev, cap, monkeypatch):
    want = _plain(STANDIN, cap, dev)
    assert pp.count_pcap_pipelined(Matcher(STANDIN, device=dev), cap).tolist() == want.tolist()
    monkeypatch.setenv("MSM_PALLAS_TABLE", "1")
    _reset()
    got = pp.count_pcap_streamed(Matcher(STANDIN, device=dev), cap, tile_rows=64)
    assert got.tolist() == want.tolist()
    assert ct.LAUNCHES["filter_count_totals"] > 0 and not any(
        v for k, v in cw.LAUNCHES.items())
    monkeypatch.delenv("MSM_PALLAS_TABLE")
    nul = STANDIN + [b"a\x00b"]
    _reset()
    got = pp.count_pcap_streamed(Matcher(nul, device=dev), cap, batch_packets=300)
    assert got.tolist() == _plain(nul, cap, dev).tolist()
    assert cw.LAUNCHES["window_count_rows"] == 7 and cw.LAUNCHES["window_count_totals"] == 0


def test_stager_never_overwrites_a_slot_in_use(dev):
    """A kernel that sleeps before it reads its tile: the host keeps packing
    later tiles into the ring meanwhile, and every tile's sum is its own."""
    stager = TileStager(dev, 64, 256)
    sums = []

    def slow_sum(p, l):
        torch.cuda._sleep(2_000_000)
        return p.sum(dtype=torch.int64) + l.sum(dtype=torch.int64)

    for i in range(40):
        hp, hf = stager.host(64, 256)
        hp[:] = i % 251
        hf[:] = i
        sums.append(stager.dispatch(slow_sum))
    got = torch.stack(sums).cpu().tolist()
    assert got == [64 * 256 * (i % 251) + 64 * i for i in range(40)]
    # A larger tile grows every slot; a prefix dispatch copies the first rows.
    hp, hf = stager.host(128, 512)
    hp[:] = 3
    hf[:] = 1
    assert int(stager.dispatch(slow_sum, rows=5)) == 5 * 512 * 3 + 5


@pytest.fixture(scope="module")
def long_cap(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream_gpu") / "long.pcap"
    synth_udp_pcap(path, 200, payload_len=6000, payload_len_jitter=1500, patterns=STANDIN,
                   plant_rate=1.0, seed=10)
    return path


def _live(m, path, **kw):
    s = StreamMatcher(m, **kw)
    for b in FileReplaySource(path):
        s.feed_pcap_slice(b, "udp", bpf_filter=True)
    return s


@pytest.mark.parametrize("kw", [dict(), dict(tile_rows=64)], ids=["default", "small-tiles"])
def test_stream_matcher_packed_equals_plain(dev, cap, kw):
    """NUL-free set: one window_count_totals launch a full tile (and one for
    the partial tile at counts()), not one a 10-packet batch."""
    _reset()
    s = _live(Matcher(STANDIN, device=dev), cap, **kw)
    got = s.counts()
    assert got.tolist() == _live(Matcher(STANDIN, device="cpu"), cap, **kw).counts().tolist()
    assert got.sum() > 0 and s.tiles_dispatched >= 1
    assert cw.LAUNCHES["window_count_totals"] == s.tiles_dispatched < 200
    assert not any(ct.LAUNCHES.values()) and not any(sc.LAUNCHES.values())


def test_stream_matcher_unpacked_and_nul_equal_plain(dev, cap, monkeypatch):
    """Unpacked batches: one kernel launch a batch; the table route's class
    kernels for a forced table set; ac_scan for engine='ac'."""
    nul = STANDIN + [b"a\x00b"]
    # Batches of 10 packets with at least one UDP packet (the capture filter).
    batches = sum(1 for b in FileReplaySource(cap) if bpf_protocol_mask(b, "udp").any())
    for pats, kw, key in ((nul, {}, "window_count_totals"),
                          (STANDIN, dict(packed=False), "window_count_totals"),
                          (STANDIN, dict(packed=False, engine="ac"), "ac_scan")):
        _reset()
        s = _live(Matcher(pats, device=dev), cap, **kw)
        got = s.counts()
        assert got.tolist() == _live(Matcher(pats, device="cpu"), cap, **kw).counts().tolist()
        assert got.tolist() == _plain(pats, cap, dev).tolist()
        launches = {**cw.LAUNCHES, **sc.LAUNCHES}
        assert launches[key] == batches and s.tiles_dispatched == 0
    monkeypatch.setenv("MSM_PALLAS_TABLE", "1")
    _reset()
    s = _live(Matcher(STANDIN, device=dev), cap, packed=False)
    assert s.counts().tolist() == _plain(STANDIN, cap, dev).tolist()
    assert ct.LAUNCHES["filter_count_totals"] >= batches and not any(cw.LAUNCHES.values())


@pytest.mark.parametrize("engine,key", [("window", "window_count_halo"), ("ac", "ac_scan")])
def test_stream_matcher_long_payloads_equal_plain(dev, long_cap, engine, key):
    """Payloads past fixed_len: the halo kernel (window) or ac_scan with
    carried states (ac), one launch a 2,048-byte chunk of each batch."""
    _reset()
    s = _live(Matcher(STANDIN, device=dev), long_cap, packed=False, engine=engine)
    got = s.counts()
    launches = {**cw.LAUNCHES, **sc.LAUNCHES}  # before the one-shot counts below launch
    assert got.tolist() == _plain(STANDIN, long_cap, dev).tolist() and got.sum() > 0
    assert got.tolist() == Matcher(STANDIN, device=dev).count_pcap(long_cap).tolist()
    assert launches[key] >= 20 * 3  # 20 batches of 10, at least 3 chunks each
    others = {k: v for k, v in launches.items() if k != key and v}
    assert not others, others


def test_stream_matcher_dump_uses_row_kernels(dev, cap, tmp_path):
    from multithreading_string_matching_tpu_torch.io.pcap import PcapWriter

    outs = []
    for d in (dev, "cpu"):
        _reset()
        w = PcapWriter(tmp_path / f"{getattr(d, 'type', d)}.pcap")
        s = _live(Matcher(STANDIN, device=d), cap, dump_writer=w)
        s.flush()
        w.close()
        outs.append((s.counts().tolist(), w.packets_written))
        if d is dev:
            assert cw.LAUNCHES["window_count_rows"] >= 1
    assert outs[0] == outs[1] and outs[0][1] > 0
    assert (tmp_path / "cuda.pcap").read_bytes() == (tmp_path / "cpu.pcap").read_bytes()
