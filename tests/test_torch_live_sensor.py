"""The live sensor's loop (``parallel/stream.run_live``, what ``live`` runs)
on the benchmark's ``udp_b10`` mix, held to the benchmark's plain reference
(``gpubench/reference/udp_packets.py``):

- a pass equals the reference on a small seeded capture, at the mix's
  10-frame batches and at 7-frame batches into 16-row tiles of 256-byte
  rows, so that tile edges fall inside batches;
- TCP and ARP frames mixed into the replay change no count; the capture
  filter passes the UDP frames alone (``packets_seen``, ``LIVE["passed"]``)
  and ``LIVE["frames"]`` counts every frame fed;
- a stop after a feed ends the loop there, stops the source, and what was
  fed is counted; ``between`` runs before each batch;
- under ``torch.profiler`` a pass opens one ``msm.stream`` and the live
  path's spans: on an Ethernet capture one ``msm.decode`` a feed around the
  native walk and no ``msm.live.filter``; on the fallback (a raw-IP
  capture, ``MSM_NO_NATIVE=1``) the decode and the filter span a feed;
  ``LIVE["batches"]`` counts the feeds and ``LIVE["walked"]`` those walked;
- ``live`` runs its loop through ``run_live``;
- the ``live_sensor.udp_b10`` cell runs on the CPU at a small size and is
  correct, and not correct when one feed in ten is dropped;
- the cell's readers on canned traces and probes (the walk's share among
  them), and its packing reader, whose self time
  (``gpubench/metrics/_nested.py``) equals the stream cells' on canned and
  profiled traces.

Counts are integers and compared exactly; the file imports no JAX.  The
test marked ``gpu`` runs only on the card::

    python -m pytest --noconftest tests/test_torch_live_sensor.py -q -m gpu
"""

import json
import pathlib
import struct

import numpy as np
import pytest
import torch

from gpubench import registry, run, trace
from gpubench.gen.inputs import entry_weights, load_rules
from gpubench.gen.synth import classic_global_header
from gpubench.metrics import _nested, _spans
from gpubench.reference.udp_packets import capture_counts
from gpubench.tests.test_faults import break_stream
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io import live_walk, native
from multithreading_string_matching_tpu_torch.io.live import FileReplaySource
from multithreading_string_matching_tpu_torch.parallel import stream as pt_stream

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RULES = ROOT / "gpubench" / "gen" / "strings_standin.txt"
PATTERNS = load_rules({"rules": {"file": "gpubench/gen/strings_standin.txt"}}, ROOT)
CELL = "live_sensor.udp_b10"
PACKETS = 3000
SEED = 2**31 + 2626
ARGS = registry.traffic("udp_b10")["entry_args"]
LIVE_SPANS = ("msm.stream", "msm.ingest", "msm.live.feed", "msm.decode", "msm.pack",
              "msm.stage.dispatch")
SPAN_READERS = ("ingest_ms_per_MB.live", "decode_ms_per_MB.live", "pack_ms_per_MB.live",
                "live_filter_ms_per_MB.live", "live_feed_ms_per_MB.live")


def stream_of(matcher, batch=ARGS["batch_packets"], tile_rows=ARGS["tile_rows"],
              pack_width=ARGS["pack_width"]):
    return pt_stream.StreamMatcher(matcher, batch_size=batch, fixed_len=ARGS["fixed_len"],
                                   tile_rows=tile_rows, pack_width=pack_width)


def cpu_matcher():
    return Matcher(PATTERNS, engine="pallas", device="cpu")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    cap = registry.traffic("udp_b10")["capture"]
    cap.update(packets=PACKETS)
    path = tmp_path_factory.mktemp("live_sensor") / "udp_b10.pcap"
    nbytes = registry.generator("udp").write(
        path, cap, PATTERNS, entry_weights(PATTERNS, cap["plant_weights"]), SEED)
    counts, ref_bytes = capture_counts(path, PATTERNS, "udp")
    return path, nbytes, counts, ref_bytes


def records(path):
    """The frames of a classic capture, in order."""
    data = pathlib.Path(path).read_bytes()
    out, pos = [], 24
    while pos < len(data):
        incl = struct.unpack_from("<I", data, pos + 8)[0]
        out.append(data[pos + 16 : pos + 16 + incl])
        pos += 16 + incl
    return out


def write_frames(path, frames, linktype=1):
    with open(path, "wb") as f:
        f.write(classic_global_header(linktype))
        for i, fr in enumerate(frames):
            f.write(struct.pack("<IIII", i, 0, len(fr), len(fr)) + fr)
    return path


def tcp_frame(payload):
    tcp = struct.pack(">HHIIHHHH", 40000, 80, 1, 0, (5 << 12) | 0x18, 65535, 0, 0)
    ip = struct.pack(">BBHHHBBH4B4B", 0x45, 0, 40 + len(payload), 0, 0, 64, 6, 0,
                     10, 0, 0, 1, 10, 0, 0, 2)
    return bytes(12) + b"\x08\x00" + ip + tcp + payload


def arp_frame():
    body = struct.pack(">HHBBH6s4s6s4s", 1, 0x0800, 6, 4, 1, bytes(6), bytes(4), bytes(6),
                       bytes(4))
    return bytes(12) + b"\x08\x06" + body + bytes(18)


@pytest.mark.parametrize("batch,tile_rows,pack_width", [
    (ARGS["batch_packets"], ARGS["tile_rows"], ARGS["pack_width"]),
    (7, 16, 256),
], ids=["mix", "tile-edges-inside-batches"])
def test_pass_equals_the_reference(capture, batch, tile_rows, pack_width):
    path, nbytes, want, ref_bytes = capture
    sm = stream_of(cpu_matcher(), batch, tile_rows, pack_width)
    assert pt_stream.run_live(sm, str(path), "udp") is None
    got = sm.counts()
    np.testing.assert_array_equal(got, want)
    assert want.sum() >= PACKETS and nbytes == ref_bytes
    assert sm.packets_seen == PACKETS
    if tile_rows == 16:
        # ~3 rows a 7-frame feed: most tiles end inside a feed's rows.
        assert sm.tiles_dispatched > PACKETS // batch * 2 // tile_rows


def test_tcp_and_arp_frames_change_no_count(capture, tmp_path):
    path, _, want, _ = capture
    udp = records(path)[:400]
    mixed = []
    for i, fr in enumerate(udp):
        mixed.append(fr)
        if i % 3 == 0:
            mixed.append(tcp_frame(b"x" + PATTERNS[i % len(PATTERNS)] + b"youtube"))
        if i % 5 == 0:
            mixed.append(arp_frame())
    n_udp, n_all = len(udp), len(mixed)
    only = write_frames(tmp_path / "udp.pcap", udp)
    both = write_frames(tmp_path / "mixed.pcap", mixed)
    results = []
    for p in (only, both):
        before = dict(pt_stream.LIVE)
        sm = stream_of(cpu_matcher())
        pt_stream.run_live(sm, str(p), "udp")
        fed = {k: pt_stream.LIVE[k] - before[k] for k in before}
        results.append((sm.counts(), sm.packets_seen, fed))
    (c_only, seen_only, fed_only), (c_both, seen_both, fed_both) = results
    np.testing.assert_array_equal(c_both, c_only)
    np.testing.assert_array_equal(c_only, capture_counts(only, PATTERNS, "udp")[0])
    assert c_only.sum() >= n_udp
    assert seen_only == seen_both == fed_both["passed"] == fed_only["passed"] == n_udp
    assert fed_only["frames"] == n_udp and fed_both["frames"] == n_all > n_udp + 100
    assert fed_both["batches"] == -(-n_all // ARGS["batch_packets"])


class _StoppableSource:
    """A replay with a ``stop`` (as ``LiveSource`` has) that counts its calls."""

    def __init__(self, path, batch):
        self.replay = FileReplaySource(path, batch_size=batch)
        self.stops = 0

    def __iter__(self):
        return iter(self.replay)

    def stop(self):
        self.stops += 1


def test_a_stop_after_a_feed_ends_the_loop_and_counts_what_was_fed(capture, tmp_path):
    path, _, _, _ = capture
    batch, stop_at = ARGS["batch_packets"], 37
    source = _StoppableSource(str(path), batch)
    seen = []

    def between(sm):
        seen.append(sm.packets_seen)
        if len(seen) == stop_at:
            sm.stopped = True

    sm = stream_of(cpu_matcher())
    pt_stream.run_live(sm, source, "udp", between=between)
    fed = stop_at * batch
    # between ran before each batch; the batch it stopped was still fed.
    assert seen == [i * batch for i in range(stop_at)]
    assert source.stops == 1 and sm.packets_seen == fed
    # The partial tile was flushed by the loop: counts() finds no tile left.
    assert sm._tiles._r == 0 and sm.tiles_dispatched == 1
    part = write_frames(tmp_path / "part.pcap", records(path)[:fed])
    np.testing.assert_array_equal(sm.counts(), capture_counts(part, PATTERNS, "udp")[0])


def profiled_pass(path, tmp_path, batch=7):
    """``run_live`` over ``path`` under the profiler, at ``batch`` frames a
    feed into 16-row tiles: the stream, its Chrome trace's events (written
    into ``tmp_path``), the spans by name, and what ``LIVE`` counted."""
    before = dict(pt_stream.LIVE)
    sm = stream_of(cpu_matcher(), batch, 16, 256)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.PASS_SPAN):
            pt_stream.run_live(sm, path, "udp")
    fed = {k: pt_stream.LIVE[k] - before[k] for k in before}
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return sm, events, spans, fed


def assert_feeds_hold(spans, names):
    """Each span of ``names`` lies inside one ``msm.live.feed``."""
    feeds_iv = sorted(spans["msm.live.feed"])
    for name in names:
        for a, b in spans[name]:
            i = np.searchsorted([f[0] for f in feeds_iv], a, side="right") - 1
            assert feeds_iv[i][0] <= a and b <= feeds_iv[i][1], name


def test_spans_open_under_the_profiler_and_live_counts_the_feeds(capture, tmp_path):
    path, nbytes, want, _ = capture
    batch = 7
    sm, events, spans, fed = profiled_pass(path, tmp_path, batch)
    np.testing.assert_array_equal(sm.counts(), want)
    feeds = -(-PACKETS // batch)
    # Every feed of an Ethernet capture takes the one native walk.
    assert fed == {"batches": feeds, "frames": PACKETS, "passed": PACKETS, "walked": feeds}
    assert set(LIVE_SPANS) <= set(spans) and "msm.live.filter" not in spans
    assert len(spans["msm.stream"]) == 1
    # The capture's read, each batch, and the read that finds the end.
    assert len(spans["msm.ingest"]) == feeds + 2
    assert len(spans["msm.live.feed"]) == feeds
    assert len(spans["msm.decode"]) == len(spans["msm.pack"]) == feeds
    assert len(spans["msm.stage.dispatch"]) == sm.tiles_dispatched
    (s0, s1), = spans["msm.stream"]
    assert all(s0 <= a and b <= s1 for name, iv in spans.items()
               if name not in ("msm.stream", trace.PASS_SPAN) for a, b in iv)
    # Each feed holds its walk and its packing.
    assert_feeds_hold(spans, ("msm.decode", "msm.pack"))
    # The live cell's span readers read this trace; the fast self time is
    # the stream cells' own number.  No filter span: its reader is silent.
    rec = trace.reduce_events(events)
    rec.update(traced_payload_bytes=nbytes, probes={"live": fed})
    for name in ("msm.pack", "msm.live.feed", "msm.stream", "msm.stage.dispatch"):
        assert _nested.self_ms(rec, name) == _spans.self_ms(rec, name) > 0, name
    for metric in SPAN_READERS:
        got = registry.reader(metric).read(rec)
        assert (got is None) if metric == "live_filter_ms_per_MB.live" else got > 0, metric
    assert registry.reader("live_walk_share.live").read(rec) == 100.0


@pytest.mark.parametrize("fallback", ["raw-ip", "no-native"])
def test_the_fallback_opens_the_filter_span_a_feed_and_walks_nothing(capture, tmp_path,
                                                                    monkeypatch, fallback):
    """A raw-IP capture, or ``MSM_NO_NATIVE=1``, keeps the two numpy walks:
    ``msm.decode`` and ``msm.live.filter`` once a feed, ``walked`` at 0."""
    path, nbytes, want, _ = capture
    batch = 7
    if fallback == "raw-ip":
        path = write_frames(tmp_path / "raw.pcap", [fr[14:] for fr in records(path)],
                            linktype=101)
    else:
        monkeypatch.setenv("MSM_NO_NATIVE", "1")
        for mod in (live_walk, native):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", False)
    sm, events, spans, fed = profiled_pass(path, tmp_path, batch)
    np.testing.assert_array_equal(sm.counts(), want)
    feeds = -(-PACKETS // batch)
    assert fed == {"batches": feeds, "frames": PACKETS, "passed": PACKETS, "walked": 0}
    assert len(spans["msm.live.feed"]) == len(spans["msm.live.filter"]) == feeds
    assert len(spans["msm.decode"]) == len(spans["msm.pack"]) == feeds
    assert_feeds_hold(spans, ("msm.decode", "msm.live.filter", "msm.pack"))
    rec = trace.reduce_events(events)
    rec.update(traced_payload_bytes=nbytes, probes={"live": fed})
    for metric in SPAN_READERS:
        assert registry.reader(metric).read(rec) > 0, metric
    assert registry.reader("live_walk_share.live").read(rec) == 0.0


def test_live_runs_its_loop_through_run_live(capture, capsys, monkeypatch):
    path, _, want, _ = capture
    calls = []
    real = pt_stream.run_live

    def counted(sm, source, mode, **kw):
        calls.append((mode, sorted(kw)))
        return real(sm, source, mode, **kw)

    monkeypatch.setattr(pt_stream, "run_live", counted)
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    assert pt_main(["live", str(path), str(RULES), "udp"]) == 0
    out = capsys.readouterr().out
    assert calls == [("udp", ["between"])]
    assert f"\n\n{PACKETS} packet sniffed\n\n" in out
    reported = {ln.split(": ")[0]: int(ln.split(": ")[1].split()[0])
                for ln in out.splitlines() if ln.endswith(" times!")}
    first = {}
    for p, c in zip(PATTERNS, want.tolist()):
        first.setdefault(p.decode(), c)
    assert reported == {p: c for p, c in first.items() if c}


def small_run(seed=SEED):
    result, _ = run.run_cell(CELL, seed, 0.2, False, device="cpu",
                             capture_overrides={"packets": PACKETS})
    return result


def test_the_cell_runs_correct_on_the_cpu():
    result = small_run()
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"stream_MBps", "setup_s"}
    assert all(c["value"] == 0 == c["limit"] for c in result["checks"].values())


def test_the_cell_is_not_correct_when_a_feed_in_ten_is_dropped(monkeypatch):
    real = pt_stream.StreamMatcher.feed_pcap_slice
    fed = {"n": 0}

    def lossy(self, pcap, *a, **kw):
        fed["n"] += 1
        if fed["n"] % 10:
            return real(self, pcap, *a, **kw)

    monkeypatch.setattr(pt_stream.StreamMatcher, "feed_pcap_slice", lossy)
    result = small_run()
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] == result["attempted"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_the_cell_is_not_correct_with_the_tile_count_broken(monkeypatch, fault):
    """The benchmark's own faults under the timed path: a pass that returns
    its state unchanged, half the rows counted double, one answer altered."""
    break_stream(monkeypatch, fault)
    result = small_run()
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] == result["attempted"] >= 1


def span(name, t0, t1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0}


def records_of(host, nbytes=2_000_000, probes=None, request=True):
    """One traced pass, 0-4,000 us, one ``msm.stream`` call where
    ``request``, and ``host`` beside it; ``nbytes`` of payload."""
    events = [span(trace.PASS_SPAN, 0, 4000)] + host
    if request:
        events.append(span("msm.stream", 10, 3990))
    rec = trace.reduce_events(events)
    rec.update(kernel_names=[], traced_payload_bytes=nbytes, patterns=1, hbm_bytes_per_s=None,
               counters={}, probes=probes or {})
    return rec


FEEDS = [
    span("msm.ingest", 100, 200),
    span("msm.live.feed", 200, 1200),
    span("msm.decode", 250, 450),
    span("msm.live.filter", 500, 600),
    span("msm.pack", 700, 1100),
    span("msm.stage.dispatch", 900, 1000),
    span("aten::copy_", 950, 960, "cpu_op"),       # not a msm span: the feed's own
    span("msm.live.feed", 1500, 2100),
    span("msm.live.filter", 1600, 1900),
    span("msm.live.feed", 3900, 4300),             # 100 us inside the window
    span("msm.live.filter", 4100, 4200),           # past the window
]


@pytest.mark.parametrize("metric,want", [
    # 1,000 - (200 + 100 + 400); 600 - 300; 100: over 2 MB
    ("live_feed_ms_per_MB.live", (300 + 300 + 100) / 1e3 / 2),
    ("live_filter_ms_per_MB.live", (100 + 300) / 1e3 / 2),
])
def test_span_readers_on_canned_traces(metric, want):
    reader = registry.reader(metric)
    assert reader.read(records_of(FEEDS)) == pytest.approx(want)
    assert reader.read(records_of(FEEDS, request=False)) is None
    # A program with the request span but none of the live path's.
    assert reader.read(records_of(FEEDS[:1])) is None


def test_the_packing_reader_reads_the_stream_cells_number():
    """``pack_ms_per_MB.live`` has a file of its own (``_nested.self_ms``)
    and reads what ``pack_ms_per_MB.py`` reads: 400 - 100 us over 2 MB."""
    live, family = registry.reader("pack_ms_per_MB.live"), registry.reader("pack_ms_per_MB")
    assert live is not family and live.__name__ != family.__name__
    rec = records_of(FEEDS)
    assert live.read(rec) == family.read(rec) == pytest.approx(300 / 1e3 / 2)
    assert live.read(records_of(FEEDS, request=False)) is None
    for name in ("msm.live.feed", "msm.pack", "msm.stream", "msm.live.filter"):
        assert _nested.self_ms(rec, name) == _spans.self_ms(rec, name)


def test_walk_share_reader_reads_the_live_probe():
    """``live_walk_share.live``: 100 x ``walked`` / ``batches``; nothing to
    read from a probe without ``walked`` (a program without the walk)."""
    reader = registry.reader("live_walk_share.live")
    live = {"batches": 10_000, "frames": 100_000, "passed": 99_990, "walked": 10_000}
    assert reader.read(records_of([], probes={"live": live})) == 100.0
    assert reader.read(records_of([], probes={"live": dict(live, walked=2_500)})) == 25.0
    assert reader.read(records_of([], probes={"live": dict(live, walked=0)})) == 0.0
    parent = {k: v for k, v in live.items() if k != "walked"}
    assert reader.read(records_of([], probes={"live": parent})) is None
    assert reader.read(records_of([], probes={})) is None
    assert reader.read(records_of([], probes={"live": dict(live, batches=0)})) is None


def test_frames_reader_reads_the_live_probe():
    reader = registry.reader("live_feed_frames.live")
    live = {"batches": 10_000, "frames": 100_000, "passed": 99_990}
    assert reader.read(records_of([], probes={"live": live})) == 10.0
    assert reader.read(records_of([], probes={"live": dict(live, frames=70_001)})) == \
        pytest.approx(7.0001)
    assert reader.read(records_of([], probes={})) is None
    assert reader.read(records_of([], probes={"live": dict(live, batches=0)})) is None


@pytest.mark.gpu
def test_a_pass_on_the_card_equals_the_reference_and_names_its_spans(capture):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    path, _, want, _ = capture
    sm = stream_of(Matcher(PATTERNS, engine="pallas", device="cuda"))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pt_stream.run_live(sm, path, "udp")
        got = sm.counts()
    np.testing.assert_array_equal(got, want)
    assert sm.packets_seen == PACKETS and sm.tiles_dispatched >= 1
    names = {e.key for e in prof.key_averages()}
    assert set(LIVE_SPANS) | {"msm.drain", "msm_window_count_totals"} <= names
