"""The sequence-order flow monitor (``FlowStreamMatcher(reorder=True)`` under
``parallel/flow_stream.count_pcap_flows_streamed``, what ``match --flows
--reorder --stream`` runs) on the benchmark's ``tcp_wan`` mix, held to the
benchmark's plain reference of the one-round reorder window
(``gpubench/reference/tcp_reorder.py``).

- the generator writes the same bytes for the same seed, ``tcp_flows``'
  capture with no disorder, its disorder shares within their binomial
  spread, retransmissions that carry their original's header fields, and
  returns the payload bytes on the wire;
- on several seeds of a small capture with many rounds, at least one
  reordering across a round's edge among them, the pass equals the
  reference entry by entry on the window rounds and on the AC rounds;
- the reference catches three faults: the same capture without
  ``reorder``, retransmitted bytes kept, and a window of the whole
  capture;
- ``msm.flow.reorder`` opens once a round with ``reorder`` and never
  without; the four ``reorder_*`` keys of ``FLOWS`` equal what the
  reference counts, and stay still without ``reorder``;
- the reference's two constants are the traffic's ``entry_args`` and the
  CLI's defaults, which ``match --flows --reorder --stream`` passes;
- the cell's readers, and a small CPU run of the cell: correct, and not
  correct on a monitor without ``reorder``.

Counts are integers and compared exactly; the file imports no JAX.  The
test marked ``gpu`` runs only on the card::

    python -m pytest --noconftest tests/test_torch_flow_reassembly.py -q -m gpu
"""

import json
import pathlib
import struct

import numpy as np
import pytest
import torch

from gpubench import registry, run, trace
from gpubench.gen.inputs import load_rules
from gpubench.gen.synth import classic_global_header
from gpubench.reference import count_payloads, tcp_flows, tcp_reorder
from gpubench.reference.pcap import read_records
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.parallel import flow_stream

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RULES = ROOT / "gpubench" / "gen" / "strings_standin.txt"
PATTERNS = load_rules({"rules": {"file": "gpubench/gen/strings_standin.txt"}}, ROOT)
CELL = "flow_reassembly.tcp_wan"
WAN = registry.generator("tcp_wan")
# The cell's mix cut to 60 connections of small responses, densely planted,
# with denser disorder than the cell's so that each kind shows in a few
# hundred segments.
SMALL = {"connections": 60, "concurrent": 8, "plant_every": 400,
         "response_len": {"alpha": 1.2, "min": 1500, "max": 30000},
         "retransmit_share": 0.1, "reorder_share": 0.1, "conflict_share": 0.02}
# Rounds of 16-record chunks: ~40 rounds a capture, and a delayed segment
# now and then lands past its round's edge.
STREAM = {"batch_packets": 16, "scan_bytes": 4096, "width": 256, "min_lanes": 4}
SEEDS = [2**31 + 1, 2**31 + 2, 2**31 + 3, 2**40 + 6]
NO_DISORDER = {"retransmit_share": 0.0, "reorder_share": 0.0, "conflict_share": 0.0}


def mix(**over):
    cap = registry.traffic("tcp_wan")["capture"]
    cap.update(SMALL, **over)
    return cap


def monitor(engine="window", **over):
    opts = {k: STREAM[k] for k in ("scan_bytes", "width", "min_lanes")}
    opts.update(over)
    return flow_stream.FlowStreamMatcher(Matcher(PATTERNS, engine="pallas", device="cpu"), "tcp",
                                         engine=engine, **opts)


def reference(path, **over):
    opts = {"batch_packets": STREAM["batch_packets"], "scan_bytes": STREAM["scan_bytes"]}
    opts.update(over)
    return tcp_reorder.reassemble(path, **opts)


def counts_of(streams):
    return count_payloads(list(streams.values()), PATTERNS)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """``seed -> (path, wire bytes, reference reassembly, reference counts)``."""
    out = {}
    for seed in SEEDS:
        path = tmp_path_factory.mktemp("tcp_wan") / f"wan{seed}.pcap"
        nbytes = WAN.write(path, mix(), PATTERNS, None, seed)
        r = reference(path)
        out[seed] = (path, nbytes, r, counts_of(r.streams))
    return out


def test_generator_same_seed_same_bytes_and_its_wire_bytes(tmp_path):
    a, b, c = tmp_path / "a.pcap", tmp_path / "b.pcap", tmp_path / "c.pcap"
    na, nb = WAN.write(a, mix(), PATTERNS, None, SEEDS[0]), WAN.write(b, mix(), PATTERNS, None,
                                                                   SEEDS[0])
    nc = WAN.write(c, mix(), PATTERNS, None, SEEDS[1])
    assert a.read_bytes() == b.read_bytes() != c.read_bytes()
    # The bytes returned are every TCP payload on the wire, retransmissions
    # included: the reference's held bytes and the monitor's.
    assert na == nb == reference(a).held_bytes == tcp_flows.capture_counts(a, PATTERNS)[1]
    assert nc == reference(c).held_bytes
    fs = monitor(reorder=True)
    flow_stream.count_pcap_flows_streamed(fs, str(a), batch_packets=STREAM["batch_packets"])
    assert fs.bytes_seen == na
    f, _, _ = WAN.frames(mix(), PATTERNS, None, SEEDS[0])
    assert na == int(f["plen"].sum()) > 0
    # Capture times run forward through the moved and added frames.
    data = a.read_bytes()
    times = [struct.unpack_from("<II", data, off - 16) for off, _, _ in read_records(data)]
    assert len(times) == len(f["conn"]) and times == sorted(times)


def test_generator_without_disorder_writes_the_tcp_flows_capture(tmp_path):
    a, b = tmp_path / "wan.pcap", tmp_path / "flows.pcap"
    for over in ({}, {"packets": 300}):
        na = WAN.write(a, mix(**NO_DISORDER, **over), PATTERNS, None, SEEDS[2])
        nb = registry.generator("tcp_flows").write(b, mix(**over), PATTERNS, None, SEEDS[2])
        assert na == nb and a.read_bytes() == b.read_bytes()


def test_generator_disorder_shares_and_headers():
    """The cell's shares over ~20,000 data segments, each within five of its
    binomial standard deviations; every retransmission carries its
    original's sequence number (plus its offset) and acknowledgement, a
    conflicting one other bytes of the same length."""
    cap = registry.traffic("tcp_wan")["capture"]
    cap.update(connections=1500, concurrent=256)
    f, source, _ = WAN.frames(cap, PATTERNS, None, SEEDS[3])
    data = f["plen"] > 0
    kind = f["kind"][data]
    n = int((kind == WAN.ORIGINAL).sum())
    assert n > 15_000

    def near(got, p, of):
        assert abs(got - p * of) <= 5 * np.sqrt(p * (1 - p) * of) + 1, (got, p, of)

    retx = int(np.isin(kind, [WAN.RETRANSMIT, WAN.RESEGMENT]).sum())
    near(retx, cap["retransmit_share"], n)
    near(int((kind == WAN.RESEGMENT).sum()), cap["resegment_share"], retx)
    near(int((kind == WAN.CONFLICT).sum()), cap["conflict_share"], n)
    # A delay past the last segment of its direction moves nothing: at most
    # the share, and most of it.
    delayed = int(f["delayed"].sum())
    assert 0.6 * cap["reorder_share"] * n <= delayed
    assert delayed <= cap["reorder_share"] * n + 5 * np.sqrt(cap["reorder_share"] * n)

    originals = {}                               # direction -> [(seq, frame)]
    for i in np.flatnonzero(data & (f["kind"] == WAN.ORIGINAL)).tolist():
        originals.setdefault((int(f["conn"][i]), int(f["side"][i])), []).append(
            (int(f["seq"][i]), i))
    for i in np.flatnonzero(f["kind"] != WAN.ORIGINAL).tolist():
        q = int(f["seq"][i])
        # The original this one sends again: the one whose bytes it starts
        # at (exactly, unless re-segmented).
        o = next(j for qq, j in originals[(int(f["conn"][i]), int(f["side"][i]))]
                 if (q - qq) % 2**32 < int(f["plen"][j]))
        if f["kind"][i] == WAN.RESEGMENT:
            assert q != f["seq"][o]
        else:
            assert q == f["seq"][o] and f["plen"][i] == f["plen"][o]
        assert o < i or f["delayed"][o]
        assert f["ack"][i] == f["ack"][o]
        a, b = int(f["src"][i]), int(f["src"][o]) + (q - int(f["seq"][o])) % 2**32
        same = bytes(source[a : a + int(f["plen"][i])]) == bytes(source[b : b + int(f["plen"][i])])
        assert same == (f["kind"][i] != WAN.CONFLICT)


def test_a_reordering_crosses_a_round_among_the_seeds(captures):
    """Among the seeds, a delayed segment lands past its round's edge: the
    one-round window then gives a stream other than a whole-capture one."""
    lost = [seed for seed, (path, _, r, _) in captures.items()
            if r.streams != reference(path, scan_bytes=1 << 40).streams]
    assert lost
    assert all(r.rounds >= 3 and r.moved > 0 and r.trimmed_bytes > 0
               for _, _, r, _ in captures.values())


# The window rounds (the card's engine) on every seed; the AC rounds, a
# dozen seconds a pass on the CPU, on one.
@pytest.mark.parametrize("seed,engine", [(s, "window") for s in SEEDS] + [(SEEDS[0], "ac")])
def test_pass_equals_the_reference(captures, seed, engine):
    path, nbytes, r, want = captures[seed]
    fs = monitor(engine, reorder=True)
    got = flow_stream.count_pcap_flows_streamed(fs, str(path),
                                                batch_packets=STREAM["batch_packets"])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and want.sum() > 100
    assert fs.bytes_seen == nbytes == r.held_bytes
    assert fs._round == r.rounds >= 3


def keep_retransmissions(path):
    """A fault: each flow's segments of the whole capture in sequence
    order, every byte kept, overlaps and all."""
    segs = {}
    for _, key, seq, payload in tcp_reorder.tcp_segments(path):
        segs.setdefault(key, []).append((seq, payload))
    out = {}
    for key, lst in segs.items():
        base = lst[0][0]
        out[key] = b"".join(p for _, p in sorted(lst, key=lambda s: tcp_reorder.signed(
            s[0] - base)))
    return out


@pytest.mark.parametrize("fault", ["no_reorder", "keep_retransmissions", "whole_capture"])
def test_the_reference_catches_the_faults(captures, fault):
    differ = []
    for seed, (path, _, _, want) in captures.items():
        if fault == "no_reorder":
            got = flow_stream.count_pcap_flows_streamed(
                monitor(reorder=False), str(path), batch_packets=STREAM["batch_packets"])
        elif fault == "keep_retransmissions":
            got = counts_of(keep_retransmissions(path))
        else:
            got = counts_of(reference(path, scan_bytes=1 << 40).streams)
        differ.append(bool((got != want).any()))
    # The window's fault shows only where a reordering crosses a round.
    assert all(differ) if fault != "whole_capture" else any(differ)


def spans_of(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return spans


@pytest.mark.parametrize("reorder", [True, False], ids=["reorder", "capture_order"])
def test_the_reorder_span_and_counters(captures, tmp_path, reorder):
    path, _, r, _ = captures[SEEDS[0]]
    before = dict(flow_stream.FLOWS)
    fs = monitor(reorder=reorder)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        flow_stream.count_pcap_flows_streamed(fs, str(path), batch_packets=STREAM["batch_packets"])
    spans = spans_of(prof, tmp_path)
    moved = {k: flow_stream.FLOWS[k] - before[k] for k in before}
    keys = ("reorder_segments", "reorder_held_bytes", "reorder_moved", "reorder_trimmed_bytes")
    if reorder:
        assert len(spans["msm.flow.reorder"]) == fs._round == r.rounds
        layouts = spans["msm.flow.layout"]
        assert all(any(a <= c and d <= b for a, b in layouts) for c, d in spans["msm.flow.reorder"])
        assert [moved[k] for k in keys] == [r.segments, r.held_bytes, r.moved, r.trimmed_bytes]
        assert moved["real_bytes"] == r.held_bytes - r.trimmed_bytes
    else:
        assert "msm.flow.reorder" not in spans and fs._round > 3
        assert [moved[k] for k in keys] == [0, 0, 0, 0]
    assert moved["feed_segments"] == r.segments


def test_counters_on_a_hand_built_flow(tmp_path):
    """One flow: the segment at 11 arrives before the one at 7, the one at 4
    twice (the second copy other bytes), the first again after its round.
    Six segments held, one moved, 3 + 4 bytes trimmed; first bytes win."""
    segs = [(0, b"abcd"), (4, b"efg"), (4, b"XYZ"), (11, b"lmno"), (7, b"hijk"), (0, b"abcd")]
    path = tmp_path / "hand.pcap"
    with open(path, "wb") as fh:
        fh.write(classic_global_header())
        for i, (seq, payload) in enumerate(segs):
            tcp = struct.pack(">HHIIHHHH", 40000, 80, 1000 + seq, 0, (5 << 12) | 0x18, 65535, 0,
                              0)
            ip = bytearray(20)
            ip[0], ip[9], ip[2:4] = 0x45, 6, (40 + len(payload)).to_bytes(2, "big")
            ip[12:16], ip[16:20] = bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2])
            fr = bytes(12) + b"\x08\x00" + bytes(ip) + tcp + payload
            fr += bytes(max(0, 60 - len(fr)))
            fh.write(struct.pack("<IIII", i, 0, len(fr), len(fr)) + fr)
    r = tcp_reorder.reassemble(path, batch_packets=5, scan_bytes=1)
    assert list(r.streams.values()) == [bytearray(b"abcdefghijklmno")]
    assert (r.rounds, r.segments, r.moved, r.trimmed_bytes) == (2, 6, 1, 7)
    before = dict(flow_stream.FLOWS)
    pats = [b"efgh", b"XYZ", b"abcd", b"klmn"]
    fs = flow_stream.FlowStreamMatcher(Matcher(pats, device="cpu"), "tcp", engine="window",
                                       reorder=True, scan_bytes=1, width=4, min_lanes=2)
    got = flow_stream.count_pcap_flows_streamed(fs, str(path), batch_packets=5)
    assert got.tolist() == [1, 0, 1, 1]
    moved = {k: flow_stream.FLOWS[k] - before[k] for k in before}
    assert (moved["reorder_segments"], moved["reorder_moved"], moved["reorder_held_bytes"],
            moved["reorder_trimmed_bytes"]) == (6, 1, 22, 7)


def test_the_constants_are_the_cells_and_the_clis(captures, capsys, monkeypatch):
    """The reference's window is the traffic's chunk and the CLI's defaults,
    and ``match --flows --reorder --stream`` runs the pass on a
    ``reorder`` monitor with them."""
    assert registry.traffic("tcp_wan")["entry_args"]["batch_packets"] == tcp_reorder.BATCH_PACKETS
    assert registry.traffic("tcp_wan")["entry"] == "flow_reorder"
    cfg = registry.config(registry.load_benchmark(ROOT), "flow_reassembly", ROOT)
    assert cfg["reference"] == "tcp_reorder" and cfg["reduced"] == []
    path, nbytes, _, _ = captures[SEEDS[1]]
    calls = []
    real = flow_stream.count_pcap_flows_streamed

    def counted(fs, *a, **kw):
        calls.append((fs.reorder, fs.scan_bytes, kw["batch_packets"]))
        return real(fs, *a, **kw)

    monkeypatch.setattr(flow_stream, "count_pcap_flows_streamed", counted)
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.delenv("MSM_FLOW_BATCH", raising=False)
    assert pt_main(["match", "--pcap", str(path), "--patterns", str(RULES), "--mode", "tcp",
                    "--flows", "--reorder", "--stream", "--json"]) == 0
    blob = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert calls == [(True, tcp_reorder.SCAN_BYTES, tcp_reorder.BATCH_PACKETS)]
    want, ref_bytes = tcp_reorder.capture_counts(path, PATTERNS, "tcp")
    assert blob["counts"] == want.tolist() and blob["stream_bytes"] == nbytes == ref_bytes


def span(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": t0, "dur": t1 - t0}


def test_the_cells_readers():
    events = [span(trace.PASS_SPAN, 0, 4000), span("msm.stream", 10, 3990),
              span("msm.flow.layout", 600, 1600), span("msm.flow.reorder", 700, 1200),
              span("msm.flow.dispatch", 1300, 1400), span("msm.flow.layout", 2000, 2600),
              span("msm.flow.reorder", 2100, 2400), span("msm.drain", 2200, 2300)]
    rec = trace.reduce_events(events)
    rec.update(traced_payload_bytes=2_000_000, probes={
        "flows": {"reorder_held_bytes": 4000, "reorder_trimmed_bytes": 120}})
    assert registry.reader("flow_reorder_ms_per_MB.reorder").read(rec) == \
        pytest.approx((500 + 300 - 100) / 1e3 / 2)
    assert registry.reader("flow_layout_ms_per_MB.reorder").read(rec) == \
        pytest.approx((1000 - 500 - 100 + 600 - 300) / 1e3 / 2)
    assert registry.reader("reorder_trim_share.reorder").read(rec) == pytest.approx(3.0)
    # A program without the span or the counter keys reads nothing.
    bare = trace.reduce_events([e for e in events if e["name"] != "msm.flow.reorder"])
    bare.update(traced_payload_bytes=2_000_000, probes={"flows": {"real_bytes": 1}})
    assert registry.reader("flow_reorder_ms_per_MB.reorder").read(bare) is None
    assert registry.reader("reorder_trim_share.reorder").read(bare) is None


CELL_SMALL = {"connections": 40, "concurrent": 6, "plant_every": 300,
              "response_len": {"alpha": 1.2, "min": 1500, "max": 6000},
              "retransmit_share": 0.1, "reorder_share": 0.05, "conflict_share": 0.02}


def test_the_cell_runs_correct_on_the_cpu_and_catches_a_monitor_without_reorder(monkeypatch):
    result, _ = run.run_cell(CELL, SEEDS[3], 0.2, True, device="cpu",
                             capture_overrides=CELL_SMALL)
    assert result["correct"] is True and result["attempted"] >= 1
    assert all(c["value"] == 0 == c["limit"] for c in result["checks"].values())
    # On the CPU no device metric reads; every host one does.
    assert set(result["metrics"]) == {"flow_reorder_ms_per_MB.reorder",
                                      "reorder_trim_share.reorder",
                                      "flow_feed_ms_per_MB.reorder",
                                      "flow_layout_ms_per_MB.reorder"}
    assert 0 < result["metrics"]["reorder_trim_share.reorder"]["value"] < 100
    init = flow_stream.FlowStreamMatcher.__init__

    def without_reorder(self, *a, **kw):
        init(self, *a, **dict(kw, reorder=False))

    monkeypatch.setattr(flow_stream.FlowStreamMatcher, "__init__", without_reorder)
    result, _ = run.run_cell(CELL, SEEDS[3], 0.2, False, device="cpu",
                             capture_overrides=CELL_SMALL)
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] == result["attempted"] >= 1


@pytest.mark.gpu
def test_a_pass_on_the_card_equals_the_reference_and_opens_the_reorder_span(captures):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    path, _, r, want = captures[SEEDS[0]]
    matcher = Matcher(PATTERNS, engine="pallas", device="cuda")
    fs = flow_stream.FlowStreamMatcher(
        matcher, "tcp", engine=flow_stream.flow_stream_engine(matcher), reorder=True,
        **{k: STREAM[k] for k in ("scan_bytes", "width", "min_lanes")})
    assert fs.engine == "window"
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = flow_stream.count_pcap_flows_streamed(fs, str(path),
                                                    batch_packets=STREAM["batch_packets"])
    np.testing.assert_array_equal(got, want)
    assert fs._round == r.rounds
    names = {e.key for e in prof.key_averages()}
    assert {"msm.flow.reorder", "msm.flow.layout", "msm_window_count_halo"} <= names
