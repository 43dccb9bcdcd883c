"""The flow monitor's pass (``parallel/flow_stream.count_pcap_flows_streamed``)
on the benchmark's ``tcp_http`` mix, held to the benchmark's plain per-flow
reference (``gpubench/reference/tcp_flows.py``), and the rule that a flow
payload ends at the IP total length.

- the pass equals the reference on a small seeded capture, on the window
  rounds (the halo kernel's plain version under a CPU ``pallas`` matcher)
  and on the CPU's default AC rounds, with segments split across rounds;
  so does a pass whose every feed takes the grouped plan, which ``FLOWS``
  counts (none with ``reorder``);
- the generator writes the same bytes for the same seed, returns the
  reference's stream bytes and honours its ``packets`` cap, and its plants
  across segment boundaries count once;
- under ``torch.profiler`` a pass opens its spans; ``FLOWS`` counts the
  stream bytes its rounds scanned and the bytes of their tiles;
- ``match --flows --stream`` runs the pass;
- two 3-byte segments of a split pattern, each frame padded to 60 bytes
  or carrying a captured frame check sequence, count one match over 6
  stream bytes; a length field that ends inside the headers (0 from a TSO
  host) leaves the payload at its wire length.

Counts are integers and compared exactly; the file imports no JAX.  The
CPU tests run on small captures; the test marked ``gpu`` runs only on the
card::

    python -m pytest --noconftest tests/test_torch_flow_monitor.py -q -m gpu
"""

import json
import pathlib
import struct

import numpy as np
import pytest
import torch

from gpubench import registry
from gpubench.gen.inputs import load_rules
from gpubench.gen.synth import classic_global_header
from gpubench.reference import count_payloads
from gpubench.reference.tcp_flows import capture_counts, tcp_streams
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io import flows as pt_flows
from multithreading_string_matching_tpu_torch.io.decode import decode_headers
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
from multithreading_string_matching_tpu_torch.parallel import flow_stream

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RULES = ROOT / "gpubench" / "gen" / "strings_standin.txt"
PATTERNS = load_rules({"rules": {"file": "gpubench/gen/strings_standin.txt"}}, ROOT)
# The cell's mix cut to 60 connections of small responses, densely planted,
# and capped at 600 frames (the last connections end mid-response).
SMALL = {"connections": 60, "concurrent": 8, "packets": 600, "plant_every": 400,
         "response_len": {"alpha": 1.2, "min": 1500, "max": 9000}}
# Rounds of a few KiB, narrow lanes: many rounds and a flow's bytes split
# across them.
STREAM = {"batch_packets": 64, "scan_bytes": 4096, "width": 256, "min_lanes": 4}
SEED = 2**31 + 77
FCS = b"\xde\xad\xbe\xef"


def mix(**over):
    cap = registry.traffic("tcp_http")["capture"]
    cap.update(SMALL, **over)
    return cap


def write(path, seed=SEED, **over):
    return registry.generator("tcp_flows").write(path, mix(**over), PATTERNS, None, seed)


def monitor(matcher, engine=None, **over):
    """A flow monitor over ``matcher`` with the narrow rounds of ``STREAM``,
    on ``engine`` or the one the CLI picks."""
    opts = {k: STREAM[k] for k in ("scan_bytes", "width", "min_lanes")}
    opts.update(over)
    return flow_stream.FlowStreamMatcher(
        matcher, "tcp", engine=engine or flow_stream.flow_stream_engine(matcher), **opts)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("flow_monitor") / "tcp_http.pcap"
    nbytes = write(path)
    counts, ref_bytes = capture_counts(path, PATTERNS, "tcp")
    return path, nbytes, counts, ref_bytes


def records(path):
    """``[(captured bytes, frame)]`` of a classic capture."""
    data = pathlib.Path(path).read_bytes()
    out, pos = [], 24
    while pos < len(data):
        incl = struct.unpack_from("<I", data, pos + 8)[0]
        out.append(data[pos + 16 : pos + 16 + incl])
        pos += 16 + incl
    return out


@pytest.mark.parametrize("engine", ["window", "ac"])
def test_pass_equals_the_reference(capture, engine):
    path, nbytes, want, ref_bytes = capture
    fs = monitor(Matcher(PATTERNS, engine="pallas", device="cpu"), engine)
    got = flow_stream.count_pcap_flows_streamed(fs, str(path),
                                                batch_packets=STREAM["batch_packets"])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and want.sum() > 20
    assert fs.bytes_seen == nbytes == ref_bytes
    assert fs.packets_seen == len(records(path)) == SMALL["packets"]
    assert fs.flows_seen == sum(1 for s in tcp_streams(path) if s)


@pytest.mark.parametrize("opts", [dict(engine="window"), dict(engine="ac"),
                                  dict(engine="window", reorder=True)],
                         ids=["window", "ac", "reorder"])
def test_grouped_feed_pass_equals_the_reference(capture, monkeypatch, opts):
    """A whole pass with every feed offered the grouped plan counts what the
    reference counts; ``FLOWS`` says every payload segment took the plan,
    and none with ``reorder`` (its pending segments carry their seq)."""
    path, nbytes, want, _ = capture
    monkeypatch.setattr(flow_stream.FlowStreamMatcher, "GROUP_MIN_SEGMENTS", 0)
    before = dict(flow_stream.FLOWS)
    fs = monitor(Matcher(PATTERNS, engine="pallas", device="cpu"), **opts)
    got = flow_stream.count_pcap_flows_streamed(fs, str(path),
                                                batch_packets=STREAM["batch_packets"])
    np.testing.assert_array_equal(got, want)
    assert fs.bytes_seen == nbytes and fs._round > 3
    fed = {k: flow_stream.FLOWS[k] - before[k] for k in before}
    valid, _, _, ln = pt_flows.flow_keys(read_pcap(str(path)), "tcp")
    assert fed["feed_segments"] == np.count_nonzero(valid & (ln > 0)) > 100
    assert fed["grouped_segments"] == (0 if opts.get("reorder") else fed["feed_segments"])


def test_default_engine_and_options_give_the_same_counts(capture):
    path, _, want, _ = capture
    matcher = Matcher(PATTERNS, engine="pallas", device="cpu")
    assert flow_stream.flow_stream_engine(matcher) == "ac"
    assert flow_stream.flow_stream_engine(Matcher(PATTERNS, engine="window", device="cpu")) == \
        "window"
    fs = monitor(matcher)
    assert fs.engine == "ac"
    got = flow_stream.count_pcap_flows_streamed(fs, [path], batch_packets=STREAM["batch_packets"])
    np.testing.assert_array_equal(got, want)


def test_generator_same_seed_same_bytes_and_the_reference_byte_count(tmp_path):
    a, b, c = tmp_path / "a.pcap", tmp_path / "b.pcap", tmp_path / "c.pcap"
    na, nb, nc = write(a), write(b), write(c, seed=SEED + 1)
    assert a.read_bytes() == b.read_bytes() != c.read_bytes()
    assert na == nb == capture_counts(a, PATTERNS, "tcp")[1]
    assert nc == capture_counts(c, PATTERNS, "tcp")[1]
    write(tmp_path / "d.pcap", packets=50)
    assert len(records(tmp_path / "d.pcap")) == 50
    # Every frame is at least the Ethernet minimum, padding included.
    assert min(len(f) for f in records(a)) == 60


def test_plants_across_segment_boundaries_count_once(capture):
    """Some plants straddle two segments: the flow counts exceed the counts
    of the segments one at a time by exactly those matches."""
    path, _, want, _ = capture
    pcap = read_pcap(str(path))
    valid, _, off, ln = pt_flows.flow_keys(pcap, "tcp")
    segs = [pcap.buf[pcap.offsets[i] + off[i] : pcap.offsets[i] + off[i] + ln[i]].tobytes()
            for i in np.flatnonzero(valid)]
    alone = count_payloads(segs, PATTERNS)
    assert (alone <= want).all() and want.sum() - alone.sum() >= 3


def test_spans_open_under_the_profiler_and_flows_counts(capture, tmp_path):
    path, nbytes, want, _ = capture
    before = dict(flow_stream.FLOWS)
    fs = monitor(Matcher(PATTERNS, engine="pallas", device="cpu"), "window")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = flow_stream.count_pcap_flows_streamed(fs, path, batch_packets=64)
    np.testing.assert_array_equal(got, want)
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    spans = {}
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    chunks = -(-SMALL["packets"] // 64)
    assert len(spans["msm.stream"]) == 1
    assert len(spans["msm.ingest"]) == chunks + 1
    assert len(spans["msm.flow.feed"]) == chunks
    # One layout span a scan: the rounds the feeds fire and the flush's.
    assert fs._round <= len(spans["msm.flow.layout"]) <= fs._round + 1
    assert len(spans["msm.flow.dispatch"]) == fs._round
    assert len(spans["msm.drain"]) >= 1
    (s0, s1), = spans["msm.stream"]
    assert all(s0 <= a and b <= s1 for iv in spans.values() for a, b in iv
               if iv is not spans["msm.stream"])
    assert fs._round > 3
    counted = {k: flow_stream.FLOWS[k] - before[k] for k in before}
    assert counted["real_bytes"] == nbytes < counted["tile_bytes"]


def test_flows_counts_rounds_that_take_the_chunk_loop(capture, monkeypatch):
    """Past ``ROUND_BUDGET_BYTES`` a round's ragged rows split over several
    launches (``msm.flow.dispatch`` spans), each an exact slice of rows:
    the counts stay the reference's, and ``FLOWS`` counts every stream byte
    once and tiles of whole ``H + width`` rows."""
    path, nbytes, want, _ = capture
    matcher = Matcher(PATTERNS, engine="pallas", device="cpu")
    row = max(int(matcher.window.max_len) - 1, 1) + STREAM["width"]
    monkeypatch.setattr(flow_stream.FlowStreamMatcher, "ROUND_BUDGET_BYTES", 4 * row)
    names, real_span = [], flow_stream.span

    def recording(name):
        names.append(name)
        return real_span(name)

    monkeypatch.setattr(flow_stream, "span", recording)
    before = dict(flow_stream.FLOWS)
    fs = monitor(matcher, "window")
    got = flow_stream.count_pcap_flows_streamed(fs, path, batch_packets=STREAM["batch_packets"])
    np.testing.assert_array_equal(got, want)
    assert names.count("msm.flow.dispatch") > 2 * fs._round > 6
    counted = {k: flow_stream.FLOWS[k] - before[k] for k in before}
    assert counted["real_bytes"] == nbytes
    assert counted["tile_bytes"] % row == 0
    assert counted["tile_bytes"] >= nbytes


def test_match_flows_stream_runs_the_pass(capture, capsys, monkeypatch):
    path, nbytes, want, _ = capture
    calls = []
    real = flow_stream.count_pcap_flows_streamed

    def counted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(flow_stream, "count_pcap_flows_streamed", counted)
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.setenv("MSM_FLOW_BATCH", "64")
    assert pt_main(["match", "--pcap", str(path), "--patterns", str(RULES), "--mode", "tcp",
                    "--flows", "--stream", "--json"]) == 0
    blob = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert len(calls) == 1 and calls[0]["batch_packets"] == 64
    assert blob["counts"] == want.tolist() and blob["stream_bytes"] == nbytes


def padded_frames(segments, v6=False, trailer=b"", length=None):
    """One TCP frame a segment of one flow, each padded with zeros to the
    60-byte Ethernet minimum, then ``trailer`` (a captured frame check
    sequence) appended; ``length`` overrides the IP length field."""
    out, seq = [], 1000
    for seg in segments:
        tcp = struct.pack(">HHIIHHHH", 40000, 80, seq, 0, (5 << 12) | 0x18, 65535, 0, 0)
        if v6:
            ip = bytearray(40)
            ip[0], ip[6], ip[7] = 0x60, 6, 64
            ip[4:6] = (20 + len(seg) if length is None else length).to_bytes(2, "big")
            ip[8:24], ip[24:40] = bytes(15) + b"\x01", bytes(15) + b"\x02"
            eth = bytes(12) + b"\x86\xdd"
        else:
            ip = bytearray(20)
            ip[0], ip[9] = 0x45, 6
            ip[2:4] = (20 + 20 + len(seg) if length is None else length).to_bytes(2, "big")
            ip[12:16], ip[16:20] = bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2])
            eth = bytes(12) + b"\x08\x00"
        frame = eth + bytes(ip) + tcp + seg
        out.append(frame + bytes(max(0, 60 - len(frame))) + trailer)
        seq += len(seg)
    return out


def write_frames(path, frames):
    with open(path, "wb") as f:
        f.write(classic_global_header())
        for i, fr in enumerate(frames):
            f.write(struct.pack("<IIII", i, 0, len(fr), len(fr)))
            f.write(fr)


@pytest.mark.parametrize("v6,trailer", [(False, b""), (False, FCS), (True, FCS)],
                         ids=["ipv4-padded", "ipv4-padded-fcs", "ipv6-fcs"])
def test_a_flow_payload_ends_at_the_ip_total_length(tmp_path, v6, trailer):
    path = tmp_path / "trailers.pcap"
    frames = padded_frames([b"SIG", b"NAL"], v6=v6, trailer=trailer)
    assert {len(f) for f in frames} == {(77 if v6 else 60) + len(trailer)}
    write_frames(path, frames)
    pcap = read_pcap(str(path))
    fb = pt_flows.extract_flows(pcap, "tcp", ipv6=v6)
    assert fb.num_flows == 1 and fb.stream(0) == b"SIGNAL"
    valid, _, _, ln = pt_flows.flow_keys(pcap, "tcp", ipv6=v6)
    assert valid.all() and ln.tolist() == [3, 3]
    pats = [b"SIGNAL", b"GNA", b"\x00", FCS[:2]]
    for engine in ("window", "ac"):
        fs = monitor(Matcher(pats, device="cpu"), engine, ipv6=v6, scan_bytes=1, width=4,
                     min_lanes=2)
        got = flow_stream.count_pcap_flows_streamed(fs, path, batch_packets=1)
        assert got.tolist() == [1, 1, 0, 0], engine
    if not v6:
        # The per-packet modes keep the reference's wire-length rule.
        _, _, wire = decode_headers(pcap, "tcp", strict=True)
        assert wire.tolist() == [6 + len(trailer)] * 2


@pytest.mark.parametrize("v6,length", [(False, 0), (False, 39), (True, 0)],
                         ids=["ipv4-zero", "ipv4-inside-the-headers", "ipv6-zero"])
def test_a_length_field_inside_the_headers_keeps_the_wire_length(tmp_path, v6, length):
    """Captures of hosts that offload segmentation read 0 in the IPv4 total
    length, as an IPv6 jumbogram's payload length does: such a field is no
    datagram's end, and the payload runs to the wire length."""
    path = tmp_path / "tso.pcap"
    segs = [b"0123456SIG", b"NAL6543210"]   # frames over 60 bytes: no padding
    write_frames(path, padded_frames(segs, v6=v6, length=length))
    pcap = read_pcap(str(path))
    valid, _, _, ln = pt_flows.flow_keys(pcap, "tcp", ipv6=v6)
    assert valid.all() and ln.tolist() == [10, 10]
    assert pt_flows.extract_flows(pcap, "tcp", ipv6=v6).stream(0) == b"".join(segs)
    for engine in ("window", "ac"):
        fs = monitor(Matcher([b"SIGNAL", b"\x00"], device="cpu"), engine, ipv6=v6,
                     scan_bytes=1, width=4, min_lanes=2)
        assert flow_stream.count_pcap_flows_streamed(fs, path, batch_packets=1).tolist() == \
            [1, 0], engine
        assert fs.bytes_seen == 20
    if not v6:
        assert tcp_streams(path) == [b"".join(segs)]


def test_the_reference_clips_at_the_ip_total_length_too(tmp_path):
    path = tmp_path / "trailers.pcap"
    write_frames(path, padded_frames([b"SIG", b"NAL"]))
    assert tcp_streams(path) == [b"SIGNAL"]
    counts, nbytes = capture_counts(path, [b"SIGNAL", b"\x00"], "tcp")
    assert counts.tolist() == [1, 0] and nbytes == 6


@pytest.mark.gpu
def test_a_pass_on_the_card_equals_the_reference_and_names_its_spans(capture, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    path, nbytes, want, _ = capture
    matcher = Matcher(PATTERNS, engine="pallas", device="cuda")
    fs = monitor(matcher)
    assert fs.engine == "window"
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = flow_stream.count_pcap_flows_streamed(fs, path,
                                                    batch_packets=STREAM["batch_packets"])
    np.testing.assert_array_equal(got, want)
    names = {e.key for e in prof.key_averages()}
    assert {"msm.stream", "msm.ingest", "msm.flow.feed", "msm.flow.layout",
            "msm.flow.dispatch", "msm.drain", "msm_window_count_halo"} <= names


@pytest.mark.gpu
def test_a_round_under_the_budget_is_one_launch_on_the_card(capture):
    """On the card every round of the ragged layout under the budget is
    exactly one ``window_count_halo`` launch, and the pass equals the
    plain reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    from multithreading_string_matching_tpu_torch.ops import cuda_window

    path, nbytes, want, _ = capture
    fs = monitor(Matcher(PATTERNS, engine="pallas", device="cuda"))
    assert fs.engine == "window"
    before = dict(cuda_window.LAUNCHES)
    got = flow_stream.count_pcap_flows_streamed(fs, path, batch_packets=STREAM["batch_packets"])
    np.testing.assert_array_equal(got, want)
    launched = {k: v - before.get(k, 0) for k, v in cuda_window.LAUNCHES.items()
                if v != before.get(k, 0)}
    assert fs._round > 3 and launched == {"window_count_halo": fs._round}
