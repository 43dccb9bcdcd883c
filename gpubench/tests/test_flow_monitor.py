"""The ``flow_monitor.tcp_http`` cell's own files: the ``tcp_flows``
reference on hand-built captures (a match split across segments counts
once, none spans two flows or the two directions of one connection, a
frame's padding is no stream byte, other modes are refused), the flow
readers on canned traces, and the cell's run on the CPU at a small size:
correct when sound, not correct with the timed path broken underneath or
under the control."""

import struct

import numpy as np
import pytest

from gpubench import control, registry, run, trace
from gpubench.gen.synth import classic_global_header
from gpubench.reference.tcp_flows import capture_counts, tcp_streams

CELL = "flow_monitor.tcp_http"
# Twelve connections of short responses, densely planted: a few hundred
# frames, a pass of a second or two on the CPU.
SMALL = {"connections": 12, "concurrent": 4, "plant_every": 300,
         "response_len": {"alpha": 1.2, "min": 1500, "max": 6000}}
SEED = 2**31 + 41
A, B = (10, 0, 0, 1), (10, 0, 0, 2)


def frame(src, dst, sport, dport, payload, *, pad_to=60, ihl=5, doff=5, proto=6, total=None):
    """An Ethernet/IPv4/TCP frame, zero-padded to ``pad_to`` bytes; ``total``
    overrides the IP total length."""
    tcp = struct.pack(">HHIIHHHH", sport, dport, 1, 0, (doff << 12) | 0x18, 65535, 0, 0)
    tcp += bytes(4 * doff - 20)
    if total is None:
        total = 4 * ihl + len(tcp) + len(payload)
    ip = struct.pack(">BBHHHBBH4B4B", 0x40 | ihl, 0, total, 0, 0,
                     64, proto, 0, *src, *dst) + bytes(4 * ihl - 20)
    out = bytes(12) + b"\x08\x00" + ip + tcp + payload
    return out + bytes(max(0, pad_to - len(out)))


def write(path, frames):
    with open(path, "wb") as f:
        f.write(classic_global_header())
        for i, fr in enumerate(frames):
            f.write(struct.pack("<IIII", i, 0, len(fr), len(fr)) + fr)
    return path


def test_split_matches_count_once_and_none_spans_two_streams(tmp_path):
    path = write(tmp_path / "c.pcap", [
        frame(A, B, 1000, 80, b"xxSIG"),
        frame(B, A, 80, 1000, b"NALyy"),         # the other direction: no join
        frame(A, B, 1001, 80, b"NALzz"),         # another connection: no join
        frame(A, B, 1000, 80, b"NA", ihl=6, doff=8),
        frame(A, B, 1000, 80, b"Lq"),            # SIG|NA|L: one match across three
        frame(A, B, 1000, 80, b"SIGNAL", proto=17),   # UDP: not a TCP stream
    ])
    assert tcp_streams(path) == [b"xxSIGNALq", b"NALyy", b"NALzz"]
    counts, nbytes = capture_counts(path, [b"SIGNAL", b"NAL", b"SIGNAL"], "tcp")
    assert counts.tolist() == [1, 3, 1] and nbytes == 19


def test_padding_and_a_cut_capture_are_no_stream_bytes(tmp_path):
    fr = frame(A, B, 1000, 80, b"ab")            # 56 bytes, padded to 60
    cut = frame(A, B, 1000, 80, b"cdefgh")[:-3]  # captured short of its wire length
    path = tmp_path / "c.pcap"
    with open(path, "wb") as f:
        f.write(classic_global_header())
        f.write(struct.pack("<IIII", 0, 0, len(fr), len(fr)) + fr)
        f.write(struct.pack("<IIII", 1, 0, len(cut), len(cut) + 3) + cut)
    assert len(fr) == 60
    assert tcp_streams(path) == [b"abcde"]
    counts, nbytes = capture_counts(path, [b"\x00", b"bc"], "tcp")
    assert counts.tolist() == [0, 1] and nbytes == 5


@pytest.mark.parametrize("total", [0, 39])
def test_a_total_length_inside_the_headers_keeps_the_wire_length(tmp_path, total):
    """Hosts that offload segmentation leave 0 in the total length: such a
    field ends no datagram, and the payload runs to the wire length."""
    path = write(tmp_path / "c.pcap", [frame(A, B, 1000, 80, b"0123456SIG", total=total),
                                       frame(A, B, 1000, 80, b"NAL6543210", total=total)])
    assert tcp_streams(path) == [b"0123456SIGNAL6543210"]
    counts, nbytes = capture_counts(path, [b"SIGNAL"], "tcp")
    assert counts.tolist() == [1] and nbytes == 20


def test_the_reference_reads_tcp_only(tmp_path):
    path = write(tmp_path / "c.pcap", [frame(A, B, 1, 2, b"abc")])
    with pytest.raises(ValueError, match="TCP"):
        capture_counts(path, [b"abc"], "udp")


def span(name, t0, t1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0}


def records(host, nbytes=2_000_000, probes=None):
    events = [span(trace.PASS_SPAN, 0, 4000), span("msm.stream", 10, 3990)]
    rec = trace.reduce_events(events + host)
    rec.update(kernel_names=[], traced_payload_bytes=nbytes, patterns=1, hbm_bytes_per_s=None,
               counters={}, probes=probes or {})
    return rec


STAGES = [
    span("msm.ingest", 20, 120),
    span("msm.flow.feed", 200, 1200),
    span("msm.flow.layout", 600, 1100),          # a round the feed fired
    span("msm.flow.dispatch", 900, 1000),
    span("aten::empty", 700, 720, "cpu_op"),     # the layout's own: not taken off
    span("msm.flow.feed", 1300, 1500),
    span("msm.flow.layout", 3000, 3600),         # the flush's round
    span("msm.drain", 3500, 3700),               # not inside: not taken off
]


@pytest.mark.parametrize("metric,want", [
    ("ingest_ms_per_MB.flows", 0.1 / 2),
    ("flow_feed_ms_per_MB.flows", (1000 - 500 + 200) / 1e3 / 2),
    ("flow_layout_ms_per_MB.flows", (500 - 100 + 600) / 1e3 / 2),
])
def test_flow_span_readers_on_canned_stages(metric, want):
    assert registry.reader(metric).read(records(STAGES)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["flow_feed_ms_per_MB.flows", "flow_layout_ms_per_MB.flows"])
def test_flow_span_readers_read_nothing_without_the_request_span(metric):
    rec = trace.reduce_events([span(trace.PASS_SPAN, 0, 4000), span("msm.flow.feed", 1, 2)])
    rec.update(traced_payload_bytes=1_000_000, counters={}, probes={})
    assert registry.reader(metric).read(rec) is None


def test_lane_fill_reads_the_probe_counter_and_nothing_without_it():
    fill = registry.reader("flow_lane_fill.flows")
    flows = {"real_bytes": 1000, "tile_bytes": 4000}
    assert fill.read(records([], probes={"io_s": 1.0, "flows": flows})) == pytest.approx(25.0)
    assert fill.read(records([], probes={"io_s": 1.0})) is None
    assert fill.read(records([], probes={"flows": dict(flows, tile_bytes=0)})) is None


def small_run(trace_on=False, seed=SEED):
    result, _ = run.run_cell(CELL, seed, 0.2, trace_on, device="cpu", capture_overrides=SMALL)
    return result


def test_sound_run_is_correct_and_reads_its_cpu_metrics():
    result = small_run(trace_on=True)
    assert result["correct"] is True and result["attempted"] >= 1
    assert all(c["value"] == 0 == c["limit"] for c in result["checks"].values())
    # On the CPU no device metric reads; every host one does.
    assert set(result["metrics"]) == {"ingest_ms_per_MB.flows", "io_ms_per_MB.flows",
                                      "flow_feed_ms_per_MB.flows", "flow_layout_ms_per_MB.flows",
                                      "flow_lane_fill.flows"}
    assert 0 < result["metrics"]["flow_lane_fill.flows"]["value"] < 100


def break_monitor(monkeypatch, fault):
    from multithreading_string_matching_tpu_torch.io.pcap import slice_pcap
    from multithreading_string_matching_tpu_torch.parallel import flow_stream

    fsm = flow_stream.FlowStreamMatcher
    counts, feed = fsm.counts, fsm.feed_pcap_slice
    if fault == "half":
        monkeypatch.setattr(fsm, "feed_pcap_slice",
                            lambda self, p: feed(self, slice_pcap(p, 0, p.num_packets // 2)))
        monkeypatch.setattr(fsm, "counts", lambda self: 2 * counts(self))
    elif fault == "unchanged":
        monkeypatch.setattr(fsm, "counts", lambda self: np.zeros_like(counts(self)))
    else:
        def altered(self):
            out = counts(self)
            out[0] += 1
            return out

        monkeypatch.setattr(fsm, "counts", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    break_monitor(monkeypatch, fault)
    result = small_run()
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] == result["attempted"] >= 1


def test_control_is_not_correct_on_the_cpu():
    got = control.control_run(CELL, SEED, 0.2, device="cpu", capture_overrides=SMALL)
    assert got["correct"] is False
    assert got["checks"]["wrong_answers"]["value"] == got["attempted"]
