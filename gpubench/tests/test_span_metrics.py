"""The readers of the program's spans (``gpubench/metrics/_spans.py`` and
the five ``*.stream`` metrics that use it) on canned traces: sums and
counts per payload MB and per pass, packing's self time less the spans
inside it, spans cut by the window's edges, and nothing to read in a trace
without the program's request span."""

import pytest

from gpubench import registry, trace

SPAN_METRICS = ("ingest_ms_per_MB.stream", "decode_ms_per_MB.stream", "pack_ms_per_MB.stream",
                "stage_wait_ms_per_MB.stream", "stage_allocs_per_pass.stream")


def span(name, t0, t1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0}


def records(host, nbytes=2_000_000):
    """Two traced passes, 0-4,000 and 4,000-8,000 us, each one
    ``msm.stream`` call, and ``host`` beside them; ``nbytes`` of payload."""
    events = [span(trace.PASS_SPAN, 0, 4000), span(trace.PASS_SPAN, 4000, 8000),
              span("msm.stream", 10, 3990), span("msm.stream", 4010, 7990)]
    rec = trace.reduce_events(events + host)
    rec.update(kernel_names=[], traced_payload_bytes=nbytes, patterns=1, hbm_bytes_per_s=None,
               counters={}, probes={})
    return rec


# One pass's stages, the second pass's, and spans that cross the window's
# edges (0 and 8,000 us) or lie past it.
STAGES = [
    span("msm.ingest", -200, 100),                   # 100 us inside
    span("msm.ingest", 200, 500),
    span("msm.decode", 500, 1000),
    span("msm.pack", 1000, 2000),
    span("msm.stage.alloc", 1100, 1300),
    span("msm.stage.wait", 1200, 1400),              # overlaps the alloc: union 300 us
    span("msm.stage.dispatch", 1500, 1700),
    span("aten::copy_", 1510, 1520, "cpu_op"),
    span("msm_window_count_totals", 1550, 1650),
    span("aten::empty", 1800, 1900, "cpu_op"),       # packing's own: not taken off
    span("msm.ingest", 4100, 4300),
    span("msm.decode", 4300, 4500),
    span("msm.stage.wait", 4600, 4650),
    span("msm.stage.alloc", 4700, 4800),
    span("msm.pack", 7500, 8500),                    # 500 us inside
    span("msm.stage.dispatch", 7600, 7700),
    span("msm.drain", 7950, 8300),                   # 50 us inside
    span("msm.stage.alloc", 9000, 9100),             # past the window
]


@pytest.mark.parametrize("metric,want", [
    ("ingest_ms_per_MB.stream", (100 + 300 + 200) / 1e3 / 2),
    ("decode_ms_per_MB.stream", (500 + 200) / 1e3 / 2),
    # 1,000 - (300 + 200) in the first; 500 - (100 + 50) in the second
    ("pack_ms_per_MB.stream", (500 + 350) / 1e3 / 2),
    ("stage_wait_ms_per_MB.stream", (200 + 50) / 1e3 / 2),
    ("stage_allocs_per_pass.stream", 2 / 2),
])
def test_span_readers_on_canned_stages(metric, want):
    assert registry.reader(metric).read(records(STAGES)) == pytest.approx(want)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_readers_read_nothing_without_the_request_span(metric):
    """A program that opens no ``msm.stream`` (its launch ranges alone, as
    before the streamed path had spans), and an empty trace."""
    events = [span(trace.PASS_SPAN, 0, 4000), span("msm_window_count_totals", 100, 200),
              span("aten::copy_", 300, 400, "cpu_op")]
    rec = trace.reduce_events(events)
    rec.update(traced_payload_bytes=1_000_000, patterns=1, counters={}, probes={})
    assert registry.reader(metric).read(rec) is None
    empty = trace.reduce_events([])
    empty.update(traced_payload_bytes=0, counters={}, probes={})
    assert registry.reader(metric).read(empty) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_readers_read_zero_where_the_stage_never_ran(metric):
    """Request spans but no stage span in them: the stage took no time
    (the host never waited, no slot was built)."""
    assert registry.reader(metric).read(records([])) == 0.0


def test_per_MB_is_per_million_payload_bytes_and_none_without_bytes():
    rec = records([span("msm.ingest", 100, 1100)], nbytes=4_000_000)
    assert registry.reader("ingest_ms_per_MB.stream").read(rec) == pytest.approx(0.25)
    rec["traced_payload_bytes"] = 0
    assert registry.reader("ingest_ms_per_MB.stream").read(rec) is None


def test_pack_self_time_keeps_children_of_other_spans_out():
    """Only ``msm.*`` spans inside a pack span come off it; the request span
    around it and a stage span beside it do not."""
    rec = records([span("msm.pack", 1000, 2000), span("msm.stage.dispatch", 1900, 2100),
                   span("msm.decode", 500, 1000)])
    assert registry.reader("pack_ms_per_MB.stream").read(rec) == pytest.approx(1.0 / 2)
