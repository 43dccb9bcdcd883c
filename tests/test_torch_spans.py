"""The streamed path's spans (``utils.timing.span``): under
``torch.profiler`` one ``count_pcap_streamed`` call is one ``msm.stream``
range holding one ``msm.ingest`` / ``msm.decode`` pair a batch, one
``msm.stage.dispatch`` a tile, the stager's allocation and the drain; with
no profiler a span is one shared no-op context and no profiler call is
made; ``match --stream --profile DIR`` writes the spans into its trace.

Counts are integers and compared exactly.  The CPU tests run on tiny
captures; the one test marked ``gpu`` runs only on the card, where the
stager also waits on copies and the kernels' launch ranges appear::

    python -m pytest --noconftest tests/test_torch_spans.py -q -m gpu
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.pcap import iter_pcap
from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu_torch.parallel import pipeline as pp
from multithreading_string_matching_tpu_torch.utils import timing

STANDIN_FILE = (pathlib.Path(__file__).resolve().parent.parent
                / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt")
STANDIN = load_patterns(STANDIN_FILE)
# Every payload (at most 350 bytes) fits a packed row, so every launch is a
# tile's.
SMALL = {"batch_packets": 64, "tile_rows": 16, "pack_width": 512}
# Every span of the streamed path; the stager waits for a slot's copy only
# on the card (the CPU stager copies nothing).
SPANS = ("msm.stream", "msm.ingest", "msm.decode", "msm.pack", "msm.stage.alloc",
         "msm.stage.dispatch", "msm.drain")
CARD_SPANS = SPANS + ("msm.stage.wait", "msm_window_count_totals")


@pytest.fixture(scope="module")
def cap(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_spans") / "synth.pcap"
    synth_udp_pcap(path, 300, payload_len=180, payload_len_jitter=170, patterns=STANDIN,
                   plant_rate=0.6, invalid_rate=0.05, seed=19)
    return path


def ranges(prof, tmp_path):
    """``{name: [(start_us, end_us), ...]}`` of the ``msm`` ranges of a
    profile's Chrome trace, as the benchmark reads them."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return trace_ranges(path)


def trace_ranges(path):
    out = {}
    for e in json.loads(pathlib.Path(path).read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("msm"):
            out.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def profiled_pass(matcher, cap, monkeypatch, activities, **kw):
    """``(counts, profile, tiles dispatched)`` of one profiled call."""
    counters = []
    real = pp.PackedTileCounter.totals

    def totals(self):
        counters.append(self)
        return real(self)

    monkeypatch.setattr(pp.PackedTileCounter, "totals", totals)
    with torch.profiler.profile(activities=activities) as prof:
        got = pp.count_pcap_streamed(matcher, cap, "udp", **kw)
    assert len(counters) == 1
    return got, prof, counters[0].tiles_dispatched


def test_a_profiled_pass_has_one_span_a_batch_and_a_tile(cap, tmp_path, monkeypatch):
    matcher = Matcher(STANDIN, device="cpu")
    want = pp.count_pcap_streamed(matcher, cap, "udp", **SMALL)
    got, prof, tiles = profiled_pass(matcher, cap, monkeypatch,
                                     [torch.profiler.ProfilerActivity.CPU], **SMALL)
    np.testing.assert_array_equal(got, want)
    spans = ranges(prof, tmp_path)
    batches = sum(1 for _ in iter_pcap(cap, batch_packets=SMALL["batch_packets"]))
    assert batches > 1 and tiles > 1
    assert len(spans["msm.stream"]) == 1
    # One read a batch, and the read that finds the end of the capture.
    assert len(spans["msm.ingest"]) == batches + 1
    assert len(spans["msm.decode"]) == batches
    assert len(spans["msm.pack"]) == batches
    assert len(spans["msm.stage.dispatch"]) == tiles
    assert len(spans["msm.stage.alloc"]) >= 1 and len(spans["msm.drain"]) == 1
    assert set(spans) == set(SPANS)
    (s0, s1), = spans["msm.stream"]
    for name, iv in spans.items():
        assert all(s0 <= a and b <= s1 for a, b in iv), name
    # Ingest and decode close before the batch is handed on: no pack span
    # overlaps them.
    for a, b in spans["msm.ingest"] + spans["msm.decode"]:
        assert all(b <= c or d <= a for c, d in spans["msm.pack"])


def test_spans_cost_no_profiler_call_when_off(cap, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert timing.span("msm.stream") is timing.span("msm.pack") is timing._NO_SPAN
    matcher = Matcher(STANDIN, device="cpu")
    want = pp.count_pcap_streamed(matcher, cap, "udp", **SMALL)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    np.testing.assert_array_equal(pp.count_pcap_streamed(matcher, cap, "udp", **SMALL), want)


def test_match_stream_profile_writes_the_spans(cap, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    out = tmp_path / "prof"
    assert pt_main(["match", "--pcap", str(cap), "--patterns", str(STANDIN_FILE), "--stream",
                    "--profile", str(out)]) == 0
    capsys.readouterr()
    traces = list(out.glob("*.json"))
    assert len(traces) == 1
    assert set(SPANS) <= set(trace_ranges(traces[0]))


@pytest.mark.gpu
def test_a_pass_on_the_card_names_every_span(cap, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    matcher = Matcher(STANDIN, device="cuda")
    want = pp.count_pcap_streamed(matcher, cap, "udp", **SMALL)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    got, prof, tiles = profiled_pass(matcher, cap, monkeypatch, acts, **SMALL)
    np.testing.assert_array_equal(got, want)
    spans = ranges(prof, tmp_path)
    assert set(CARD_SPANS) <= set(spans)
    assert len(spans["msm.stage.dispatch"]) == len(spans["msm_window_count_totals"]) == tiles
