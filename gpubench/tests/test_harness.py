"""BENCHMARK.json within the limits of its format, every name
resolving to its file, a trial cell with its own generator and reference
run end to end, the readers on a canned trace, and the refusal to run
without a card."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from gpubench import registry, trace
from gpubench.tests.plugins import committed_names, trial_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == TOP_KEYS
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert cmd[1].startswith(BENCH["paths"][0] + "/") and (ROOT / cmd[1]).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # 24 cells' full check: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a
    # cell to compile, 1,200 s spare, inside 43,200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_resolve():
    names = [c["name"] for c in BENCH["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg = registry.config(BENCH, c["name"], ROOT)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["name"] in used


def test_workloads_resolve():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        traffic = registry.traffic(w["traffic"])
        assert hasattr(registry.entry(traffic["entry"]), "window")
        e2e = [m["name"] for m in registry.end_to_end(BENCH, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = registry.per_layer(BENCH, w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in e2e


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    assert "setup_s" in names
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layer_names = {}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in {x["name"] for x in e2e}
        assert hasattr(registry.reader(m["name"]), "read")
        layer_names.setdefault(m["layer"].lower(), m["layer"])
        assert layer_names[m["layer"].lower()] == m["layer"]
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


def test_committed_generator_and_reference_names_resolve():
    gens, refs = committed_names()
    assert registry.DEFAULT_GENERATOR in gens and registry.DEFAULT_REFERENCE in refs
    for name in gens:
        assert callable(registry.generator(name).write), name
    for name in refs:
        assert callable(registry.reference(name).capture_counts), name


@pytest.mark.parametrize("lookup,path", [("generator", "gpubench/gen/no_such.py"),
                                         ("reference", "gpubench/reference/no_such.py")])
def test_an_unknown_generator_or_reference_names_its_missing_file(lookup, path):
    with pytest.raises(KeyError, match=re.escape(str(ROOT / path))):
        getattr(registry, lookup)("no_such")


def test_a_trial_cell_runs_on_its_own_generator_and_reference(tmp_path, monkeypatch):
    from gpubench import run

    workload = trial_cell(tmp_path, monkeypatch)
    looked_up = []
    for lookup in ("generator", "reference"):
        find = getattr(registry, lookup)
        monkeypatch.setattr(registry, lookup, lambda name, find=find: looked_up.append(name) or find(name))
    result, lines = run.run_cell(workload, 2**31 + 41, 0.2, False, device="cpu")
    assert sorted(looked_up) == ["toy_gen", "toy_ref"]
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"stream_MBps", "setup_s"}
    assert all(c["value"] == 0 == c["limit"] for c in result["checks"].values())
    assert len(lines) == 3


@pytest.mark.parametrize("kind,names", [("gen", {"generator": "no_such_gen"}),
                                        ("reference", {"reference": "no_such_ref"})])
def test_a_trial_cell_naming_a_missing_plugin_fails_with_its_path(tmp_path, monkeypatch, kind,
                                                                 names):
    from gpubench import run

    workload = trial_cell(tmp_path, monkeypatch, **names)
    missing = tmp_path / kind / f"{next(iter(names.values()))}.py"
    with pytest.raises(KeyError, match=re.escape(str(missing))):
        run.run_cell(workload, 3, 0.2, False, device="cpu")


def canned_records():
    """Window 0-1,000 us: a program kernel 100-200, a fill 300-400, a copy
    50-150 and a host op 500-900; two passes of 1,000,000 payload bytes."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.PASS_SPAN, "ts": 0, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": trace.PASS_SPAN, "ts": 400, "dur": 600},
        {"ph": "X", "cat": "kernel", "name": "void probe_count_kernel<3, true>(Args)", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>", "ts": 300,
         "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 50, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 500, "dur": 400},
        {"ph": "X", "cat": "kernel", "name": "void probe_count_kernel<1, true>(Args)", "ts": 5000, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 10},
    ]
    rec = trace.reduce_events(events)
    rec.update(kernel_names=["probe_count_kernel", "ac_scan_kernel"], traced_payload_bytes=2_000_000,
               patterns=100, hbm_bytes_per_s=3.35e12, counters={"launches": 26, "passes": 2},
               probes={"io_s": 0.05, "io_bytes": 100_000_000})
    return rec


def test_records_and_breakdown():
    rec = canned_records()
    assert rec["passes"] == 2 and rec["window_us"] == (0.0, 1000.0)
    assert len(rec["device"]) == 3
    assert trace.window_s(rec) == pytest.approx(1e-3)
    assert trace.busy_s(rec) == pytest.approx(250e-6)
    bd = trace.breakdown(rec)
    assert bd["device_ops"][0][1] == pytest.approx(100e-6)
    gaps = dict(bd["idle_gaps"])
    # gaps 0-50 and 200-300 fall in no op; 400-1,000 has its midpoint in the copy
    assert gaps["aten::copy_"] == pytest.approx(600e-6)
    assert gaps["host (no op traced)"] == pytest.approx(150e-6)


@pytest.mark.parametrize("metric,want", [
    ("device_idle_share.stream", 75.0),
    ("h2d_ms_per_MB.stream", 0.1 / 2.0),
    ("count_kernels_roofline.stream", 100 * (2_000_000 + 2 * 400) / 3.35e12 / 100e-6),
    ("io_ms_per_MB.stream", 0.5),
])
def test_readers_on_canned_records(metric, want):
    assert registry.reader(metric).read(canned_records()) == pytest.approx(want)


def test_a_metric_of_a_new_cell_kind_reads_with_its_family_reader():
    assert registry.reader("device_idle_share.flows").read(canned_records()) == pytest.approx(75.0)
    with pytest.raises(KeyError):
        registry.reader("no_such_metric.stream")


def test_readers_find_nothing_in_an_empty_trace():
    rec = trace.reduce_events([])
    rec.update(kernel_names=[], traced_payload_bytes=0, patterns=1, hbm_bytes_per_s=None,
               counters={}, probes={})
    for m in BENCH["per_layer"]:
        assert registry.reader(m["name"]).read(rec) is None


def test_kernel_names_come_from_the_program_sources():
    from gpubench import program

    names = trace.program_kernel_names(program.csrc_dir())
    assert {"probe_count_kernel", "ac_scan_kernel", "window_find_kernel"} <= set(names)


def run_script(cwd, *args):
    return subprocess.run([sys.executable, "gpubench/run.py", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result(tmp_path):
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = run_script(ROOT, "--workload", "ref_strings.stream_mega", "--seed", "3", "--seconds", "1",
                     "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_alone_in_a_directory_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_script(tmp_path, "--workload", "ref_strings.stream_mega", "--seed", "4", "--seconds", "1",
                     "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
