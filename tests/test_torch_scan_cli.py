"""``match --engine ac|kmp`` through the torch package's CLI against the JAX
package's, on the CPU (``MSM_DEVICE=cpu``): the JSON blobs (counts, totals
and the ``execution`` keys, remaps included) and the text reports, on the
one-shot, ``--per-packet``, ``--stream``, ``--sharded``, ``--flows`` and
``--flows --stream`` paths, and ``--flows --stream`` without ``--engine``,
whose CPU default is the AC flow engine.  Both CLIs run in this process.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.cli import main as jax_main
from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap, synth_udp_pcap
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = REPO / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scan_cli")
    pats = load_patterns(STANDIN)
    synth_udp_pcap(d / "udp.pcap", 180, payload_len=240, payload_len_jitter=200, patterns=pats,
                   plant_rate=0.6, invalid_rate=0.05, seed=13)
    rng = np.random.default_rng(8)
    flows = []
    for i in range(10):
        pay = bytearray(rng.integers(0, 256, size=int(rng.integers(300, 1200)), dtype=np.uint8))
        for _ in range(6):
            p = pats[int(rng.integers(0, len(pats)))]
            o = int(rng.integers(0, len(pay) - len(p)))
            pay[o:o + len(p)] = p
        flows.append(((f"10.0.3.{i + 1}", "10.0.4.1", 6000 + i, 80), bytes(pay)))
    synth_tcp_flows_pcap(d / "flows.pcap", flows, segment_len=41, interleave_seed=3,
                         noise_packets=4, reorder_seed=5, retransmit_rate=0.1, seed=6)
    return d


def _json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.splitlines()[-1])


PACKET_FLAGS = [
    [],
    ["--per-packet"],
    ["--nocase"],
    ["--stream"],
    ["--stream", "--host-workers", "2"],
    ["--sharded"],
    ["--sharded", "--shard-axis", "packets"],
    ["--sharded", "--shard-axis", "patterns"],
    ["--sharded", "--per-packet"],
    ["--stream", "--sharded"],
    ["--offsets"],
    ["--stream", "--offsets"],
]
FLOW_FLAGS = [
    ["--flows"],
    ["--flows", "--reorder"],
    ["--flows", "--sharded"],
    ["--flows", "--offsets"],
    ["--flows", "--stream"],
    ["--flows", "--stream", "--reorder"],
    ["--flows", "--stream", "--sharded"],
    ["--flows", "--stream", "--offsets"],
]


def _ids(flags):
    return "_".join(x.strip("-") for x in flags) or "one-shot"


def _compare_json(files, capsys, monkeypatch, argv):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.setenv("MSM_FLOW_BATCH", "40")
    got = _json(pt_main, argv, capsys)
    want = _json(jax_main, argv, capsys)
    for key in want:
        if key not in ("phases", "execution"):
            assert got[key] == want[key], key
    assert set(got) == set(want)
    ex = dict(got["execution"])
    assert ex.pop("device") == "cpu"
    assert ex == want["execution"]
    return got


@pytest.mark.parametrize("engine", ["ac", "kmp"])
@pytest.mark.parametrize("flags", PACKET_FLAGS, ids=_ids)
def test_packet_paths_json_equal_jax(files, capsys, monkeypatch, engine, flags):
    got = _compare_json(files, capsys, monkeypatch,
                        ["match", "--pcap", str(files / "udp.pcap"), "--patterns", str(STANDIN),
                         "--json", "--engine", engine, *flags])
    total = np.asarray(got["counts"]).sum()
    assert total > 100


@pytest.mark.parametrize("engine", ["ac", "kmp"])
@pytest.mark.parametrize("flags", FLOW_FLAGS, ids=_ids)
def test_flow_paths_json_equal_jax(files, capsys, monkeypatch, engine, flags):
    got = _compare_json(files, capsys, monkeypatch,
                        ["match", "--pcap", str(files / "flows.pcap"), "--patterns",
                         str(STANDIN), "--mode", "tcp", "--json", "--engine", engine, *flags])
    assert sum(got["counts"]) > 20 and got["flows"] == 10


@pytest.mark.parametrize("engine", ["ac", "kmp"])
@pytest.mark.parametrize("flags", [[], ["--stream"], ["--sharded"], ["--flows"],
                                   ["--flows", "--stream"]], ids=_ids)
def test_text_reports_equal_jax(files, capsys, monkeypatch, engine, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    mode = ["--mode", "tcp"] if "--flows" in flags else []
    cap = files / ("flows.pcap" if "--flows" in flags else "udp.pcap")
    argv = ["match", "--pcap", str(cap), "--patterns", str(STANDIN), "--engine", engine,
            *mode, *flags]
    outs = []
    for main in (pt_main, jax_main):
        assert main(argv) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if not ln.startswith("Elapsed time = ")])
    assert outs[0] == outs[1] and len(outs[0]) > 5


def test_flow_stream_default_engine_on_the_cpu(files, capsys, monkeypatch):
    """``--flows --stream`` without ``--engine`` runs the AC flow engine on
    the CPU, as the JAX CLI does there (it once exited 1 here).  The remap
    names the requested engine's resolution: ``pallas`` in the port, whose
    CPU path runs the kernels' plain versions, ``window`` in the JAX
    package, which degrades pallas to its window form on a CPU."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    argv = ["match", "--pcap", str(files / "flows.pcap"), "--patterns", str(STANDIN),
            "--mode", "tcp", "--json", "--flows", "--stream"]
    got = _json(pt_main, argv, capsys)
    want = _json(jax_main, argv, capsys)
    for key in ("counts", "flows", "flow_packets", "stream_bytes", "patterns"):
        assert got[key] == want[key], key
    ex, jex = got["execution"], want["execution"]
    assert ex["engine_resolved"] == jex["engine_resolved"] == "ac"
    assert ex["streamed_remap"] == "pallas->ac" and jex["streamed_remap"] == "window->ac"
    assert set(ex) - {"device", "pallas_kernel"} == set(jex)
    # Without --json: the same report as the JAX CLI.
    argv.remove("--json")
    outs = []
    for main in (pt_main, jax_main):
        assert main(argv) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if not ln.startswith("Elapsed time = ")])
    assert outs[0] == outs[1]


def test_serial_data_task_with_an_ac_matcher(files, capsys, monkeypatch):
    """The reference's commands keep the pallas engine; with a DFA matcher
    underneath (the library), the streamed counts equal theirs."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    cap = str(files / "udp.pcap")
    outs = []
    for argv in (["serial", cap, str(STANDIN)], ["task", cap, str(STANDIN), "2"]):
        assert pt_main(argv) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if not ln.startswith("Elapsed time = ")])
    assert outs[0] == outs[1]
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.parallel.pipeline import count_pcap_pipelined

    m = Matcher(load_patterns(STANDIN), engine="ac", device="cpu")
    assert np.array_equal(count_pcap_pipelined(m, cap), m.count_pcap(cap, engine="kmp"))
