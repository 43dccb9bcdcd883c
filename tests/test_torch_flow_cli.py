"""The torch package's ``match --flows`` and ``match --flows --stream``
against the JAX package's CLI: counts, flow and packet totals, stream bytes,
the text report and a SIGHUP rules reload, on the CPU (``MSM_DEVICE=cpu``);
the options once refused here (the packet `--stream`, the flow attribution
options, the AC flow engine that `--flows --stream` takes by default on the
CPU) give what the one-shot match and the JAX CLI give.
"""

import json
import os
import pathlib
import signal

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.cli import main as jax_main
from multithreading_string_matching_tpu.io import pcap as jax_pcap
from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io import pcap as pt_pcap
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = REPO / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """Twelve TCP flows planted with stand-in patterns, many of them split
    across segments, reordered, retransmitted and overlapped on the wire."""
    pats = load_patterns(STANDIN)
    rng = np.random.default_rng(7)
    flows = []
    for i in range(12):
        pay = bytearray(rng.integers(0, 256, size=int(rng.integers(300, 1500)), dtype=np.uint8))
        for _ in range(6):
            p = pats[int(rng.integers(0, len(pats)))]
            o = int(rng.integers(0, len(pay) - len(p)))
            pay[o : o + len(p)] = p
        flows.append(((f"10.0.1.{i + 1}", "10.0.2.1", 4000 + i, 80), bytes(pay)))
    path = tmp_path_factory.mktemp("torch_flow_cli") / "flows.pcap"
    synth_tcp_flows_pcap(path, flows, segment_len=37, interleave_seed=1, noise_packets=5,
                         reorder_seed=2, retransmit_rate=0.1, overlap_rate=0.1, seed=3)
    return path


def _json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--flows"],
    ["--flows", "--reorder"],
    ["--flows", "--engine", "window"],
    ["--flows", "--reorder", "--nocase"],
    ["--flows", "--stream", "--engine", "window"],
    ["--flows", "--stream", "--engine", "window", "--reorder"],
    ["--flows", "--stream", "--engine", "window", "--reorder", "--nocase"],
], ids=lambda f: "_".join(x.strip("-") for x in f))
def test_flows_json_equals_jax(capture, capsys, monkeypatch, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.setenv("MSM_FLOW_BATCH", "50")
    argv = ["match", "--pcap", str(capture), "--patterns", str(STANDIN), "--mode", "tcp",
            "--json", *flags]
    got = _json(pt_main, argv, capsys)
    want = _json(jax_main, argv, capsys)
    keys = ["patterns", "counts", "flows", "flow_packets", "stream_bytes"]
    if "--stream" not in flags:
        keys.append("packets")
    for key in keys:
        assert got[key] == want[key], key
    assert sum(got["counts"]) > 20 and got["flows"] == 12
    assert got["execution"]["device"] == "cpu"
    if "--stream" in flags:
        assert got["execution"]["engine_resolved"] == "window"
        assert set(got["phases"]) == {"scan"}
    else:
        assert set(got["phases"]) == {"ingest", "extract", "scan"}


@pytest.mark.parametrize("flags", [[], ["--reorder"]], ids=["capture-order", "reorder"])
def test_flow_stream_execution_keys_equal_jax(capture, capsys, monkeypatch, flags):
    """``match --flows --stream --json`` reports the JAX package's execution
    keys; ``device`` is the port's one addition (which card or the CPU)."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    argv = ["match", "--pcap", str(capture), "--patterns", str(STANDIN), "--mode", "tcp",
            "--json", "--flows", "--stream", "--engine", "window", *flags]
    got = _json(pt_main, argv, capsys)["execution"]
    want = _json(jax_main, argv, capsys)["execution"]
    assert set(got) - {"device"} == set(want)
    assert got["device"] == "cpu" and "flow_rounds" not in got
    for key in want:
        assert got[key] == want[key], key


def test_flow_stream_counts_split_signatures(capture, capsys, monkeypatch):
    """The reassembled counts exceed the per-packet counts: signatures
    split across segments count once in the stream."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    base = ["match", "--pcap", str(capture), "--patterns", str(STANDIN), "--mode", "tcp", "--json"]
    per_packet = _json(pt_main, base, capsys)["counts"]
    stream = _json(pt_main, base + ["--flows", "--stream", "--engine", "window", "--reorder"],
                   capsys)["counts"]
    assert sum(stream) > sum(per_packet)


@pytest.mark.parametrize("flags", [["--flows"], ["--flows", "--stream", "--engine", "window"]])
def test_flows_text_report_equals_jax(capture, capsys, monkeypatch, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    argv = ["match", "--pcap", str(capture), "--patterns", str(STANDIN), "--mode", "tcp", *flags]
    assert pt_main(argv) == 0
    got = capsys.readouterr().out.splitlines()
    assert jax_main(argv) == 0
    want = capsys.readouterr().out.splitlines()

    def drop(lines):
        return [ln for ln in lines if not ln.startswith("Elapsed time = ")]

    assert drop(got) == drop(want) and len(drop(got)) > 5


UNPORTED_CASES = [
    # Attribution is ported: the same output and dump as the JAX CLI.
    (["--flows", "--offsets"], "equal to the JAX CLI"),
    (["--flows", "--dump-matches", "x.pcap"], "equal to the JAX CLI"),
    (["--flows", "--sharded", "--offsets"], "equal to the JAX CLI"),
    (["--flows", "--stream", "--host-workers", "2"], "equal to the JAX CLI"),
    # JAX refuses this combination before anything runs; the port now does too.
    (["--flows", "--stream", "--distributed"], "refused like JAX"),
    # The packet stream is ported: it counts what the one-shot match counts.
    (["--stream"], "ported"),
    # The CPU default picks the AC flow engine, now ported.
    (["--flows", "--stream"], "equal to the JAX CLI"),
    (["--flows", "--stream", "--engine", "ac"], "equal to the JAX CLI"),
]


@pytest.mark.parametrize("flags, outcome", UNPORTED_CASES,
                         ids=["_".join(x.strip("-") for x in f) for f, _ in UNPORTED_CASES])
def test_unported_flow_options_exit_1(capture, capsys, monkeypatch, tmp_path, flags, outcome):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)  # a relative dump path lands here
    argv = ["match", "--pcap", str(capture), "--patterns", str(STANDIN), "--mode", "tcp", *flags]
    if outcome == "equal to the JAX CLI":
        outs = []
        for main in (pt_main, jax_main):
            assert main(argv) == 0
            out = capsys.readouterr().out.splitlines()
            outs.append(([ln for ln in out if not ln.startswith("Elapsed time = ")],
                         (tmp_path / "x.pcap").read_bytes() if "x.pcap" in flags else None))
        assert outs[0] == outs[1] and len(outs[0][0]) > 10
        if "--offsets" in flags:
            assert any(ln.startswith("flow ") for ln in outs[0][0])
    elif outcome == "refused like JAX":
        with pytest.raises(SystemExit) as got:
            pt_main(argv)
        with pytest.raises(SystemExit) as want:
            jax_main(argv)
        assert str(got.value) == str(want.value)
        assert str(got.value).startswith("--flows --stream does not compose with --distributed")
    else:
        assert outcome == "ported"
        streamed = _json(pt_main, argv + ["--json"], capsys)["counts"]
        one_shot = _json(pt_main, argv[:-1] + ["--json"], capsys)["counts"]
        assert streamed == one_shot and sum(streamed) > 0


@pytest.mark.parametrize("flags", [["--flows", "--per-packet", "--json"], ["--reorder"],
                                   ["--flows", "--reorder", "--mode", "udp"]])
def test_flow_flag_conflicts_exit(capture, monkeypatch, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    with pytest.raises(SystemExit) as e:
        pt_main(["match", "--pcap", str(capture), "--patterns", str(STANDIN), *flags])
    assert e.value.code not in (0, None)


def test_sighup_reloads_rules_like_jax(capture, capsys, monkeypatch, tmp_path):
    """SIGHUP between two capture batches swaps in the rewritten rules file:
    the epoch report (stderr) and the final counts equal the JAX CLI's."""
    pats = load_patterns(STANDIN)
    rules = tmp_path / "rules.txt"
    new_rules = b"\n".join(pats[::3] + [b"zz"]) + b"\n"

    def hup_after_first_batch(module):
        orig = module.iter_pcap

        def batches(*a, **k):
            for i, chunk in enumerate(orig(*a, **k)):
                yield chunk
                if i == 0:
                    rules.write_bytes(new_rules)
                    os.kill(os.getpid(), signal.SIGHUP)

        monkeypatch.setattr(module, "iter_pcap", batches)

    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.setenv("MSM_FLOW_BATCH", "60")
    argv = ["match", "--pcap", str(capture), "--patterns", str(rules), "--mode", "tcp",
            "--flows", "--stream", "--engine", "window", "--json"]
    out = {}
    for name, main, module in (("port", pt_main, pt_pcap), ("jax", jax_main, jax_pcap)):
        rules.write_bytes(STANDIN.read_bytes())
        hup_after_first_batch(module)
        assert main(argv) == 0
        io = capsys.readouterr()
        epochs = [json.loads(ln) for ln in io.err.splitlines() if ln.startswith('{"reload"')]
        out[name] = (epochs, json.loads(io.out.splitlines()[-1]))
    (got_epochs, got), (want_epochs, want) = out["port"], out["jax"]
    assert len(got_epochs) == 1 and got_epochs == want_epochs
    assert got_epochs[0]["patterns"] == [p.decode("latin-1") for p in pats]
    assert got["reloads"] == want["reloads"] == 1
    for key in ("patterns", "counts", "flows", "flow_packets", "stream_bytes"):
        assert got[key] == want[key], key
    assert got["patterns"] == [p.decode("latin-1") for p in pats[::3] + [b"zz"]]
