"""``match --offsets``, ``--dump-matches`` and a repeated ``--pcap`` of the
torch package against the JAX package's CLI, on the CPU
(``MSM_DEVICE=cpu``): the one-shot, ``--flows``, ``--sharded`` (each
axis), ``--stream`` and ``--flows --stream`` paths.

Both CLIs run in process on the same seeded captures.  ``--json`` blobs
are compared key by key (the timings aside; of ``execution`` the keys that
name the platform aside), text reports line by line (the elapsed-time
line aside), and each dumped pcap byte for byte.  Everything compared is
integers or bytes: exact equality.
"""

import json
import os
import pathlib
import subprocess
import sys

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
# Execution keys that name the platform: the port reports its device, and a
# pallas matcher on the CPU stays pallas where JAX degrades to window.
PLATFORM_KEYS = {"device", "pallas_kernel", "engine_resolved", "streamed_remap",
                 "sharded_remap"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_attribution_cli")
    pats = load_patterns(STANDIN)
    cap, cap2 = d / "a.pcap", d / "b.pcap"
    synth_udp_pcap(cap, 260, payload_len=150, payload_len_jitter=140, patterns=pats,
                   plant_rate=0.5, invalid_rate=0.05, seed=11)
    synth_udp_pcap(cap2, 90, payload_len=200, payload_len_jitter=100, patterns=pats,
                   plant_rate=0.5, seed=12)
    nul = d / "nul.txt"
    nul.write_bytes(STANDIN.read_bytes() + b"\nx\x00\n\x00\x00\n")
    rng = np.random.default_rng(5)
    flows = []
    for i in range(6):
        pay = bytearray(rng.integers(0, 256, size=int(rng.integers(200, 900)), dtype=np.uint8))
        for _ in range(5):
            p = pats[int(rng.integers(0, len(pats)))]
            o = int(rng.integers(0, len(pay) - len(p)))
            pay[o : o + len(p)] = p
        flows.append(((f"10.0.1.{i + 1}", "10.0.2.1", 4000 + i, 80), bytes(pay)))
    fcap = d / "flows.pcap"
    synth_tcp_flows_pcap(fcap, flows, segment_len=41, interleave_seed=1, noise_packets=4,
                         reorder_seed=2, retransmit_rate=0.1, overlap_rate=0.1, seed=3)
    quiet = d / "quiet.pcap"  # flows without a single match: an empty dump
    synth_tcp_flows_pcap(quiet, [(("10.0.0.9", "10.0.0.2", 999, 80), b"\x01" * 300)],
                         interleave_seed=1)
    return {"cap": cap, "cap2": cap2, "nul": nul, "flows": fcap, "quiet": quiet, "dir": d}


def _run(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr()
    return ([ln for ln in out.out.splitlines() if not ln.startswith("Elapsed time = ")],
            [ln for ln in out.err.splitlines() if ln.startswith("# wrote")
             or ln.startswith("# note")])


def _both(argv, capsys, dump=None):
    """Each CLI's (stdout lines, stderr notes, dumped bytes)."""
    got = _run(pt_main, argv, capsys)
    got_dump = pathlib.Path(dump).read_bytes() if dump else None
    want = _run(jax_main, argv, capsys)
    want_dump = pathlib.Path(dump).read_bytes() if dump else None
    return (*got, got_dump), (*want, want_dump)


def _assert_blobs_equal(got_lines, want_lines):
    got, want = json.loads(got_lines[-1]), json.loads(want_lines[-1])
    assert set(got) == set(want)
    for key in set(got) - {"phases", "execution"}:
        assert got[key] == want[key], key
    assert set(got["phases"]) == set(want["phases"])
    ge, we = got["execution"], want["execution"]
    assert {k: v for k, v in ge.items() if k not in PLATFORM_KEYS} == {
        k: v for k, v in we.items() if k not in PLATFORM_KEYS}
    return got


def _argv(files, pats="standin", cap="cap", *flags):
    patterns = STANDIN if pats == "standin" else files[pats]
    return ["match", "--pcap", str(files[cap]), "--patterns", str(patterns), *flags]


ONE_SHOT = {
    "offsets": ["--offsets"],
    "dump": ["--dump-matches", "{dump}"],
    "offsets-dump": ["--offsets", "--dump-matches", "{dump}"],
    "nocase": ["--offsets", "--dump-matches", "{dump}", "--nocase"],
    "window": ["--offsets", "--engine", "window"],
    "staging-packed-dump": ["--dump-matches", "{dump}", "--staging", "packed"],
    "per-packet-offsets": ["--per-packet", "--offsets", "--dump-matches", "{dump}"],
    "tcp": ["--offsets", "--mode", "tcp", "--dump-matches", "{dump}"],
    "two-pcaps": ["--pcap", "{cap2}", "--offsets", "--dump-matches", "{dump}"],
    "two-pcaps-counts": ["--pcap", "{cap2}"],
}


def _fill(files, flags, name):
    dump = files["dir"] / f"{name}.pcap"
    out = [f.replace("{dump}", str(dump)).replace("{cap2}", str(files["cap2"]))
           .replace("{flows}", str(files["flows"])) for f in flags]
    return out, (dump if "{dump}" in flags else None)


# --per-packet needs --json in both CLIs: no text case.
ONE_SHOT_CASES = [(name, j) for name in ONE_SHOT for j in (True, False)
                  if j or name != "per-packet-offsets"]


@pytest.mark.parametrize("name, json_out", ONE_SHOT_CASES,
                         ids=[f"{n}-{'json' if j else 'text'}" for n, j in ONE_SHOT_CASES])
def test_one_shot_equals_jax(files, capsys, monkeypatch, name, json_out):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    flags, dump = _fill(files, ONE_SHOT[name], f"one_{name}_{json_out}")
    pats = "nul" if name == "offsets-dump" else "standin"
    argv = _argv(files, pats, "cap", *flags, *(["--json"] if json_out else []))
    got, want = _both(argv, capsys, dump)
    assert got[1:] == want[1:]
    if json_out:
        blob = _assert_blobs_equal(got[0], want[0])
        if "--offsets" in flags:
            assert len(blob["offsets"]) > 20 and len(blob["unique_patterns"]) > 20
        if dump is not None:
            assert blob["dumped_packets"] > 10
    else:
        assert got[0] == want[0] and len(got[0]) > 10
    if dump is not None:
        assert len(got[2]) > 24
    if name == "staging-packed-dump":
        assert got[1][0].startswith("# note: --dump-matches uses the per-row kernel")


@pytest.mark.parametrize("flags", [
    ["--offsets"], ["--dump-matches", "{dump}"], ["--offsets", "--dump-matches", "{dump}"],
    ["--offsets", "--reorder", "--json"], ["--offsets", "--dump-matches", "{dump}", "--json"],
    ["--pcap", "{flows}", "--offsets", "--json"], ["--offsets", "--engine", "window", "--json"],
], ids=["offsets", "dump", "offsets-dump", "reorder-json", "offsets-dump-json",
        "two-pcaps-json", "window-json"])
def test_flows_equals_jax(files, capsys, monkeypatch, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    flags, dump = _fill(files, flags, "flows_" + "_".join(f.strip("-{}") for f in flags))
    argv = _argv(files, "standin", "flows", "--mode", "tcp", "--flows", *flags)
    got, want = _both(argv, capsys, dump)
    assert got[1:] == want[1:]
    if "--json" in flags:
        blob = _assert_blobs_equal(got[0], want[0])
        if "--offsets" in flags:
            assert len(blob["offsets"]) >= 20 and all(len(r) == 4 for r in blob["offsets"])
    else:
        assert got[0] == want[0]
        if "--offsets" in flags:
            assert sum(ln.startswith("flow ") for ln in got[0]) >= 20
    if dump is not None:
        assert len(got[2]) > 24


def test_flows_dump_of_quiet_capture_equals_jax(files, capsys, monkeypatch):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    dump = files["dir"] / "quiet_dump.pcap"
    argv = _argv(files, "standin", "quiet", "--mode", "tcp", "--flows", "--offsets",
                 "--dump-matches", str(dump), "--json")
    got, want = _both(argv, capsys, dump)
    assert got[1:] == want[1:] and len(got[2]) == 24
    assert _assert_blobs_equal(got[0], want[0])["offsets"] == []


@pytest.mark.parametrize("flags", [
    ["--offsets"], ["--dump-matches", "{dump}"], ["--offsets", "--dump-matches", "{dump}"],
    ["--per-packet", "--dump-matches", "{dump}"],
], ids=["offsets", "dump", "offsets-dump", "per-packet-dump"])
@pytest.mark.parametrize("axis", ["packets", "patterns", "both"])
def test_sharded_equals_jax(files, capsys, monkeypatch, axis, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    flags, dump = _fill(files, flags, f"sh_{axis}_{len(flags)}_{flags[0]}")
    argv = _argv(files, "nul", "cap", "--sharded", "--shard-axis", axis, "--json", *flags)
    got, want = _both(argv, capsys, dump)
    assert got[1:] == want[1:]
    blob = _assert_blobs_equal(got[0], want[0])
    assert blob["execution"]["shard_axis"] == axis
    unsharded = json.loads(_run(pt_main, [a for a in argv if a not in (
        "--sharded", "--shard-axis", axis)], capsys)[0][-1])
    assert blob["counts"] == unsharded["counts"]
    if "--offsets" in flags:
        assert blob["offsets"] == unsharded["offsets"] and len(blob["offsets"]) > 20


@pytest.mark.parametrize("axis", ["packets", "patterns", "both"])
def test_flows_sharded_equals_jax(files, capsys, monkeypatch, axis):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    dump = files["dir"] / f"flows_sh_{axis}.pcap"
    argv = _argv(files, "standin", "flows", "--mode", "tcp", "--flows", "--sharded",
                 "--shard-axis", axis, "--offsets", "--dump-matches", str(dump), "--json")
    got, want = _both(argv, capsys, dump)
    assert got[1:] == want[1:]
    blob = _assert_blobs_equal(got[0], want[0])
    assert len(blob["offsets"]) >= 20


@pytest.mark.parametrize("flags", [
    ["--offsets", "--json"], ["--dump-matches", "{dump}", "--json"],
    ["--offsets", "--dump-matches", "{dump}"], ["--offsets", "--host-workers", "2", "--json"],
    ["--offsets", "--dump-matches", "{dump}", "--sharded", "--json"],
    ["--offsets", "--sharded", "--shard-axis", "patterns", "--json"],
    ["--offsets", "--engine", "window", "--json"],
    ["--pcap", "{cap2}", "--offsets", "--dump-matches", "{dump}", "--json"],
], ids=["offsets", "dump", "offsets-dump-text", "host-workers", "sharded", "sharded-patterns",
        "window", "two-pcaps"])
def test_stream_equals_jax(files, capsys, monkeypatch, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    flags, dump = _fill(files, flags, "st_" + "_".join(f.strip("-{}") for f in flags))
    argv = _argv(files, "nul", "cap", "--stream", *flags)
    got, want = _both(argv, capsys, dump)
    if "--json" in flags:
        assert got[1:] == want[1:]
        blob = _assert_blobs_equal(got[0], want[0])
        one_shot = json.loads(_run(pt_main, [a for a in argv if a not in (
            "--stream", "--host-workers", "2", "--sharded", "--shard-axis", "patterns")],
            capsys)[0][-1])
        assert blob["counts"] == one_shot["counts"]
        if "--offsets" in flags:
            assert blob["offsets"] == one_shot["offsets"] and len(blob["offsets"]) > 20
    else:
        assert got == want and len(got[0]) > 20 and got[1][0].startswith("# wrote")


@pytest.mark.parametrize("flags", [
    ["--json"], [], ["--json", "--reorder"], ["--json", "--sharded"],
    ["--json", "--host-workers", "2"],
], ids=["json", "text", "reorder", "sharded", "host-workers"])
def test_flow_stream_offsets_equals_jax(files, capsys, monkeypatch, flags):
    """``--flows --stream --offsets``: text triples printed as each round
    is drained, JSON triples in the final blob; the same as JAX's."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.setenv("MSM_FLOW_BATCH", "16")
    argv = _argv(files, "standin", "flows", "--mode", "tcp", "--flows", "--stream",
                 "--engine", "window", "--offsets", *flags)
    got, want = _both(argv, capsys)
    if "--json" in flags:
        blob = _assert_blobs_equal(got[0], want[0])
        assert len(blob["offsets"]) >= 20 and all(len(r) == 6 for r in blob["offsets"])
        one_shot = json.loads(_run(pt_main, _argv(
            files, "standin", "flows", "--mode", "tcp", "--flows", "--offsets", "--json",
            *[f for f in flags if f == "--reorder"]), capsys)[0][-1])
        assert blob["counts"] == one_shot["counts"]
        keyed = sorted((tuple(one_shot["flow_keys"][f]), o, u)
                       for f, o, u, _ in one_shot["offsets"])
        assert sorted((tuple(r[:4]), r[4], r[5]) for r in blob["offsets"]) == keyed
    else:
        assert got == want and sum(ln.startswith("flow ") for ln in got[0]) >= 20


def test_attribution_imports_no_jax(files, tmp_path):
    """The attribution paths of the port run without importing jax or the
    JAX package."""
    dump = tmp_path / "nojax.pcap"
    code = (
        "import sys\n"
        "from multithreading_string_matching_tpu_torch import cli\n"
        f"base = ['match', '--pcap', {str(files['cap'])!r}, '--patterns', {str(STANDIN)!r}]\n"
        f"assert cli.main(base + ['--offsets', '--dump-matches', {str(dump)!r}, '--json']) == 0\n"
        "assert cli.main(base + ['--stream', '--offsets']) == 0\n"
        f"assert cli.main(['match', '--pcap', {str(files['flows'])!r}, '--patterns',\n"
        f"                 {str(STANDIN)!r}, '--mode', 'tcp', '--flows', '--stream',\n"
        "                 '--offsets']) == 0\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k.startswith('multithreading_string_matching_tpu.'))\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "MSM_NO_NATIVE"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env={**env, "MSM_DEVICE": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("NOJAX") and dump.stat().st_size > 24
