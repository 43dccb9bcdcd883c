"""The torch package's ``match --sharded`` against the JAX package's CLI on
the packet, pattern and 2-D axes: counts, per-packet matrices and the text
report, for the stand-in set and a set of more than 512 words; one-shot
``--flows --sharded`` on the three axes, the empty capture, the streamed
flow lanes and the refused streamed pattern axis; and the sharded
``FlowStreamMatcher`` against the JAX package's.

The port runs on the CPU (``MSM_DEVICE=cpu``: a mesh of one shard by
default, or the CPU meshes the tests build); JAX on its 8-device CPU mesh.
Counts are integers: every comparison is exact.  Fields that name the
platform (the engine JAX degrades to on the CPU, the mesh size ``auto``
sees) are not compared.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.cli import main as jax_main
from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.io.pcap import read_pcap as jax_read
from multithreading_string_matching_tpu.io.pcap import slice_pcap as jax_slice
from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap, synth_udp_pcap
from multithreading_string_matching_tpu.parallel.flow_stream import (
    FlowStreamMatcher as JaxFlowStream,
)
from multithreading_string_matching_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher
from multithreading_string_matching_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = REPO / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A UDP capture planted with the stand-in set and with a 160-rule set
    of 13-20 byte rules (over 512 words: the table route)."""
    d = tmp_path_factory.mktemp("torch_sharded_cli")
    rng = np.random.default_rng(5)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    rules = list(dict.fromkeys(
        bytes(letters[rng.integers(0, 26, size=int(rng.integers(13, 21)))]) for _ in range(160)))
    large = d / "large.txt"
    large.write_bytes(b"\n".join(rules) + b"\n")
    cap = d / "synth.pcap"
    synth_udp_pcap(cap, 200, payload_len=160, payload_len_jitter=120,
                   patterns=load_patterns(STANDIN) + rules, plant_rate=0.6,
                   invalid_rate=0.05, seed=3)
    return {"cap": cap, "standin": STANDIN, "large": large}


def _json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.splitlines()[-1])


@pytest.mark.parametrize("flags", [[], ["--per-packet"], ["--nocase"]],
                         ids=["totals", "per-packet", "nocase"])
@pytest.mark.parametrize("axis", ["packets", "patterns", "both"])
@pytest.mark.parametrize("rules", ["standin", "large"])
def test_match_sharded_json_equals_jax(files, capsys, monkeypatch, rules, axis, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    argv = ["match", "--pcap", str(files["cap"]), "--patterns", str(files[rules]), "--json",
            "--sharded", "--shard-axis", axis, *flags]
    got = _json(pt_main, argv, capsys)
    want = _json(jax_main, argv, capsys)
    for key in ("patterns", "counts", "packets", "valid_payloads", "payload_bytes"):
        assert got[key] == want[key], key
    unsharded = _json(pt_main, argv[:-(3 + len(flags))] + flags, capsys)
    assert got["counts"] == unsharded["counts"]
    assert got["execution"]["shard_axis"] == want["execution"]["shard_axis"] == axis
    assert got["execution"]["device"] == "cpu"
    assert np.asarray(got["counts"]).sum() > 20
    if rules == "large" and axis != "packets":
        assert got["execution"]["pallas_kernel"] == "table+filter"


@pytest.mark.parametrize("axis", ["packets", "patterns"])
def test_match_sharded_text_report_equals_jax(files, capsys, monkeypatch, axis):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    argv = ["match", "--pcap", str(files["cap"]), "--patterns", str(files["large"]),
            "--sharded", "--shard-axis", axis]

    def drop(lines):
        return [ln for ln in lines if not ln.startswith("Elapsed time = ")]

    assert pt_main(argv) == 0
    got = drop(capsys.readouterr().out.splitlines())
    assert jax_main(argv) == 0
    want = drop(capsys.readouterr().out.splitlines())
    assert got == want and len(got) > 10


def test_auto_axis_and_flag_errors(files, capsys, monkeypatch):
    """``auto`` resolves through choose_shard_axis with the mesh's device
    count: one CPU shard here, so the packet axis, as the JAX package picks
    with one device; ``--shard-axis`` without ``--sharded`` exits."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    base = ["match", "--pcap", str(files["cap"]), "--patterns", str(files["large"]), "--json"]
    got = _json(pt_main, base + ["--sharded"], capsys)
    assert got["execution"]["shard_axis"] == "packets"
    assert got["counts"] == _json(pt_main, base, capsys)["counts"]
    for main in (pt_main, jax_main):
        with pytest.raises(SystemExit, match="--shard-axis requires --sharded"):
            main(base + ["--shard-axis", "patterns"])


@pytest.mark.parametrize("flags", [["--offsets"], ["--dump-matches", "x.pcap"],
                                   ["--flows", "--offsets"]],
                         ids=["offsets", "dump", "flows-offsets"])
def test_unported_sharded_options_exit_1(files, capsys, monkeypatch, tmp_path, flags):
    """Once refused here: the sharded attribution options now print what
    the JAX CLI prints, and dump the same bytes."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)  # the relative dump path lands here
    argv = ["match", "--pcap", str(files["cap"]), "--patterns", str(files["standin"]),
            "--sharded", "--shard-axis", "patterns", *flags]
    outs = []
    for main in (pt_main, jax_main):
        assert main(argv) == 0
        out = capsys.readouterr().out.splitlines()
        outs.append(([ln for ln in out if not ln.startswith("Elapsed time = ")],
                     (tmp_path / "x.pcap").read_bytes() if "x.pcap" in flags else None))
    assert outs[0] == outs[1] and len(outs[0][0]) > 10


def test_sharded_ac_engine(files, capsys, monkeypatch):
    """``--engine ac``: the pattern axis remaps to the window family as the
    JAX package does (same counts, same ``sharded_remap``); the packet axis
    runs the AC scan on each shard, to the JAX CLI's counts and execution
    keys."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    base = ["match", "--pcap", str(files["cap"]), "--patterns", str(files["standin"]), "--json",
            "--engine", "ac", "--sharded"]
    got = _json(pt_main, base + ["--shard-axis", "patterns"], capsys)
    want = _json(jax_main, base + ["--shard-axis", "patterns"], capsys)
    assert got["counts"] == want["counts"]
    assert got["execution"]["sharded_remap"] == want["execution"]["sharded_remap"] == "ac->window"
    got = _json(pt_main, base + ["--shard-axis", "packets"], capsys)
    want = _json(jax_main, base + ["--shard-axis", "packets"], capsys)
    assert got["counts"] == want["counts"] and sum(got["counts"]) > 0
    assert {k: v for k, v in got["execution"].items() if k != "device"} == want["execution"]
    assert got["execution"]["engine_resolved"] == "ac"


# -- flows --------------------------------------------------------------------

FLOWS = [
    (("10.0.0.1", "10.0.0.2", 1111, 80), b"xxSIGNATUREyy", [4, 5, 4]),
    (("10.0.0.3", "10.0.0.2", 2222, 80), b"SIGpqSIGr", [3, 3, 3]),
    (("10.0.0.4", "10.0.0.2", 3333, 80), b"no hits here", [6, 6]),
]


@pytest.fixture()
def flow_files(tmp_path):
    cap = tmp_path / "flows.pcap"
    synth_tcp_flows_pcap(cap, FLOWS, interleave_seed=11)
    strings = tmp_path / "strings.txt"
    strings.write_text("SIGNATURE\nSIG\n")
    return cap, strings


def _flow_argv(cap, strings, *extra):
    return ["match", "--pcap", str(cap), "--patterns", str(strings), "--mode", "tcp",
            "--flows", "--json", *extra]


@pytest.mark.parametrize("axis", ["packets", "patterns", "both"])
def test_flows_sharded_equals_jax(flow_files, capsys, monkeypatch, axis):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    argv = _flow_argv(*flow_files, "--sharded", "--shard-axis", axis)
    got, want = _json(pt_main, argv, capsys), _json(jax_main, argv, capsys)
    assert got["counts"] == want["counts"] == [1, 3]
    for key in ("patterns", "flows", "flow_packets", "packets", "stream_bytes"):
        assert got[key] == want[key], key


def test_flows_sharded_empty_capture(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    cap = tmp_path / "empty.pcap"
    synth_tcp_flows_pcap(cap, [], noise_packets=4)
    strings = tmp_path / "strings.txt"
    strings.write_text("SIG\n")
    for axis in ("packets", "patterns"):
        argv = _flow_argv(cap, strings, "--sharded", "--shard-axis", axis)
        got, want = _json(pt_main, argv, capsys), _json(jax_main, argv, capsys)
        assert got["counts"] == want["counts"] == [0] and got["flows"] == want["flows"] == 0


def test_flows_stream_sharded_lanes(flow_files, capsys, monkeypatch):
    """Streamed flow lanes over the mesh (the window engine; JAX on the CPU
    takes its AC lanes): counts equal, auto takes the lane axis."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.setenv("MSM_FLOW_BATCH", "4")
    got = _json(pt_main, _flow_argv(*flow_files, "--stream", "--engine", "window", "--sharded"),
                capsys)
    want = _json(jax_main, _flow_argv(*flow_files, "--stream", "--sharded"), capsys)
    assert got["counts"] == want["counts"] == [1, 3] and got["flows"] == want["flows"] == 3
    got_p = _json(pt_main, _flow_argv(*flow_files, "--stream", "--engine", "window", "--sharded",
                                      "--shard-axis", "packets"), capsys)
    assert got_p["counts"] == [1, 3]


@pytest.mark.parametrize("axis", ["patterns", "both"])
def test_flows_stream_pattern_axis_rejected(flow_files, monkeypatch, axis):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    argv = _flow_argv(*flow_files, "--stream", "--engine", "window", "--sharded",
                      "--shard-axis", axis)
    for main in (pt_main, jax_main):
        with pytest.raises(SystemExit, match="flow-lane axis"):
            main(argv)


# -- the sharded flow stream against the JAX package's -----------------------

KEY_A = ("10.0.0.1", "10.0.0.2", 1111, 80)
KEY_B = ("10.0.0.3", "10.0.0.2", 2222, 80)
PAY_A = b"xxxxSIGNATUREyyySIGNATUREzz"
PAY_B = b"ppppSIGNATUREqq"
PATS = [b"SIGNATURE", b"zz", b"pp"]


@pytest.mark.parametrize("ndev", [2, 3, 8])
@pytest.mark.parametrize("engine", ["window", "pallas"])
def test_sharded_flow_stream_equals_jax(tmp_path, engine, ndev):
    """Flow lanes over CPU meshes (3 shards: lanes round up to a multiple
    of 3), against the JAX package's sharded window stream on its mesh."""
    p = tmp_path / "flows.pcap"
    synth_tcp_flows_pcap(p, [(KEY_A, PAY_A, [8, 8, 7, 4]), (KEY_B, PAY_B, [5, 5, 5])],
                         interleave_seed=9, noise_packets=3)
    kw = dict(engine="window", scan_bytes=10, width=8, min_lanes=8)
    jfs = JaxFlowStream(JaxMatcher(PATS, engine="window"), "tcp", sharded=True,
                        mesh=jax_make_mesh(jax.devices("cpu")[:8]), **kw)
    fs = FlowStreamMatcher(Matcher(PATS, engine=engine, device="cpu"), "tcp", sharded=True,
                           mesh=make_mesh(["cpu"] * ndev), **kw)
    assert fs.min_lanes == max(8, ndev)
    jp, pp = jax_read(p), read_pcap(p)
    for s in range(0, pp.num_packets, 3):
        jfs.feed_pcap_slice(jax_slice(jp, s, s + 3, copy=False))
        fs.feed_pcap_slice(slice_pcap(pp, s, s + 3, copy=False))
    jfs.flush()
    fs.flush()
    assert fs.counts().tolist() == jfs.counts().tolist() == [3, 1, 3]
    assert fs._round > 1


def test_sharded_flow_stream_nul_and_nocase(tmp_path):
    p1, p2 = tmp_path / "s1.pcap", tmp_path / "s2.pcap"
    synth_tcp_flows_pcap(p1, [(KEY_A, b"xxE\x00", [4])])
    synth_tcp_flows_pcap(p2, [(KEY_A, b"Fyy", [3]), (KEY_B, b"qAb", [3])])
    for engine in ("window", "pallas"):
        fs = FlowStreamMatcher(Matcher([b"E\x00F", b"ab"], engine=engine, case_insensitive=True,
                                       device="cpu"),
                               "tcp", engine="window", scan_bytes=1, width=4, min_lanes=4,
                               sharded=True, mesh=make_mesh(["cpu"] * 4))
        for path in (p1, p2):
            fs.feed_pcap_slice(read_pcap(path))
            fs.flush()
        assert fs.counts().tolist() == [1, 1], engine


def test_sharded_flow_stream_default_mesh_and_refusals():
    m = Matcher(PATS, device="cpu")
    fs = FlowStreamMatcher(m, "tcp", engine="window", sharded=True)
    assert fs.mesh == make_mesh(device_type="cpu") and fs._n_dev == 1
    fs = FlowStreamMatcher(m, "tcp", engine="ac", sharded=True)  # once refused here
    assert fs.engine == "ac" and fs.mesh == make_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="mesh"):
        FlowStreamMatcher(m, "tcp", engine="window", mesh=make_mesh(["cpu"]))
