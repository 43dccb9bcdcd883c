"""``match --strict``, ``--pattern-syntax`` and ``--profile`` of the torch
package's command line against the JAX CLI, and the new modules' import
hygiene: the live path (io/live.py, parallel/stream.py, utils/config.py)
imports no jax.

Counts are compared exactly.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from multithreading_string_matching_tpu.cli import main as jax_main
from multithreading_string_matching_tpu.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, write_pcap

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = REPO / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_match_options")
    cap = d / "synth.pcap"
    binary = [b"\x00\x01", b"a b", b"\\x", b"\xff\xfe\xfd"]
    synth_udp_pcap(cap, 300, payload_len=120, payload_len_jitter=100,
                   patterns=load_patterns(STANDIN)[:40] + binary, plant_rate=0.7,
                   invalid_rate=0.05, seed=21)
    # Every fifth frame an ARP ethertype over IPv4 bytes: the reference's
    # decode takes it, the strict checks drop it.
    pc = read_pcap(cap)
    buf = pc.buf.copy()
    for i in range(0, pc.num_packets, 5):
        buf[pc.offsets[i] + 12 : pc.offsets[i] + 14] = (8, 6)
    write_pcap(cap, dataclasses.replace(pc, buf=buf))
    escaped = d / "escaped.txt"
    escaped.write_bytes(b"\\x00\\x01 a\\x20b \\\\x \\xff\\xfe\\xfd http\n")
    return {"cap": cap, "escaped": escaped}


def _json(main, argv, capsys):
    assert main([str(a) for a in argv]) == 0
    blob = json.loads(capsys.readouterr().out)
    return {k: v for k, v in blob.items() if k not in ("phases", "execution")}


FLAGS = {
    "strict": ["--strict"],
    "strict tcp": ["--strict", "--mode", "tcp"],
    "strict streamed": ["--strict", "--stream"],
    "strict streamed dump": ["--strict", "--stream", "--dump-matches", "@dump"],
    "strict per packet": ["--strict", "--per-packet"],
    "escaped": ["--pattern-syntax", "escaped", "--patterns", "@escaped"],
    "escaped ac": ["--pattern-syntax", "escaped", "--patterns", "@escaped", "--engine", "ac"],
    "escaped streamed": ["--pattern-syntax", "escaped", "--patterns", "@escaped", "--stream"],
}


@pytest.mark.parametrize("name", list(FLAGS))
def test_match_options_equal_jax(files, tmp_path, capsys, monkeypatch, name):
    monkeypatch.setenv("MSM_DEVICE", "cpu")

    def argv(tag):
        fl = [str(tmp_path / f"{tag}.pcap") if f == "@dump" else
              str(files["escaped"]) if f == "@escaped" else f for f in FLAGS[name]]
        pats = [] if "--patterns" in fl else ["--patterns", STANDIN]
        return ["match", "--pcap", files["cap"], *pats, "--json", *fl]

    got = _json(pt_main, argv("t"), capsys)
    want = _json(jax_main, argv("j"), capsys)
    got.pop("dump_path", None), want.pop("dump_path", None)
    assert got == want
    if "--strict" in FLAGS[name] and "--stream" not in FLAGS[name]:
        plain = _json(pt_main, [a for a in argv("t") if a != "--strict"], capsys)
        assert plain["valid_payloads"] > got["valid_payloads"]  # the checks dropped some
    if name.startswith("escaped"):
        assert got["patterns"][:4] == ["\x00\x01", "a b", "\\x", "\xff\xfe\xfd"]
        assert all(got["counts"][:4])  # every binary pattern was planted and found
    if "@dump" in FLAGS[name]:
        assert (tmp_path / "t.pcap").read_bytes() == (tmp_path / "j.pcap").read_bytes()


def test_pattern_syntax_refusal_equals_jax(files, capsys, monkeypatch):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    argv = ["match", "--pcap", str(files["cap"]), "--patterns", str(STANDIN),
            "--pattern-syntax", "regex"]
    with pytest.raises(SystemExit) as got:
        pt_main(argv)
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    assert got.value.code == want.value.code == 2


@pytest.mark.parametrize("flags", [[], ["--stream"], ["--engine", "ac"]])
def test_profile_writes_a_trace(files, tmp_path, capsys, monkeypatch, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    out = tmp_path / "prof"
    argv = ["match", "--pcap", str(files["cap"]), "--patterns", str(STANDIN), "--json",
            "--profile", str(out), *flags]
    got = _json(pt_main, argv, capsys)
    traces = list(out.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert events
    assert got == _json(pt_main, argv[:-2 - len(flags)] + flags, capsys)


def test_profile_trace_written_on_error(files, tmp_path, capsys, monkeypatch):
    """The trace is written on every exit path, a failed run included."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    out = tmp_path / "prof"
    assert pt_main(["match", "--pcap", str(files["cap"]) + ".missing", "--patterns",
                    str(STANDIN), "--profile", str(out)]) == 1
    assert "error opening file" in capsys.readouterr().err
    assert len(list(out.glob("*.json"))) == 1


def test_profile_from_config(files, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"profile_dir": str(tmp_path / "p"), "patterns": str(STANDIN)}))
    _json(pt_main, ["match", "--pcap", files["cap"], "--config", cfg, "--json"], capsys)
    assert len(list((tmp_path / "p").glob("*.json"))) == 1


def test_live_path_imports_no_jax(files):
    code = (
        "import sys\n"
        "from multithreading_string_matching_tpu_torch import cli\n"
        "from multithreading_string_matching_tpu_torch.io import live\n"
        "from multithreading_string_matching_tpu_torch.parallel import StreamMatcher\n"
        "from multithreading_string_matching_tpu_torch.utils.config import MatchConfig\n"
        "from multithreading_string_matching_tpu_torch.api import Matcher\n"
        f"m = Matcher.from_file({str(STANDIN)!r}, device='cpu')\n"
        "s = StreamMatcher(m)\n"
        f"for b in live.FileReplaySource({str(files['cap'])!r}):\n"
        "    s.feed_pcap_slice(b, 'udp', bpf_filter=True)\n"
        "assert s.counts().sum() > 0 and s.tiles_dispatched >= 1\n"
        f"assert cli.main(['live', {str(files['cap'])!r}, {str(STANDIN)!r}, 'udp']) == 0\n"
        "assert MatchConfig.from_env().stream_batch == 10\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k.startswith('multithreading_string_matching_tpu.'))\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n"
    )
    env = dict(os.environ, MSM_DEVICE="cpu")
    env.pop("MSM_NO_NATIVE", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("NOJAX")


def test_matcher_from_file_defaults_to_the_card():
    from multithreading_string_matching_tpu_torch.api import Matcher

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Matcher.from_file(STANDIN)
    m = Matcher.from_file(STANDIN, engine="ac", device="cpu")
    assert m.patterns == load_patterns(STANDIN) and m.engine == "ac"
