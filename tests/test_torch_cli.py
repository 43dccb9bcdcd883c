"""The torch package's command line against the JAX package's: ``serial``
output byte for byte (but the elapsed-time line), ``match --json`` counts,
no jax import, and no silent fall-back from ``cuda`` to the CPU.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from multithreading_string_matching_tpu.cli import main as jax_main
from multithreading_string_matching_tpu.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "multithreading_string_matching_tpu_torch"
STANDIN = PKG / "data" / "strings_standin.txt"


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_cli") / "synth.pcap"
    synth_udp_pcap(path, 300, payload_len=120, payload_len_jitter=100,
                   patterns=load_patterns(STANDIN), plant_rate=0.6,
                   invalid_rate=0.05, seed=2)
    return path


def _env(**kw):
    env = dict(os.environ)
    env.pop("MSM_NO_NATIVE", None)
    env.update(kw)
    return env


def _run(pkg, *args, **env):
    return subprocess.run(
        [sys.executable, "-m", pkg, *map(str, args)],
        cwd=REPO, env=_env(**env), capture_output=True, text=True, timeout=300,
    )


def _drop_elapsed(text):
    return [ln for ln in text.splitlines() if not ln.startswith("Elapsed time = ")]


@pytest.mark.parametrize("mode", ["udp", "tcp"])
def test_serial_output_equals_jax_cli(capture, mode):
    got = _run("multithreading_string_matching_tpu_torch", "serial", capture, STANDIN, mode,
               MSM_DEVICE="cpu")
    want = _run("multithreading_string_matching_tpu", "serial", capture, STANDIN, mode,
                MSM_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert _drop_elapsed(got.stdout) == _drop_elapsed(want.stdout)
    assert re.search(r"^Elapsed time = \d+\.\d{6} seconds$", got.stdout, re.M)
    if mode == "udp":
        assert len(_drop_elapsed(got.stdout)) > 10  # real matches were reported


@pytest.mark.parametrize("flags", [[], ["--per-packet"], ["--nocase"], ["--engine", "window"],
                                   ["--mode", "tcp"]])
def test_match_json_counts_equal_jax(capture, capsys, monkeypatch, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    argv = ["match", "--pcap", str(capture), "--patterns", str(STANDIN), "--json", *flags]
    assert pt_main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    for key in ("patterns", "counts", "packets", "valid_payloads", "payload_bytes"):
        assert got[key] == want[key], key
    assert set(got["phases"]) == {"ingest", "extract", "scan"}
    assert got["execution"]["device"] == "cpu"


def test_match_text_report_and_errors(capture, capsys, monkeypatch):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    assert pt_main(["match", "--pcap", str(capture), "--patterns", str(STANDIN)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Printing the number of appereances")
    assert pt_main(["match", "--pcap", str(capture) + ".missing", "--patterns", str(STANDIN)]) == 1
    assert "error opening file" in capsys.readouterr().err
    # The DFA engines print the report the default engine printed.
    for engine in ("ac", "kmp"):
        assert pt_main(["match", "--pcap", str(capture), "--patterns", str(STANDIN),
                        "--engine", engine]) == 0
        got = capsys.readouterr().out.splitlines()
        assert [ln for ln in got if not ln.startswith("Elapsed")] == [
            ln for ln in out if not ln.startswith("Elapsed")]
    assert pt_main(["serial"]) == 1
    assert pt_main(["bogus"]) == 1
    with pytest.raises(SystemExit):
        pt_main(["serial", str(capture), str(STANDIN), "icmp"])
    with pytest.raises(SystemExit):
        pt_main(["match", "--pcap", str(capture), "--patterns", str(STANDIN), "--per-packet"])


def test_package_never_imports_jax(capture):
    code = (
        "import sys\n"
        "import multithreading_string_matching_tpu_torch as m\n"
        "from multithreading_string_matching_tpu_torch import cli\n"
        "from multithreading_string_matching_tpu_torch.ops import cuda_window, window, bucketing\n"
        "from multithreading_string_matching_tpu_torch.io import flows\n"
        "from multithreading_string_matching_tpu_torch.parallel import flow_stream, mesh\n"
        "from multithreading_string_matching_tpu_torch.parallel import pattern_shard as ps\n"
        "from multithreading_string_matching_tpu_torch.ops import mxu\n"
        "from multithreading_string_matching_tpu_torch.tools import mxu_match\n"
        "assert mxu.MxuMatcher([b'ab', b'b'], device='cpu')"
        ".count_tiles([([[97, 98, 98]], [3])]).tolist() == [1, 2]\n"
        "assert len(mxu_match.pattern_sets()) == 3\n"
        f"assert cli.main(['serial', {str(capture)!r}, {str(STANDIN)!r}, 'udp']) == 0\n"
        "pm = m.Matcher([b'ab', b'ba', b'abc'], device='cpu')\n"
        "c = ps.count_matches_pattern_sharded(pm, [[97, 98, 97, 99]], [4],\n"
        "                                     ps.make_2d_mesh(1, 2, ['cpu'] * 2))\n"
        "assert c.tolist() == [1, 1, 0], c\n"
        "assert mesh.count_rows_summary(pm, [[97, 98]], [2], mesh.make_mesh(['cpu']))[0][0] == 1\n"
        "fs = flow_stream.FlowStreamMatcher(m.Matcher([b'ab'], device='cpu'), 'udp',\n"
        "                                   engine='window')\n"
        f"fs.feed_pcap_slice(m.read_pcap({str(capture)!r}))\n"
        "fs.flush()\n"
        f"assert flows.extract_flows(m.read_pcap({str(capture)!r}), 'udp').num_flows == 1\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k.startswith('multithreading_string_matching_tpu.'))\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(MSM_DEVICE="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("NOJAX")


def test_no_jax_import_in_package_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert offenders == []


def test_cuda_device_never_falls_back_to_cpu(capture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Matcher([b"ab"], device="cuda")
    with pytest.raises(RuntimeError):
        Matcher([b"ab"])  # cuda is the default
    r = _run("multithreading_string_matching_tpu_torch", "serial", capture, STANDIN, "udp",
             MSM_DEVICE="cuda")
    assert r.returncode != 0
    assert "Printing the number" not in r.stdout
