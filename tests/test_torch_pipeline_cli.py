"""The torch package's ``data``, ``task``, ``synth`` and ``match --stream``
commands against the JAX package's CLI.

Text reports are compared byte for byte but the elapsed-time line: each
package runs its commands in one subprocess (with a timeout), the port on
``MSM_DEVICE=cpu``, JAX on ``MSM_PLATFORM=cpu``.  ``--json`` blobs (counts,
stats, keys) and the argument guards are compared in process.  Counts are
integers: every comparison is exact.
"""

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

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = REPO / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pipeline_cli")
    cap = d / "synth.pcap"
    synth_udp_pcap(cap, 400, payload_len=150, payload_len_jitter=140,
                   patterns=load_patterns(STANDIN), plant_rate=0.6, invalid_rate=0.05, seed=7)
    cap2 = d / "synth2.pcap"
    synth_udp_pcap(cap2, 150, payload_len=300, payload_len_jitter=100,
                   patterns=load_patterns(STANDIN), plant_rate=0.5, seed=8)
    return {"cap": cap, "cap2": cap2, "dir": d}


def _env(**kw):
    env = dict(os.environ)
    env.pop("MSM_NO_NATIVE", None)
    env.update(kw)
    return env


# Run several commands in one interpreter and print each one's stdout and
# exit code between markers.
_RUNNER = (
    "import contextlib, io, json, sys\n"
    "from {pkg}.cli import main\n"
    "for argv in json.loads(sys.argv[1]):\n"
    "    out = io.StringIO()\n"
    "    with contextlib.redirect_stdout(out):\n"
    "        rc = main(argv)\n"
    "    print('@@@', rc)\n"
    "    print(out.getvalue(), end='')\n"
)


def _run_all(pkg, commands, **env):
    r = subprocess.run([sys.executable, "-c", _RUNNER.format(pkg=pkg), json.dumps(commands)],
                       cwd=REPO, env=_env(**env), capture_output=True, text=True,
                       timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr
    parts = r.stdout.split("@@@ ")[1:]
    assert len(parts) == len(commands), r.stdout
    return [(int(p.split("\n", 1)[0]), [ln for ln in p.split("\n", 1)[1].splitlines()
                                        if not ln.startswith("Elapsed time = ")])
            for p in parts]


def _commands(files, out_dir):
    cap, cap2, pats = str(files["cap"]), str(files["cap2"]), str(STANDIN)
    match = ["match", "--pcap", cap, "--patterns", pats]
    return {
        "data": ["data", cap, pats, "udp"],
        "data-4-threads": ["data", cap, pats, "4", "udp"],
        "data-tcp": ["data", cap, pats, "1", "tcp"],
        "task": ["task", cap, pats],
        "task-4-threads": ["task", cap, pats, "4", "udp"],
        "task-2-threads": ["task", cap2, pats, "2"],
        "synth": ["synth", str(out_dir / "synth_{pkg}.pcap"), "60", "200", pats],
        "match-stream": match + ["--stream"],
        "match-stream-two-files": match + ["--pcap", cap2, "--stream", "--host-workers", "2"],
        "match-stream-sharded": match + ["--stream", "--sharded", "--host-workers", "2"],
        "match-staging-packed": match + ["--staging", "packed"],
        "match-staging-bucketed": match + ["--staging", "bucketed"],
        "usage-data": ["data", cap],
        "usage-task": ["task"],
        "usage-synth": ["synth", "x.pcap"],
    }


def test_text_reports_equal_jax_cli(files):
    """Every command's report, line for line (the elapsed-time line aside),
    and its exit code; ``synth`` writes the same bytes."""
    out_dir = files["dir"]
    cmds = _commands(files, out_dir)
    got = _run_all("multithreading_string_matching_tpu_torch",
                   [[a.replace("{pkg}", "torch") for a in argv] for argv in cmds.values()],
                   MSM_DEVICE="cpu")
    want = _run_all("multithreading_string_matching_tpu",
                    [[a.replace("{pkg}", "jax") for a in argv] for argv in cmds.values()],
                    MSM_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    for name, g, w in zip(cmds, got, want):
        if name == "synth":
            assert g[1] == [ln.replace("synth_jax", "synth_torch") for ln in w[1]]
            continue
        assert g == w, name
        if not name.startswith("usage"):
            assert g[0] == 0 and len(g[1]) > 10, name  # real matches were reported
    assert (out_dir / "synth_torch.pcap").read_bytes() == (out_dir / "synth_jax.pcap").read_bytes()
    rep = dict(zip(cmds, got))
    assert rep["data"] == rep["data-4-threads"] == rep["task"] == rep["task-4-threads"]
    assert rep["match-stream"][1] == rep["data"][1]


def _blob(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.splitlines()[-1])


@pytest.mark.parametrize("flags", [
    [], ["--host-workers", "2"], ["--sharded"], ["--sharded", "--shard-axis", "patterns"],
    ["--sharded", "--shard-axis", "both", "--host-workers", "3"], ["--nocase"],
    ["--engine", "window"], ["--mode", "tcp"], ["nul"],
], ids=["plain", "host-workers", "sharded", "sharded-patterns", "sharded-both", "nocase",
        "window", "tcp", "nul-set"])
def test_match_stream_json_equals_jax(files, capsys, monkeypatch, flags):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    pats = STANDIN
    if flags == ["nul"]:
        pats = files["dir"] / "nul_set.txt"
        pats.write_bytes(STANDIN.read_bytes() + b"\nx\x00\n\x00\n")  # raw NUL bytes
        flags = []
    argv = ["match", "--pcap", str(files["cap"]), "--pcap", str(files["cap2"]),
            "--patterns", str(pats), "--stream", "--json", *flags]
    got = _blob(pt_main, argv, capsys)
    want = _blob(jax_main, argv, capsys)
    assert set(got) == set(want)
    for key in ("patterns", "counts", "packets", "valid_payloads", "payload_bytes",
                "host_workers"):
        assert got.get(key) == want.get(key), key
    assert set(got["phases"]) == set(want["phases"]) == {"scan"}
    assert got["counts"][-1] > 0 if pats != STANDIN else sum(got["counts"]) > 0
    # The port's blob names its device; otherwise the keys are JAX's (a
    # pallas matcher on the CPU reports pallas where JAX degrades).
    assert set(got["execution"]) - {"device", "pallas_kernel"} == (
        set(want["execution"]) - {"pallas_kernel", "streamed_remap", "sharded_remap"})
    assert got["execution"].get("shard_axis") == want["execution"].get("shard_axis")
    if "--engine" in flags:
        assert got["execution"] == {**want["execution"], "device": "cpu"}


@pytest.mark.parametrize("argv, message", [
    (["--host-workers", "2"], "--host-workers requires --stream"),
    (["--stream", "--per-packet", "--json"], "--stream is incompatible with --per-packet"),
    (["--distributed"], "--distributed requires --stream"),
    (["--stream", "--distributed", "--sharded"], "--distributed streaming is counts-only"),
    (["--shard-axis", "patterns"], "--shard-axis requires --sharded"),
    (["--reorder"], "--reorder requires --flows"),
    (["--flows", "--stream", "--dump-matches", "x.pcap"], "--flows --dump-matches is one-shot"),
])
def test_guards_exit_like_jax(files, monkeypatch, argv, message):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    base = ["match", "--pcap", str(files["cap"]), "--patterns", str(STANDIN)]
    with pytest.raises(SystemExit) as got:
        pt_main(base + argv)
    with pytest.raises(SystemExit) as want:
        jax_main(base + argv)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(message)


def test_negative_host_workers_and_unported(files, capsys, monkeypatch, tmp_path):
    """Negative worker counts exit like JAX; ``--stream --distributed``
    stays refused; the attribution options and a repeated ``--pcap`` (once
    refused here) print what the JAX CLI prints and dump the same bytes."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)  # the relative dump path lands here
    base = ["match", "--pcap", str(files["cap"]), "--patterns", str(STANDIN)]
    for argv in (["--host-workers", "-1"], ["--stream", "--host-workers", "-2"]):
        assert pt_main(base + argv) == jax_main(base + argv) == 1
        err = capsys.readouterr().err.splitlines()
        assert err == ["error: host_workers must be >= 0"] * 2
    assert pt_main(base + ["--stream", "--distributed"]) == 1
    assert "not yet ported" in capsys.readouterr().err
    for argv in (["--stream", "--offsets"], ["--stream", "--dump-matches", "x.pcap"],
                 ["--pcap", str(files["cap2"])]):
        outs = []
        for main in (pt_main, jax_main):
            assert main(base + argv) == 0
            cap = capsys.readouterr()
            dumped = (tmp_path / "x.pcap").read_bytes() if "x.pcap" in argv else None
            outs.append(([ln for ln in cap.out.splitlines()
                          if not ln.startswith("Elapsed time = ")],
                         [ln for ln in cap.err.splitlines() if ln.startswith("# wrote")],
                         dumped))
        assert outs[0] == outs[1] and len(outs[0][0]) > 10, argv


def test_pipeline_modules_import_no_jax(files):
    code = (
        "import sys\n"
        "from multithreading_string_matching_tpu_torch import Matcher, cli\n"
        "from multithreading_string_matching_tpu_torch.parallel import host, pipeline, stager\n"
        "m = Matcher([b'ab', b'ba'], device='cpu')\n"
        f"c = pipeline.count_pcap_streamed(m, {str(files['cap'])!r}, tile_rows=8,\n"
        "                                  pack_width=512, host_workers=2)\n"
        f"assert (c == pipeline.count_pcap_pipelined(m, {str(files['cap'])!r})).all()\n"
        f"assert (c == m.count_pcap({str(files['cap'])!r})).all() and c.sum() > 0\n"
        f"assert cli.main(['task', {str(files['cap'])!r}, {str(STANDIN)!r}, '2']) == 0\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k.startswith('multithreading_string_matching_tpu.'))\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(MSM_DEVICE="cpu"),
                       capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("NOJAX")
