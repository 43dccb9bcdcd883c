"""The torch package's ``live`` command against the JAX CLI's, byte for
byte: the banner, ``N packet sniffed``, the counts and the ``Oops!`` line,
for udp and tcp, with and without host threads, under the MSM_STREAM_*
settings; ``--dump-matches`` files; the SIGINT drain; and the SIGHUP rule
reload with a good and a bad rules file.

Both command lines run in this process on a replayed capture.  The signals
are raised in-process by a replay source that raises them after a set
number of batches, so no test waits on another process's timing.
"""

import pathlib
import re
import signal

import pytest
import torch

from multithreading_string_matching_tpu.cli import main as jax_main
from multithreading_string_matching_tpu.io import live as jax_live
from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap, synth_udp_pcap
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io import live as pt_live
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = REPO / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"
PATS = load_patterns(STANDIN)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_live_cli")
    udp, tcp = d / "udp.pcap", d / "tcp.pcap"
    synth_udp_pcap(udp, 400, payload_len=140, payload_len_jitter=120, patterns=PATS,
                   plant_rate=0.5, invalid_rate=0.05, seed=7)
    flows = [((f"10.0.0.{i + 1}", "10.9.0.1", 1000 + i, 80),
              b"".join(PATS[(i * 7 + k) % len(PATS)] + b" filler " for k in range(40)))
             for i in range(12)]
    synth_tcp_flows_pcap(tcp, flows, segment_len=90, interleave_seed=3, noise_packets=20,
                         seed=8)
    none = d / "none.txt"
    none.write_bytes(b"qqqqzzzz xxyyxxyy\n")
    nul = d / "nul.txt"
    nul.write_bytes(b"\n".join(PATS[:30] + [b"a\x00b", b"\x00\x00"]) + b"\n")
    return {"udp": udp, "tcp": tcp, "none": none, "nul": nul, "dir": d}


def _both(argv, capsys, monkeypatch, env=None):
    """``(torch, jax)`` results of one argv: (rc, stdout, stderr) each."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    out = []
    for main in (pt_main, jax_main):
        rc = main([str(a) for a in argv])
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


@pytest.mark.parametrize("threads", [[], ["4"]], ids=["no threads", "4 threads"])
@pytest.mark.parametrize("mode", ["udp", "tcp"])
def test_live_output_equals_jax(files, capsys, monkeypatch, mode, threads):
    got, want = _both(["live", files[mode], STANDIN, *threads, mode], capsys, monkeypatch)
    assert got == want
    rc, out, _ = got
    assert rc == 0
    assert out.startswith("\nWork in progress...\nPress ctrl+c to stop sniffing procedure\n"
                          f"You can stop the procedure only if at least one {mode} packet "
                          "has been read\n\n\n")
    assert " packet sniffed\n" in out and " times!" in out


ENVS = {
    "unpacked": {"MSM_STREAM_PACKED": "0"},
    "small tiles": {"MSM_STREAM_TILE_ROWS": "64", "MSM_STREAM_BATCH": "3"},
    "narrow window": {"MSM_STREAM_PACKED": "0", "MSM_STREAM_WINDOW": "64"},
    "table route": {"MSM_PALLAS_TABLE": "1"},
}


@pytest.mark.parametrize("name", list(ENVS))
def test_live_stream_settings_equal_jax(files, capsys, monkeypatch, name):
    got, want = _both(["live", files["udp"], STANDIN, "udp"], capsys, monkeypatch, ENVS[name])
    assert got == want and got[0] == 0


@pytest.mark.parametrize("rules", ["none", "nul"])
def test_live_oops_and_nul_rules_equal_jax(files, capsys, monkeypatch, rules):
    got, want = _both(["live", files["udp"], files[rules], "udp"], capsys, monkeypatch)
    assert got == want and got[0] == 0
    assert ("Oops! We have not found any matches" in got[1]) == (rules == "none")


@pytest.mark.parametrize("env", [{}, {"MSM_STREAM_PACKED": "0"}], ids=["packed", "unpacked"])
def test_live_dump_matches_equals_jax_and_match(files, tmp_path, capsys, monkeypatch, env):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outs = {}
    for tag, main in (("pt", pt_main), ("jax", jax_main)):
        dump = tmp_path / f"{tag}.pcap"
        assert main(["live", str(files["udp"]), str(STANDIN), "udp",
                     "--dump-matches", str(dump)]) == 0
        cap = capsys.readouterr()
        outs[tag] = (cap.out, cap.err.replace(str(dump), "DUMP"))
    assert outs["pt"] == outs["jax"]
    assert (tmp_path / "pt.pcap").read_bytes() == (tmp_path / "jax.pcap").read_bytes()
    # The same packets as match --dump-matches on the capture.
    assert pt_main(["match", "--pcap", str(files["udp"]), "--patterns", str(STANDIN),
                    "--dump-matches", str(tmp_path / "match.pcap")]) == 0
    capsys.readouterr()
    assert (tmp_path / "pt.pcap").read_bytes() == (tmp_path / "match.pcap").read_bytes()
    assert read_pcap(tmp_path / "pt.pcap").num_packets > 0


@pytest.mark.parametrize("argv", [["live"], ["live", "x"], ["live", "x", "y", "--dump-matches"]])
def test_live_usage_equals_jax(capsys, monkeypatch, argv):
    got, want = _both(argv, capsys, monkeypatch)
    assert got == want and got[0] == 1 and got[1].startswith("USAGE: live")


def _signalling(base, after: int, sig, before=None):
    """A replay source that raises ``sig`` in this process as it yields
    batch ``after`` (calling ``before()`` first)."""

    class Source(base):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == after:
                    if before is not None:
                        before()
                    signal.raise_signal(sig)
                yield batch

    return Source


def _patched_run(files, capsys, monkeypatch, argv, make_source, reset=None):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    out = []
    for main, mod in ((pt_main, pt_live), (jax_main, jax_live)):
        if reset is not None:
            reset()
        monkeypatch.setattr(mod, "FileReplaySource", make_source(mod.FileReplaySource))
        old = signal.getsignal(signal.SIGINT), signal.getsignal(signal.SIGHUP)
        rc = main([str(a) for a in argv])
        assert (signal.getsignal(signal.SIGINT), signal.getsignal(signal.SIGHUP)) == old
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_live_sigint_drains_and_reports_like_jax(files, capsys, monkeypatch):
    got, want = _patched_run(
        files, capsys, monkeypatch, ["live", files["udp"], STANDIN, "udp"],
        lambda base: _signalling(base, 9, signal.SIGINT))
    assert got == want and got[0] == 0
    # Stopped after the tenth 10-packet batch: a partial run, drained (the
    # capture filter passes the UDP packets of those 100).
    sniffed = int(re.search(r"\n\n(\d+) packet sniffed\n\n", got[1])[1])
    assert 90 <= sniffed <= 100


@pytest.mark.parametrize("good", [True, False], ids=["good rules", "bad rules"])
def test_live_sighup_reload_like_jax(files, tmp_path, capsys, monkeypatch, good):
    rules = tmp_path / "rules.txt"
    first, second = PATS[:12], PATS[12:40]

    def reset():
        rules.write_bytes(b"\n".join(first) + b"\n")

    def swap():
        if good:
            rules.write_bytes(b"\n".join(second) + b"\n")
        else:
            rules.unlink()

    got, want = _patched_run(
        files, capsys, monkeypatch, ["live", files["udp"], rules, "udp"],
        lambda base: _signalling(base, 15, signal.SIGHUP, swap), reset)
    assert got == want and got[0] == 0
    rc, out, err = got
    # The tap stayed open across the swap: every UDP packet was sniffed.
    assert int(re.search(r"\n\n(\d+) packet sniffed\n\n", out)[1]) > 360
    if good:
        assert err.startswith("# rules reloaded; counts under the previous set:\n")
        reported = {ln.split(":")[0] for ln in out.splitlines() if ln.endswith(" times!")}
        assert reported and reported <= {p.decode() for p in second}
    else:
        assert err.startswith("# rules reload failed, keeping old set: ")
        assert any(ln.startswith(first[0].decode() + ": ") for ln in out.splitlines())
