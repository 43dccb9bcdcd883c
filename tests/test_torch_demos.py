"""The torch package's worked examples (``examples/ids_demo.py`` and
``examples/flow_ids_demo.py`` under the package) against the JAX
package's ``examples/``: each runs in a subprocess on the CPU
(``MSM_DEVICE=cpu`` for the port, ``MSM_PLATFORM=cpu`` for JAX), and its
stdout must equal the JAX demo's line for line; a dump written with
``MSM_DUMP`` must be byte-equal.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.synth import synth_tcp_flows_pcap, synth_udp_pcap

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = REPO / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"
PORT = "multithreading_string_matching_tpu_torch.examples."


def _run(argv, **env):
    e = dict(os.environ, OMP_NUM_THREADS="1", **env)
    r = subprocess.run([sys.executable, *map(str, argv)], cwd=REPO, env=e,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _both(demo, *args, **env):
    """``(port stdout, JAX stdout)`` of one demo on the same arguments;
    ``env`` values may hold ``{which}``, filled with ``port`` or ``jax``."""
    port = _run(["-m", PORT + demo, *args], MSM_DEVICE="cpu",
                **{k: v.format(which="port") for k, v in env.items()})
    jax = _run([REPO / "examples" / f"{demo}.py", *args], MSM_PLATFORM="cpu",
               **{k: v.format(which="jax") for k, v in env.items()})
    return port, jax


def test_flow_demo_synthesized_capture_equals_jax():
    port, jax = _both("flow_ids_demo")
    # The first line names the demo's own temporary capture.
    path = re.compile(r"(?m)^(# no args: synthesized split-signature demo at ).*$")
    assert path.search(port) and path.search(jax)
    port, jax = path.sub(r"\1<tmp>", port), path.sub(r"\1<tmp>", jax)
    assert port == jax
    assert port.count("\nALERT flow") == 3 and port.count("STREAM-ALERT") == 3
    assert "MISSED 1 x 'EVILPAYLOAD'" in port


def test_ids_demo_with_dump_equals_jax(tmp_path):
    cap = tmp_path / "synth.pcap"
    synth_udp_pcap(cap, 300, payload_len=200, payload_len_jitter=180,
                   patterns=load_patterns(STANDIN), plant_rate=0.5, invalid_rate=0.05, seed=7)
    dump = str(tmp_path / "hits-{which}.pcap")
    port, jax = _both("ids_demo", cap, STANDIN, "udp", MSM_DUMP=dump)
    assert port.replace("hits-port", "hits-jax") == jax
    assert port.count("ALERT packet=") > 100
    assert (tmp_path / "hits-port.pcap").read_bytes() == (tmp_path / "hits-jax.pcap").read_bytes()


def test_demos_on_a_tcp_flow_capture_equal_jax(tmp_path):
    """Both demos on one seeded capture of interleaved TCP flows with the
    stand-in signatures planted across segment boundaries."""
    pats = load_patterns(STANDIN)
    flows = []
    for i in range(6):
        body = b"".join(pats[(7 * i + j) % len(pats)] + b" filler %d " % j for j in range(12))
        flows.append(((f"10.1.0.{i + 1}", "10.2.0.1", 40000 + i, 80), body,
                      [len(body) // 3, len(body) // 3, len(body) - 2 * (len(body) // 3)]))
    cap = tmp_path / "flows.pcap"
    synth_tcp_flows_pcap(cap, flows, interleave_seed=5, seed=5)
    for demo in ("flow_ids_demo", "ids_demo"):
        port, jax = _both(demo, cap, STANDIN, "tcp")
        assert port == jax, demo
        assert "ALERT" in port


def test_demos_need_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts without one")
    cap = tmp_path / "synth.pcap"
    synth_udp_pcap(cap, 20, payload_len=64, patterns=[b"ab"], plant_rate=1.0, seed=1)
    for demo in ("ids_demo", "flow_ids_demo"):
        r = subprocess.run([sys.executable, "-m", PORT + demo, str(cap), str(STANDIN)],
                           cwd=REPO, capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, MSM_DEVICE="cuda"))
        assert r.returncode != 0 and "ALERT" not in r.stdout, demo
        assert "CUDA is not available" in r.stderr
