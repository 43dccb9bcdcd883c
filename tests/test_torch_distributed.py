"""The torch package's multi-process path (parallel/distributed.py, the
``mesh``/``mpi`` commands and ``match --stream --distributed``) against the
JAX package's.

Ranks are separate processes on this CPU joined by a gloo process group
(``MSM_COORDINATOR`` on a free 127.0.0.1 port, ``MSM_NUM_PROCESSES``,
``MSM_PROCESS_ID``), each with one torch thread and every wait under a
timeout.  The JAX package runs its single-process functions in this
process on conftest's 8 CPU devices (its ``pallas`` engine in interpret
mode, as its own tests run it).  Counts are integers: every comparison is
exact (tolerance 0), against the JAX package and ``tests/oracle.py``.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.cli import main as jax_main
from multithreading_string_matching_tpu.parallel import distributed as jd
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.pcap import classic_global_header
from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu_torch.parallel import distributed as pd
from multithreading_string_matching_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN_FILE = REPO / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"
STANDIN = load_patterns(STANDIN_FILE)
NOCASE = [b"http", b"lInUx", b"NOTIFY", b"xml"]
NUL_SET = STANDIN + [b"a\x00b", b"\x00"]
ENGINES = ("pallas", "window", "ac")
PACKETS = 160
STREAM_KW = dict(batch_packets=50, tile_rows=64)
TIMEOUT_S = 120

# One rank of a gloo group: the steps of ``job`` in order, each rank's
# results written to ``job["out"] % rank``.
WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.parallel import distributed as pd

job = json.loads(sys.argv[1])
out = {"init": [pd.initialize_from_env(), pd.initialize_from_env()]}
rank = dist.get_rank()
out["world"] = [dist.get_world_size(), rank]


def res(r, **kw):
    return {"counts": np.asarray(r.counts).tolist(), "dtype": str(r.counts.dtype),
            "local_packets": r.local_packets, "local_payload_bytes": r.local_payload_bytes,
            "elapsed_max_s": r.elapsed_max_s, **kw}


m = Matcher(load_patterns(job["patterns"]), device="cpu")
for step in job["steps"]:
    if step == "oneshot":
        for e in ("pallas", "window", "ac"):
            out[e] = res(pd.count_pcap_distributed(m, job["cap"], engine=e))
    elif step == "nocase":
        mc = Matcher([p.encode() for p in job["nocase"]], case_insensitive=True, device="cpu")
        for e in ("pallas", "window", "ac"):
            out["nocase_" + e] = res(pd.count_pcap_distributed(mc, job["nocase_cap"], engine=e))
    elif step == "stream":
        for hw in (0, 2):
            st = {}
            r = pd.count_pcap_streamed_distributed(m, job["cap"], stats=st, host_workers=hw,
                                                   **job["stream_kw"])
            out[f"stream_{hw}"] = res(r, stats=st)
    elif step == "nul":
        mn = Matcher(load_patterns(job["nul_patterns"], syntax="escaped"), device="cpu")
        st = {}
        r = pd.count_pcap_streamed_distributed(mn, job["cap"], stats=st, **job["stream_kw"])
        out["nul"] = res(r, stats=st)
    elif step == "int64":
        vals = np.array([3 * 2**31 + rank, 2**40 + 123456789 * (rank + 1), 0, -7], np.int64)
        out["int64"] = pd._allgather_int64(vals).tolist()
    elif step in ("fail_oneshot", "fail_streamed"):
        fn = {"fail_oneshot": pd.count_pcap_distributed,
              "fail_streamed": pd.count_pcap_streamed_distributed}[step]
        try:
            fn(m, job["cap"] if rank == 0 else job["missing"])
        except RuntimeError as e:
            out[step] = [str(e), type(e.__cause__).__name__]
with open(job["out"] % rank, "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""

# A rank that dies right after joining; the survivors must fail, not hang.
DEATH_WORKER = r"""
import os, sys
from datetime import timedelta
import torch
torch.set_num_threads(1)
import torch.distributed as dist
dist.init_process_group("gloo", init_method="tcp://" + os.environ["MSM_COORDINATOR"],
                        world_size=int(os.environ["MSM_NUM_PROCESSES"]),
                        rank=int(os.environ["MSM_PROCESS_ID"]), timeout=timedelta(seconds=10))
if os.environ["MSM_PROCESS_ID"] == "1":
    os._exit(0)  # a crash right after joining (preemption, OOM kill)
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.parallel.distributed import count_pcap_distributed
m = Matcher(load_patterns(sys.argv[2]), device="cpu")
count_pcap_distributed(m, sys.argv[1], "udp", engine="window")
print("SURVIVOR FINISHED", flush=True)  # must never be reached
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = dict(os.environ)
    for k in ("MSM_COORDINATOR", "MSM_NUM_PROCESSES", "MSM_PROCESS_ID", "MSM_NO_NATIVE"):
        env.pop(k, None)
    env.update(PYTHONPATH=str(REPO), MSM_DEVICE="cpu", OMP_NUM_THREADS="1", **kw)
    return env


def _ranks(argv, n):
    """``[(exit code, stdout, stderr)]`` of ``n`` ranks of ``python argv``,
    joined on a fresh port; every wait has a timeout, and no rank outlives
    the call."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, *map(str, argv)], cwd=REPO, text=True,
                              env=_env(MSM_COORDINATOR=coord, MSM_NUM_PROCESSES=str(n),
                                       MSM_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, so, se) for p, (so, se) in zip(procs, outs)]


def _run_job(tmp, n, steps, files, **extra):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    job = {"steps": steps, "cap": str(files["cap"]), "patterns": str(STANDIN_FILE),
           "nocase": [p.decode() for p in NOCASE], "nocase_cap": str(files["nocase"]),
           "nul_patterns": str(files["nul"]), "stream_kw": STREAM_KW,
           "missing": str(tmp / "missing.pcap"), "out": str(tmp / "rank%d.json"), **extra}
    for rc, _, se in _ranks([script, json.dumps(job)], n):
        assert rc == 0, se[-3000:]
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_distributed")
    out = {"dir": d, "cap": d / "cap.pcap", "nocase": d / "case.pcap", "nul": d / "nul.txt",
           "empty": d / "empty.pcap"}
    synth_udp_pcap(out["cap"], PACKETS, payload_len=200, payload_len_jitter=150,
                   patterns=STANDIN + [b"a\x00b"], plant_rate=0.6, invalid_rate=0.05, seed=11)
    synth_udp_pcap(out["nocase"], 64, payload_len=96, payload_len_jitter=32,
                   patterns=[b"HTTP", b"Linux", b"notify", b"XmL"], plant_rate=0.5, seed=3)
    out["nul"].write_bytes(STANDIN_FILE.read_bytes() + b"\na\\x00b\n\\x00\n")
    assert load_patterns(out["nul"], syntax="escaped") == NUL_SET
    out["empty"].write_bytes(classic_global_header())
    return out


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    """Each rank's results of one 2-rank and one 4-rank group."""
    got = {}
    for n, steps in ((2, ["oneshot", "nocase", "stream", "nul", "int64"]), (4, ["oneshot"])):
        got[n] = _run_job(tmp_path_factory.mktemp(f"ranks{n}"), n, steps, files)
    return got


@pytest.fixture(scope="module")
def jax_ref(files):
    """The JAX package's single-process results on the same files."""
    m = JaxMatcher(STANDIN)
    ref = {e: jd.count_pcap_distributed(m, files["cap"], "udp", engine=e) for e in ENGINES}
    mc = JaxMatcher(NOCASE, case_insensitive=True)
    for e in ENGINES:
        ref["nocase_" + e] = jd.count_pcap_distributed(mc, files["nocase"], "udp", engine=e)
    for hw in (0, 2):
        st = {}
        ref[f"stream_{hw}"] = (jd.count_pcap_streamed_distributed(
            m, files["cap"], "udp", stats=st, host_workers=hw, **STREAM_KW), st)
    st = {}
    ref["nul"] = (jd.count_pcap_streamed_distributed(JaxMatcher(NUL_SET), files["cap"], "udp",
                                                     stats=st, **STREAM_KW), st)
    return ref


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("procs", [2, 4])
def test_ranks_equal_jax_and_oracle(runs, jax_ref, files, procs, engine):
    """Every rank holds the merged counts, equal to JAX's single-process
    count and the oracle; rank r counted packets [r * share, (r + 1) * share)."""
    want = oracle.oracle_pcap_counts(files["cap"], STANDIN, "udp")
    assert jax_ref[engine].counts.tolist() == want and sum(want) > 0
    share = -(-PACKETS // procs)
    for r, out in enumerate(runs[procs]):
        got = out[engine]
        assert got["counts"] == want, (r, engine)
        assert got["dtype"] == "int32"
        assert got["local_packets"] == min(PACKETS, (r + 1) * share) - min(PACKETS, r * share)
    assert runs[procs][0][engine]["local_packets"] == share
    assert len({out[engine]["elapsed_max_s"] for out in runs[procs]}) == 1  # the MAX, everywhere


@pytest.mark.parametrize("procs", [2, 4])
def test_rank_shares_cover_the_capture(runs, jax_ref, procs):
    """The ranks' packets and payload bytes add up to the whole capture's;
    each rank joined once, a second ``initialize_from_env`` keeps its group."""
    for engine in ENGINES:
        assert sum(o[engine]["local_packets"] for o in runs[procs]) == PACKETS
        assert (sum(o[engine]["local_payload_bytes"] for o in runs[procs])
                == jax_ref[engine].local_payload_bytes)
    for r, out in enumerate(runs[procs]):
        assert out["init"] == [True, True] and out["world"] == [procs, r]


@pytest.mark.parametrize("host_workers", [0, 2])
def test_streamed_ranks_equal_jax(runs, jax_ref, host_workers):
    """Round-robin chunks over 2 ranks, merged once: counts and whole-capture
    stats equal JAX's single-process streamed scan; each rank streamed its
    own chunks (chunk i to rank i mod 2)."""
    want, want_stats = jax_ref[f"stream_{host_workers}"]
    bp = STREAM_KW["batch_packets"]
    chunks = [min(bp, PACKETS - s) for s in range(0, PACKETS, bp)]
    for r, out in enumerate(runs[2]):
        got = out[f"stream_{host_workers}"]
        assert got["counts"] == want.counts.tolist() and sum(got["counts"]) > 0
        assert got["dtype"] == "int32"
        assert got["local_packets"] == sum(chunks[r::2])
        # JAX's CPU pallas degrades to window; the port reports the kernels.
        assert got["stats"] == {**want_stats, "engine_resolved": "pallas"}
    assert want.local_packets == PACKETS


def test_streamed_ranks_nul_set_equal_jax(runs, jax_ref):
    """A NUL-containing set counts chunk by chunk on each rank."""
    want, want_stats = jax_ref["nul"]
    for out in runs[2]:
        assert out["nul"]["counts"] == want.counts.tolist()
        assert out["nul"]["counts"][-2] > 0  # a\x00b was planted
        assert out["nul"]["stats"] == {**want_stats, "engine_resolved": "pallas"}


@pytest.mark.parametrize("engine", ENGINES)
def test_ranks_fold_case_insensitive(runs, jax_ref, files, engine):
    """Case-insensitive matchers fold each rank's payloads before staging."""
    want = jax_ref["nocase_" + engine].counts.tolist()
    local = Matcher(NOCASE, case_insensitive=True, device="cpu").count_pcap(files["nocase"])
    assert want == local.tolist() and sum(want) > 0
    for out in runs[2]:
        assert out["nocase_" + engine]["counts"] == want


def test_int64_merge_above_2_31(runs):
    """The count merge sums int64 exactly across ranks, past 2^31."""
    want = [2 * 3 * 2**31 + 1, 2 * 2**40 + 3 * 123456789, 0, -14]
    for out in runs[2]:
        assert out["int64"] == want


@pytest.mark.parametrize("kind", ["oneshot", "streamed"])
def test_ingest_failure_aborts_all_ranks(files, tmp_path, kind):
    """Rank 1's capture does not exist: both ranks raise JAX's error after
    the error-flag collective, neither waits in a later one."""
    for r, out in enumerate(_run_job(tmp_path, 2, ["fail_" + kind], files)):
        msg, cause = out["fail_" + kind]
        assert msg == "pcap ingest failed on at least one host; all hosts aborting"
        assert cause == ("NoneType" if r == 0 else "FileNotFoundError")


def test_rank_death_aborts_survivors(files, tmp_path):
    """Kill one rank after it joined: the survivors' first collective fails
    with gloo's error and they exit nonzero, well inside the timeout."""
    script = tmp_path / "death.py"
    script.write_text(DEATH_WORKER)
    outs = _ranks([script, files["cap"], STANDIN_FILE], 4)
    assert outs[1][0] == 0  # the victim exits quietly
    for r in (0, 2, 3):
        rc, so, se = outs[r]
        assert rc != 0, f"rank {r} finished despite its peer's death"
        assert "SURVIVOR FINISHED" not in so
        assert "RuntimeError" in se and any(
            s in se for s in ("Connection", "Timed out", "timed out", "gloo")), se[-2000:]


@pytest.mark.parametrize("engine", ENGINES)
def test_single_process_equals_jax(files, jax_ref, engine):
    """Without a group: the whole capture on the local mesh, also on a
    4-shard CPU mesh, equal to JAX's."""
    m = Matcher(STANDIN, device="cpu")
    want = jax_ref[engine]
    for mesh in (None, make_mesh(["cpu"] * 4)):
        got = pd.count_pcap_distributed(m, files["cap"], "udp", engine=engine, mesh=mesh)
        assert got.counts.tolist() == want.counts.tolist()
        assert got.counts.dtype == np.int32
        assert got.local_packets == want.local_packets == PACKETS
        assert got.local_payload_bytes == want.local_payload_bytes


@pytest.mark.parametrize("host_workers", [0, 2])
def test_streamed_single_process_equals_jax(files, jax_ref, host_workers):
    m = Matcher(STANDIN, device="cpu")
    want, want_stats = jax_ref[f"stream_{host_workers}"]
    st = {}
    got = pd.count_pcap_streamed_distributed(m, files["cap"], "udp", stats=st,
                                             host_workers=host_workers, **STREAM_KW)
    assert got.counts.tolist() == want.counts.tolist()
    assert (got.local_packets, got.local_payload_bytes) == (want.local_packets,
                                                            want.local_payload_bytes)
    assert st == {**want_stats, "engine_resolved": "pallas"}
    st = {}
    nul = pd.count_pcap_streamed_distributed(Matcher(NUL_SET, device="cpu"), files["cap"],
                                             stats=st, **STREAM_KW)
    assert nul.counts.tolist() == jax_ref["nul"][0].counts.tolist()
    assert st == {**jax_ref["nul"][1], "engine_resolved": "pallas"}


@pytest.mark.parametrize("fn", ["count_pcap_distributed", "count_pcap_streamed_distributed"])
def test_single_process_missing_file(files, fn):
    """One process re-raises the ingest error itself, as JAX does."""
    missing = files["dir"] / "missing.pcap"
    with pytest.raises(FileNotFoundError) as want:
        getattr(jd, fn)(JaxMatcher([b"x"]), missing, "udp")
    with pytest.raises(FileNotFoundError) as got:
        getattr(pd, fn)(Matcher([b"x"], device="cpu"), missing, "udp")
    assert got.value.filename == want.value.filename == str(missing)


@pytest.mark.parametrize("engine", ENGINES)
def test_empty_capture(files, engine):
    """A header-only capture: zero counts, no packets, as in JAX."""
    got = pd.count_pcap_distributed(Matcher([b"http", b"xml"], device="cpu"), files["empty"],
                                    engine=engine)
    want = jd.count_pcap_distributed(JaxMatcher([b"http", b"xml"]), files["empty"], engine=engine)
    assert got.counts.tolist() == want.counts.tolist() == [0, 0]
    assert got.local_packets == want.local_packets == 0
    st = {}
    s = pd.count_pcap_streamed_distributed(Matcher([b"ab"], device="cpu"), files["empty"], stats=st)
    assert s.counts.tolist() == [0] and st["packets"] == 0


def test_unknown_engine_raises_jax_error(files):
    with pytest.raises(ValueError) as want:
        jd.count_pcap_distributed(JaxMatcher([b"http"]), files["cap"], engine="kmp")
    with pytest.raises(ValueError) as got:
        pd.count_pcap_distributed(Matcher([b"http"], device="cpu"), files["cap"], engine="kmp")
    assert str(got.value) == str(want.value) and "engine" in str(got.value)


def test_allgather_int64_single_process():
    vals = np.array([0, 1, 2**31 + 7, 2**40 + 123456789], dtype=np.int64)
    assert pd._allgather_int64(vals).tolist() == jd._allgather_int64(vals).tolist()
    assert pd._allgather_int64(vals).tolist() == vals.tolist()


def test_initialize_without_coordinator(monkeypatch):
    monkeypatch.delenv("MSM_COORDINATOR", raising=False)
    assert pd.initialize_from_env() is False
    assert not torch.distributed.is_initialized()


def _text(main, argv, capsys):
    rc = main([str(a) for a in argv])
    out = capsys.readouterr().out
    return rc, [ln for ln in out.splitlines() if not ln.startswith("Elapsed time = ")]


@pytest.mark.parametrize("argv", [
    ["mesh", "{cap}", "{pats}", "udp"], ["mpi", "{cap}", "{pats}"], ["mesh", "{cap}", "{pats}", "tcp"],
    ["match", "--pcap", "{cap}", "--patterns", "{pats}", "--stream", "--distributed"],
    ["match", "--pcap", "{cap}", "--pcap", "{cap}", "--patterns", "{pats}", "--stream",
     "--distributed", "--host-workers", "2"],
    ["mesh"],
], ids=["mesh", "mpi", "mesh-tcp", "match-distributed", "match-distributed-two-files", "usage"])
def test_cli_single_process_equals_jax(files, capsys, monkeypatch, argv):
    """One process: the reports the JAX CLI prints (elapsed-time lines aside)."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.delenv("MSM_COORDINATOR", raising=False)
    argv = [a.format(cap=files["cap"], pats=STANDIN_FILE) for a in argv]
    got, want = _text(pt_main, argv, capsys), _text(jax_main, argv, capsys)
    assert got == want
    assert got[0] == (1 if argv == ["mesh"] else 0) and len(got[1]) >= 1
    assert not torch.distributed.is_initialized()


def test_cli_match_distributed_json_equals_jax(files, capsys, monkeypatch):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.delenv("MSM_COORDINATOR", raising=False)
    argv = ["match", "--pcap", str(files["cap"]), "--patterns", str(STANDIN_FILE), "--stream",
            "--distributed", "--json"]
    blobs = []
    for main in (pt_main, jax_main):
        assert main(argv) == 0
        blobs.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    got, want = blobs
    assert set(got) == set(want) == {"patterns", "counts", "packets", "valid_payloads",
                                     "payload_bytes", "phases", "execution"}
    for key in ("patterns", "counts", "packets", "valid_payloads", "payload_bytes"):
        assert got[key] == want[key], key
    # The port's blob names its device; JAX's CPU pallas degrades to window.
    assert set(got["execution"]) - {"device", "pallas_kernel"} == (
        set(want["execution"]) - {"pallas_kernel", "streamed_remap"})


@pytest.mark.parametrize("command", ["mesh", "match-json"])
def test_cli_two_ranks(files, capsys, monkeypatch, command):
    """Two rank processes of the CLI: rank 0 prints what one process prints,
    rank 1 prints nothing; both exit 0 without a traceback, whichever
    finishes first (rank 0 serves the group's rendezvous)."""
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    monkeypatch.delenv("MSM_COORDINATOR", raising=False)
    if command == "mesh":
        argv = ["mesh", files["cap"], STANDIN_FILE, "udp"]
        _, want = _text(pt_main, ["serial", *argv[1:]], capsys)
    else:
        base = ["match", "--pcap", str(files["cap"]), "--patterns", str(STANDIN_FILE),
                "--stream", "--json"]
        assert pt_main(base) == 0
        want = json.loads(capsys.readouterr().out.splitlines()[-1])
        argv = base + ["--distributed"]
    outs = _ranks(["-m", "multithreading_string_matching_tpu_torch", *argv], 2)
    for rc, _, se in outs:
        assert rc == 0 and "Traceback" not in se, se[-3000:]
    assert outs[1][1] == ""
    if command == "mesh":
        got = [ln for ln in outs[0][1].splitlines() if not ln.startswith("Elapsed time = ")]
        assert got == want and len(got) > 10
    else:
        got = json.loads(outs[0][1].splitlines()[-1])
        for key in ("patterns", "counts", "packets", "valid_payloads", "payload_bytes"):
            assert got[key] == want[key], key
        assert sum(got["counts"]) > 0
