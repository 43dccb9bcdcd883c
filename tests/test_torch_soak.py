"""The verification tools of the torch package: ``tools/differential.py``
(every hand-written kernel against its plain version and the oracle, on
random cases; ``--targets``; ``--edges``, the cases at the 2^31 position
limit of ``tools/edges.py``), ``tools/fuzz_soak.py`` (every engine against
the oracle, the flow cases included), ``tools/asan_audit.py`` (the C++
ingest under ASan and UBSan through the port's bindings) and
``tools/sanitize.py`` (compute-sanitizer over the kernels).

On the CPU the tools run the plain versions, which tests the harness: a
few cases at fixed seeds come out clean, the same seed gives the same
cases, the tools' copy of the oracle equals ``tests/oracle.py``, the edge
cases at a limit of 2^16 equal their construction, a planted divergence is
reported, the ASan audit is clean and its self-test dies with ASan's
report, the sanitizer's parser reads its summaries, the tools import no
jax, and without a card they refuse ``cuda``.  The ``gpu`` tests soak the
kernels and run the edge cases on the card; this file imports no jax, so
it runs there with::

    python -m pytest --noconftest tests/test_torch_soak.py -q -m gpu
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle as tests_oracle
from multithreading_string_matching_tpu_torch.tools import differential, edges, fuzz_soak, sanitize
from multithreading_string_matching_tpu_torch.tools import oracle as tool_oracle

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOLS = ("differential", "fuzz_soak", "sanitize")


@pytest.mark.parametrize("target", differential.TARGETS)
def test_differential_cases_clean_on_cpu(target, tmp_path):
    """Three cases of each entry point (the first checked by the oracle)
    agree with the plain versions and the oracle, and write nothing."""
    i = differential.TARGETS.index(target)
    oracle_cases = 0
    for k in range(3):
        case = differential.run_case(7, i + k * len(differential.TARGETS), "cpu", tmp_path)
        assert case.target == target
        oracle_cases += case.notes["oracle"]
    assert oracle_cases == 1
    assert not any(tmp_path.iterdir())


def test_differential_soak_summary(tmp_path):
    stats = differential.soak(11, cases=1, device="cpu", out=tmp_path, log=lambda *a: None)
    assert [stats[t]["cases"] for t in differential.TARGETS] == [1] * 12
    assert all(stats[t]["oracle"] == 1 for t in differential.TARGETS)
    lines = differential.summary_lines(stats, 11, "cpu", "cpu")
    assert len(lines) == 13 and lines[-1].startswith("differential clean: 12 cases")


def test_differential_same_seed_same_cases():
    a = [differential.make_case(5, i, "cpu").digest() for i in range(24)]
    b = [differential.make_case(5, i, "cpu").digest() for i in range(24)]
    c = [differential.make_case(6, i, "cpu").digest() for i in range(24)]
    assert a == b
    assert len(set(a)) == 24 and not set(a) & set(c)


def test_differential_reports_a_divergence(tmp_path, monkeypatch, capsys):
    """A plain version that counts one match too many is a divergence: the
    run raises, prints the reproducer and writes the case's inputs."""
    from multithreading_string_matching_tpu_torch.ops import cuda_window

    real = cuda_window.window_count_totals
    monkeypatch.setattr(cuda_window, "window_count_totals",
                        lambda *a, **k: real(*a, **k) + 1)
    with pytest.raises(differential.Divergence, match="kernel vs plain"):
        differential.run_case(3, 0, "cpu", tmp_path)
    out = capsys.readouterr().out
    assert "DIVERGENCE in window_count_totals" in out and "--seed 3 --case 0" in out
    saved = np.load(tmp_path / "window_count_totals-3-0.npz")
    case = differential.make_case(3, 0, "cpu")
    assert np.array_equal(saved["payload"], case.arrays["payload"])
    blob, lens = saved["patterns_blob"].tobytes(), saved["patterns_len"]
    assert [blob[s - n : s] for s, n in zip(np.cumsum(lens), lens)] == case.patterns


def test_fuzz_soak_clean_on_cpu():
    cases, totals = fuzz_soak.soak(5.0, 2, "cpu", max_cases=6, log=lambda *a: None)
    assert cases == 6
    assert totals["engines"] >= 6 * len(fuzz_soak.ENGINES)


def test_fuzz_soak_runs_flow_cases():
    cases, totals = fuzz_soak.soak(5.0, 0, "cpu", max_cases=8, log=lambda *a: None)
    assert cases == 8 and totals["flows"] > 0


def test_flow_case_reports_a_divergence(monkeypatch):
    """A stream that counts one match too many is a divergence of the flow
    case (seed 4 draws the AC flow engine on a reordered v6 capture)."""
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher

    crng = np.random.default_rng(4)
    pats, payloads, lengths = fuzz_soak.random_case(crng)
    texts = [payloads[i, : lengths[i]].tobytes() for i in range(len(lengths))]
    assert fuzz_soak.flow_case(pats, texts, np.random.default_rng(1004), "cpu") is None
    real = FlowStreamMatcher.counts
    monkeypatch.setattr(FlowStreamMatcher, "counts", lambda self: real(self) + 1)
    bad = fuzz_soak.flow_case(pats, texts, np.random.default_rng(1004), "cpu")
    assert bad is not None and bad.startswith("flow stream (")


def test_fuzz_soak_same_seed_same_cases():
    def draw(seed):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(8):
            _, pats, payloads, lengths, nocase = fuzz_soak.case_inputs(int(rng.integers(0, 2**63)))
            out.append((pats, payloads.tobytes(), lengths.tobytes(), nocase))
        return out

    assert draw(4) == draw(4)
    assert draw(4) != draw(5)


def test_fuzz_soak_table_route_and_streamed_capture(tmp_path):
    """The fillers take the set past 512 words; the three containers hold
    the frames the streamed pipeline reads back."""
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap

    rng = np.random.default_rng(0)
    pats = [b"ab", b"a\x00b", b"abcabcabc"]
    big = Matcher(pats + fuzz_soak.table_fillers(rng, pats), device="cpu")
    assert big.explain()["pallas_kernel"] == "table+filter"
    frames = fuzz_soak.udp_frames([b"", b"ab", b"x" * 300])
    for fmt in range(3):
        pcap = read_pcap(fuzz_soak.write_capture(tmp_path / f"c{fmt}", frames, fmt))
        assert [pcap.packet(i).tobytes() for i in range(pcap.num_packets)] == frames


def test_guard_bands():
    """On the card every input is a view between two poisoned bands: the
    view equals the input, keeps 16-byte alignment, and the bands hold the
    case's pattern bytes (payloads), huge lengths or wildcard table rows."""
    a = np.arange(24, dtype=np.uint8).reshape(4, 6)
    t = differential.guarded(a, np.full(512, 7, np.uint8), "cpu")
    assert t.is_contiguous() and torch.equal(t, torch.from_numpy(a))
    assert (t.data_ptr() - t.untyped_storage().data_ptr()) % 16 == 0
    whole = torch.frombuffer(bytearray(bytes(t.untyped_storage())), dtype=torch.uint8)
    assert whole[:512].eq(7).all() and whole[-512:].eq(7).all()
    case = differential.make_case(3, 0, "cpu")
    band = case.poison("payload", 600, np.uint8)
    assert band.tobytes()[:40] == b"".join(case.patterns)[:40] and band.size == 600
    assert case.poison("lengths2", 4, np.int32).tolist() == [2**30] * 4
    assert case.poison("masks", 2, np.int32).tolist() == [0, 0]
    assert case.poison("lens", 2, np.int32).tolist() == [1, 1]
    assert differential.GUARD_BYTES % 16 == 0


def test_differential_targets_subset(tmp_path):
    """``--targets`` soaks the named entry points only, each on its own case
    indices: the same inputs as in a soak of all 12."""
    stats = differential.soak(11, cases=2, device="cpu", out=tmp_path, log=lambda *a: None,
                              targets=differential.parse_targets("kmp_scan,window_find"))
    assert list(stats) == ["window_find", "kmp_scan"]
    assert [stats[t]["cases"] for t in stats] == [2, 2]
    with pytest.raises(ValueError, match="unknown entry points"):
        differential.parse_targets("kmp_scan,nope")
    assert differential.parse_targets(None) == differential.TARGETS
    lines = differential.summary_lines(stats, 11, "cpu", "cpu")
    assert len(lines) == 3 and lines[-1].startswith("differential clean: 4 cases")


@pytest.fixture
def small_limit(monkeypatch):
    """The slicing and drain limits of the port lowered to the edge cases'
    CPU limit of 2^16 (the wrappers' own int32 bound stays: the CPU runs
    the plain versions)."""
    from multithreading_string_matching_tpu_torch.parallel import mesh, pipeline

    monkeypatch.setattr(mesh, "SUMMARY_MAX_POSITIONS", 2**16)
    monkeypatch.setattr(pipeline, "DRAIN_POSITIONS", 2**14)
    return 2**16


def test_edges_on_cpu(small_limit):
    """Every edge case at a limit of 2^16 equals its construction on the
    plain versions: the sliced paths in two slices, the split scans in two
    runs, the packed count past the limit in int64 through its drains."""
    lines = []
    records = edges.run_edges("cpu", small_limit, log=lines.append)
    cases = [r for r in records if "result" in r]
    assert len(cases) == len(lines) == 33
    assert {r["result"] for r in cases} == {"exact", "exact (int64)", "exact (int64 totals)",
                                          "refusal checked on the card only"}
    names = " ".join(r["case"] for r in cases)
    for t in ("window_count_totals", "window_count_rows", "window_count_halo", "window_find",
              "table_count_totals", "filter_count_rows", "ShardTableKernel.counts",
              "ShardTableKernel.rows", "mxu_count", "ac_scan", "kmp_scan"):
        assert t in names
    assert "(2 row slices, 0 rerun(s))" in names and "(2 slices)" in names and "(2 split_tiles runs)" in names
    packed = cases[-1]
    assert packed["case"].startswith("PackedTileCounter: 65792 matches") and "5 drains" in packed["case"]


def test_edges_construction():
    """The plants agree where they overlap, every view holds hits, and the
    views sit where the limit puts them."""
    g = edges.geometry(2**31)
    assert (g.L, g.n_max, g.n_buf, g.n_rep, g.half) == (2048, 2**20 - 1, 2**20 + 1,
                                                        2**19 - 1, 2**19)
    assert g.n_max * g.L == 2**31 - 2048 and 2 * g.n_rep * g.L == 2**31 - 4096
    g = edges.geometry(2**16)
    rows = edges.row_bytes(g)
    assert all(edges.FILLER not in p for p in edges.PATTERNS)
    for view in (g.n_rep, g.n_max, g.n_buf):
        assert rows[view - 1].endswith(edges.LONG)
        assert sum(edges.expected_totals(g, view, list(edges.PATTERNS))) > 0
    assert rows[g.n_max].startswith(b"Q") and rows[g.half].startswith(b"Q")
    assert edges.expected_rows(g, g.n_buf, [b"XY"])[1] == [0]  # cut by its length
    # row 0's "EDGE" ends inside the halo; row 1's counts, and so does
    # row 0's "EDGE-CASE!"
    assert edges.expected_halo(g, g.n_max, [b"EDGE", b"EDGE-CASE!"]) == [1, 1]
    assert edges.expected_halo(g, 1, [b"EDGE"]) == [0]
    with pytest.raises(ValueError, match="does not divide"):
        edges.geometry(2**16 + 64)


def test_differential_edges_command():
    r = subprocess.run([sys.executable, "-m",
                        "multithreading_string_matching_tpu_torch.tools.differential",
                        "--device", "cpu", "--edges", "--edge-limit", str(2**16)],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "edges clean: 33 cases" in r.stdout


def test_asan_audit_clean(tmp_path):
    """The port's ingest bindings and the live walk under ASan and UBSan at
    a test size: the structured captures, 200 garbage blobs, 50 geometry
    rounds, 50 rounds of the walk."""
    r = subprocess.run([sys.executable, "-m",
                        "multithreading_string_matching_tpu_torch.tools.asan_audit",
                        "--garbage-cases", "200", "--geometry-cases", "50"],
                       cwd=REPO, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ASAN AUDIT CLEAN" in r.stdout
    assert "structured captures clean under ASan: 50 captures" in r.stdout
    assert "live walk fuzz clean under ASan: 50 cases" in r.stdout
    # Both ingest paths walked: a path to a classic capture maps it, a file
    # object reads it.
    counts = re.search(r"iter_pcap batches mapped (\d+), read (\d+)", r.stdout)
    assert counts and int(counts[1]) > 0 and int(counts[2]) > 0, r.stdout


def test_asan_audit_self_test_dies_with_the_report():
    r = subprocess.run([sys.executable, "-m",
                        "multithreading_string_matching_tpu_torch.tools.asan_audit", "--self-test"],
                       cwd=REPO, capture_output=True, text=True, timeout=180)
    assert r.returncode != 0
    assert "ERROR: AddressSanitizer: heap-buffer-overflow" in r.stderr
    assert "msm_fill_padded" in r.stderr
    assert "NOT reported" not in r.stdout


SANITIZER_OUTPUTS = {
    "clean": ("differential clean: 96 cases, 0 divergences, seed=0, device=cuda [card]\n"
              "========= ERROR SUMMARY: 0 errors\n", 0, "memcheck"),
    "errors": ("========= Invalid __global__ read of size 16 bytes\n"
               "=========     at probe_count_kernel<false, false, false>(msm_probe::Args)\n"
               "========= ERROR SUMMARY: 3 errors\n", 1, "memcheck"),
    "race_clean": ("differential clean: 12 cases, 0 divergences\n"
                   "========= RACECHECK SUMMARY: 0 hazards displayed (0 errors, 0 warnings)\n",
                   0, "racecheck"),
    "race_warnings": ("differential clean: 12 cases, 0 divergences\n"
                      "========= RACECHECK SUMMARY: 2 hazards displayed (0 errors, 2 warnings)\n",
                      0, "racecheck"),
    "unsupported": ("========= COMPUTE-SANITIZER\n========= Error: Device not supported. Please "
                    "refer to the \"Supported Devices\" section of the sanitizer documentation\n",
                    1, "synccheck"),
    "no_summary": ("Traceback (most recent call last):\nRuntimeError: boom\n", 1, "initcheck"),
    "timeout": ("differential window_count_totals cases 1\n", None, "memcheck"),
    "unclean_child": ("========= ERROR SUMMARY: 0 errors\n", 1, "memcheck"),
}


@pytest.mark.parametrize("name", sorted(SANITIZER_OUTPUTS))
def test_sanitize_parser(name):
    text, rc, tool = SANITIZER_OUTPUTS[name]
    rec = sanitize.parse_output(text, rc, tool)
    want = {"clean": "clean", "errors": "errors", "race_clean": "clean",
            "race_warnings": "errors", "unsupported": "not available: Device not supported",
            "no_summary": "failed: no initcheck summary", "timeout": "failed: timed out",
            "unclean_child": "failed: exit code 1"}[name]
    assert rec["status"].startswith(want)
    if name == "clean":
        assert (rec["errors"], rec["cases"]) == (0, 96)
    if name == "errors":
        assert rec["errors"] == 3
    if name == "race_warnings":
        assert (rec["hazards"], rec["errors"], rec["warnings"]) == (2, 0, 2)
    assert sanitize.verdict([{**rec, "status": rec["status"]}]) == (
        0 if want == "clean" else 2 if want.startswith("not available") else 1)


def test_sanitize_child_command():
    """The child: the tool in front of the differential, with the kernel
    filter naming the port's six kernels and PyTorch's caching allocator
    off."""
    prog = sanitize.differential_command(8, 3, "out", "kmp_scan,ac_scan")
    cmd = sanitize.sanitizer_command("cuda/bin/compute-sanitizer", "racecheck", prog)
    assert cmd[:5] == ["cuda/bin/compute-sanitizer", "--tool", "racecheck",
                       "--error-exitcode", "1"]
    filters = [cmd[i + 1] for i, c in enumerate(cmd) if c == "--kernel-name"]
    assert filters == [f"kns={k}" for k in sanitize.KERNELS]
    assert set(sanitize.KERNELS) == {"probe_count_kernel", "window_find_kernel",
                                     "mxu_wgmma_kernel", "ac_scan_kernel", "kmp_group_kernel",
                                     "kmp_wide_kernel"}
    assert cmd[-len(prog):] == prog
    assert prog[1:3] == ["-m", "multithreading_string_matching_tpu_torch.tools.differential"]
    assert prog[3:] == ["--cases", "8", "--seed", "3", "--out", "out",
                        "--targets", "kmp_scan,ac_scan"]
    assert sanitize.child_env()["PYTORCH_NO_CUDA_MEMORY_CACHING"] == "1"
    assert set(sanitize.BLIND_SPOTS) == set(sanitize.TOOLS)
    for k in sanitize.KERNELS:
        src = (REPO / "multithreading_string_matching_tpu_torch" / "csrc")
        assert any(f"{k}(" in f.read_text() for f in src.iterdir())


def test_sanitize_not_available(monkeypatch):
    monkeypatch.setattr(sanitize.shutil, "which", lambda name: None)
    monkeypatch.setattr(sanitize.pathlib.Path, "exists", lambda self: False)
    assert sanitize.find_sanitizer() is None
    assert sanitize.probe(None) == "compute-sanitizer not found"
    assert sanitize.verdict([{"status": "not available: compute-sanitizer not found"},
                             {"status": "clean"}]) == 2
    assert sanitize.verdict([{"status": "not available: x"}, {"status": "not reported"}]) == 1


@pytest.mark.parametrize("seed", range(4))
def test_oracle_copy_equals_tests_oracle(seed):
    rng = np.random.default_rng(seed)
    alpha = int(rng.choice([2, 3, 256]))
    texts = [rng.integers(0, alpha, size=int(rng.integers(0, 200))).astype(np.uint8).tobytes()
             for _ in range(20)]
    pats = [rng.integers(0, alpha, size=int(rng.integers(1, 6))).astype(np.uint8).tobytes()
            for _ in range(12)] + [texts[0][:3] or b"\x00", texts[1]]
    assert tool_oracle.oracle_counts(texts, pats) == tests_oracle.oracle_counts(texts, pats)
    assert tool_oracle.oracle_matrix(texts, pats) == [tests_oracle.oracle_counts([t], pats)
                                                     for t in texts]
    for t in texts[:5]:
        for p in pats:
            assert tool_oracle.count_overlapping(t, p) == tests_oracle.count_overlapping(t, p)
    rows = tool_oracle.match_positions(texts, pats)
    assert len(rows) == sum(tests_oracle.oracle_counts(texts, pats))
    assert all(texts[n][i : i + len(pats[u])] == pats[u] for n, i, u in rows)
    assert rows == sorted(rows)


def test_tools_and_demos_import_no_jax():
    code = (
        "import sys\n"
        "import multithreading_string_matching_tpu_torch.tools.differential\n"
        "import multithreading_string_matching_tpu_torch.tools.fuzz_soak\n"
        "import multithreading_string_matching_tpu_torch.tools.edges\n"
        "import multithreading_string_matching_tpu_torch.tools.asan_audit\n"
        "import multithreading_string_matching_tpu_torch.tools.sanitize\n"
        "import multithreading_string_matching_tpu_torch.examples.ids_demo\n"
        "import multithreading_string_matching_tpu_torch.examples.flow_ids_demo\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'oracle'\n"
        "       or m.split('.')[0] == 'multithreading_string_matching_tpu']\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_refuse_cuda_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts without one")
    r = subprocess.run([sys.executable, "-m", f"multithreading_string_matching_tpu_torch.tools.{tool}"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and not r.stdout
    assert "CUDA is not available" in r.stderr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_edges_on_the_card(cuda_device):
    """Every entry point at its largest accepted launch and refused past
    it, the slicing paths past 2^31 positions, a count past 2^31."""
    records = edges.run_edges(cuda_device, log=print)
    cases = [r for r in records if "result" in r]
    assert len(cases) == 33
    assert all(r["result"] in ("exact", "refused", "exact (int64)", "exact (int64 totals)")
               for r in cases)
    assert records[-1]["bytes"] < 10 * 2**30


@pytest.mark.gpu
def test_differential_on_the_card(cuda_device, tmp_path):
    """Every kernel entry point on the card: its minimum of cases (the
    coverage checks included) with 0 divergences."""
    stats = differential.soak(1, cases=differential.COVERAGE_CASES, device=cuda_device,
                              out=tmp_path, log=print)
    assert all(stats[t]["cases"] >= differential.COVERAGE_CASES for t in differential.TARGETS)
