"""The soak tools of the torch package: ``tools/differential.py`` (every
hand-written kernel against its plain version and the oracle, on random
cases) and ``tools/fuzz_soak.py`` (every engine against the oracle).

On the CPU the tools run the plain versions, which tests the harness: a
few cases at fixed seeds come out clean, the same seed gives the same
cases, the tools' copy of the oracle equals ``tests/oracle.py``, the tools
import no jax, and without a card they refuse ``cuda``.  The ``gpu`` test
soaks the kernels on the card; this file imports no jax, so it runs there
with::

    python -m pytest --noconftest tests/test_torch_soak.py -q -m gpu
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle as tests_oracle
from multithreading_string_matching_tpu_torch.tools import differential, fuzz_soak
from multithreading_string_matching_tpu_torch.tools import oracle as tool_oracle

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOLS = ("differential", "fuzz_soak")


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
def test_differential_on_the_card(cuda_device, tmp_path):
    """Every kernel entry point on the card: its minimum of cases (the
    coverage checks included) with 0 divergences."""
    stats = differential.soak(1, cases=differential.COVERAGE_CASES, device=cuda_device,
                              out=tmp_path, log=print)
    assert all(stats[t]["cases"] >= differential.COVERAGE_CASES for t in differential.TARGETS)
