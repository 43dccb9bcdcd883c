"""The large-rule-set path as a whole: the torch ``Matcher(device="cpu")``
routes pattern sets to the window or the table kernels exactly where the
JAX ``Matcher`` routes them, counts a capture with a 600-pattern set as the
JAX package does, swaps pattern sets under the JAX package's contract, and
the command line reaches the table kernels with a large pattern file.

Counts are integers: every comparison is exact (tolerance 0).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.api import Matcher as JaxMatcher
from multithreading_string_matching_tpu.cli import main as jax_main
from multithreading_string_matching_tpu.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu.ops.pallas_table import PallasTableMatcher
from multithreading_string_matching_tpu.ops.window import WindowProgram as JaxProgram
from multithreading_string_matching_tpu.ops.window import count_matches_window as jax_count
from multithreading_string_matching_tpu_torch import cli
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.ops.cuda_table import CudaTableMatcher
from multithreading_string_matching_tpu_torch.ops.cuda_window import CudaWindowMatcher
from multithreading_string_matching_tpu_torch.ops.window import WindowProgram

torch.set_num_threads(1)

STANDIN = (
    pathlib.Path(__file__).resolve().parent.parent
    / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"
)
_rng = np.random.default_rng(28)
RANDOM600 = [bytes(_rng.integers(1, 255, size=8).tolist()) for _ in range(600)]
# 600 distinct tokens of 3-12 letters over a small alphabet, so that a
# capture is rich in matches and shared prefixes: 800+ pattern words.
_letters = np.frombuffer(b"abcdef", np.uint8)
LARGE = list(dict.fromkeys(
    bytes(_letters[_rng.integers(0, 6, size=_rng.integers(3, 13))]) for _ in range(700)
))[:600]

ROUTES = {
    # name: (patterns, environment)
    "random600": (RANDOM600, {}),
    "random600-no-filter": (RANDOM600, {"MSM_PALLAS_FILTER": "0"}),
    "random600-table-off": (RANDOM600, {"MSM_PALLAS_TABLE": "0"}),
    "random600-table-empty": (RANDOM600, {"MSM_PALLAS_TABLE": ""}),
    "large-mixed": (LARGE, {}),
    "uniform130": ([b"%08d" % i for i in range(65)], {}),
    "uniform128": ([b"%08d" % i for i in range(64)], {}),
    "uniform200": ([b"%08d" % i for i in range(100)], {}),
    "mixed202": ([b"%08d" % i for i in range(50)] + [b"%012d" % i for i in range(34)], {}),
    "standin": (load_patterns(STANDIN), {}),
    "standin-table-forced": (load_patterns(STANDIN), {"MSM_PALLAS_TABLE": "1"}),
    "standin-table-forced-no-filter": (load_patterns(STANDIN), {"MSM_PALLAS_TABLE": "1",
                                                                "MSM_PALLAS_FILTER": "0"}),
}
KERNEL_NAMES = {"cuda-window": "unrolled", "table+filter": "table+filter", "table": "table"}


@pytest.fixture
def jax_pallas_route(monkeypatch):
    """The JAX Matcher reports its Pallas kernel on the CPU only when forced
    to interpret mode (it degrades to the XLA window engine otherwise)."""
    monkeypatch.setenv("MSM_PALLAS_INTERPRET", "1")
    for var in ("MSM_PALLAS_TABLE", "MSM_PALLAS_FILTER"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routing_and_explain_equal_jax(jax_pallas_route, route):
    pats, env = ROUTES[route]
    for k, v in env.items():
        jax_pallas_route.setenv(k, v)
    m, jm = Matcher(pats, device="cpu"), JaxMatcher(pats)
    ex, jx = m.explain(), jm.explain()
    assert ex["engine_resolved"] == jx["engine_resolved"] == "pallas"
    assert KERNEL_NAMES[ex["pallas_kernel"]] == jx["pallas_kernel"]
    for key in ("patterns", "unique_patterns", "total_pattern_words", "max_pattern_len",
                "nul_patterns"):
        assert ex[key] == jx[key], key
    table = isinstance(m.kernels, CudaTableMatcher)
    assert table == isinstance(jm.pallas, PallasTableMatcher)
    assert table != isinstance(m.kernels, CudaWindowMatcher)
    if table:
        assert m.kernels.filtered == jm.pallas.filtered
        assert m.kernels.use_fit == jm.pallas.use_fit
        assert ex["pallas_kernel"] == ("table+filter" if m.kernels.filtered else "table")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_table") / "synth.pcap"
    synth_udp_pcap(path, 160, payload_len=96, payload_len_jitter=80, patterns=LARGE,
                   plant_rate=0.9, invalid_rate=0.05, seed=7)
    return path


@pytest.fixture(scope="module")
def jax_counts(capture):
    jm = JaxMatcher(LARGE)
    batch = _batch(capture)
    return {
        "pcap": np.asarray(jm.count_pcap(capture, "udp")),
        "rows": np.asarray(jm.count(batch.payloads, batch.lengths, per_packet=True)),
    }


def _batch(capture):
    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap

    return extract_payloads(read_pcap(capture), "udp", pad_n_to=128, pad_len_to=8)


@pytest.mark.parametrize("filter_env", ["1", "0"])
def test_large_set_counts_equal_jax(capture, jax_counts, monkeypatch, filter_env):
    monkeypatch.delenv("MSM_PALLAS_TABLE", raising=False)
    monkeypatch.setenv("MSM_PALLAS_FILTER", filter_env)
    m = Matcher(LARGE, device="cpu")
    assert m.explain()["pallas_kernel"] == ("table+filter" if filter_env == "1" else "table")
    got = m.count_pcap(capture, "udp")
    assert got.dtype == np.int32 and got.shape == (len(LARGE),)
    assert got.sum() > 100
    assert np.array_equal(got, jax_counts["pcap"])
    batch = _batch(capture)
    rows = m.count(batch.payloads, batch.lengths, per_packet=True)
    assert np.array_equal(rows, jax_counts["rows"])
    for staging in ("packed", "bucketed"):
        assert np.array_equal(m.count(batch.payloads, batch.lengths, staging=staging),
                              jax_counts["pcap"])
    assert isinstance(m.kernels, CudaTableMatcher)


def _jax_window(pats, payloads, lengths):
    return np.asarray(jax_count(JaxProgram.build(pats), payloads, lengths)).tolist()


@pytest.mark.parametrize("filtered", [False, True])
def test_swap_tables_same_geometry(filtered):
    """tests/test_swap.py::test_swap_same_geometry_reuses_executables on the
    port: the same set sizes swap in place and count the new set."""
    rng = np.random.default_rng(60)
    pats_a = [b"ab", b"abc", b"abcdefgh", b"ca"]
    pats_b = [b"ba", b"cab", b"bacbacba", b"ac"]
    m = CudaTableMatcher(WindowProgram.build(pats_a), "cpu", filtered=filtered)
    payloads = rng.integers(97, 100, size=(16, 128)).astype(np.uint8)
    lengths = rng.integers(0, 129, size=16).astype(np.int32)
    tiles = [(payloads, lengths)]
    assert m.count_tiles(tiles).tolist() == _jax_window(pats_a, payloads, lengths)
    tables = m._tables
    m.swap_tables(WindowProgram.build(pats_b))
    PallasTableMatcher(JaxProgram.build(pats_a), interpret=True, pattern_block=4,
                       filtered=filtered).swap_tables(JaxProgram.build(pats_b))
    assert m._tables is not tables
    assert m.count_tiles(tiles).tolist() == _jax_window(pats_b, payloads, lengths)
    tot, hits = m.count_tile_summary(payloads, lengths)
    (rows,) = m.count_tiles_per_row(tiles, expand_duplicates=False)
    assert np.array_equal(tot.numpy(), rows.numpy().sum(axis=0))
    assert np.array_equal(hits.numpy(), rows.numpy().sum(axis=1) > 0)


@pytest.mark.parametrize("new, match", [
    ([b"ab", b"abcdefgh"], "geometry"),
    ([b"ab"], "geometry"),
    ([b"ab", b"abc", b"abcd"], "geometry"),
])
def test_swap_tables_rejects_other_geometry(new, match):
    m = CudaTableMatcher(WindowProgram.build([b"ab", b"abcd"]), "cpu")
    jm = PallasTableMatcher(JaxProgram.build([b"ab", b"abcd"]), interpret=True, pattern_block=4)
    for matcher, program in ((m, WindowProgram), (jm, JaxProgram)):
        with pytest.raises(ValueError, match=match):
            matcher.swap_tables(program.build(new))


def test_swap_tables_rejects_fit_mode_change():
    m = CudaTableMatcher(WindowProgram.build([b"ab", b"cdef"]), "cpu", assume_zero_padded=True)
    assert not m.use_fit
    with pytest.raises(ValueError, match="fit"):
        m.swap_tables(WindowProgram.build([b"a\x00", b"cdef"]))


def test_matcher_swap_patterns_equals_jax(monkeypatch):
    """tests/test_swap.py::test_matcher_swap_patterns on the port: the same
    return values, the kernels kept only for the same geometry, and the new
    set's counts either way."""
    monkeypatch.setenv("MSM_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MSM_PALLAS_TABLE", "1")
    rng = np.random.default_rng(61)
    payloads = rng.integers(97, 100, size=(24, 96)).astype(np.uint8)
    lengths = rng.integers(0, 97, size=24).astype(np.int32)
    cols = np.arange(96)[None, :]
    payloads = np.where(cols < lengths[:, None], payloads, 0).astype(np.uint8)
    m, jm = Matcher([b"ab", b"caca"], device="cpu"), JaxMatcher([b"ab", b"caca"])
    kern, jkern = m.kernels, jm.pallas
    assert m.count(payloads, lengths).tolist() == _jax_window([b"ab", b"caca"], payloads, lengths)
    for new, kept in (([b"ba", b"acbc"], True), ([b"ba", b"acbcacbc", b"q"], False)):
        assert m.swap_patterns(new) is jm.swap_patterns(new) is kept
        assert (m.kernels is kern) == (jm.pallas is jkern) == kept
        assert m.count(payloads, lengths).tolist() == _jax_window(new, payloads, lengths)
    with pytest.raises(ValueError):
        m.swap_patterns([])
    monkeypatch.delenv("MSM_PALLAS_TABLE")
    # No table kernels bound: False where the new set takes the table
    # kernels, as in the JAX package; True for the window kernels.
    assert Matcher([b"ab"], device="cpu").swap_patterns(RANDOM600) is JaxMatcher([b"ab"]).swap_patterns(RANDOM600) is False
    assert Matcher(RANDOM600, device="cpu").swap_patterns([b"ab"]) is True


@pytest.fixture(scope="module")
def large_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_table_cli") / "rules.txt"
    path.write_bytes(b"\n".join(LARGE) + b"\n")
    assert load_patterns(path) == LARGE
    return path


@pytest.fixture
def table_calls(monkeypatch):
    """Count the table matcher's tile counts (on the CPU the wrappers run the
    plain versions, which are not launches)."""
    calls = []
    orig_totals, orig_rows = CudaTableMatcher._tile_totals, CudaTableMatcher._tile_rows

    def totals(self, *a):
        calls.append(("totals", self.filtered))
        return orig_totals(self, *a)

    def rows(self, *a):
        calls.append(("rows", self.filtered))
        return orig_rows(self, *a)

    monkeypatch.setattr(CudaTableMatcher, "_tile_totals", totals)
    monkeypatch.setattr(CudaTableMatcher, "_tile_rows", rows)
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    return calls


def test_serial_large_file_reaches_table_kernels(capture, large_file, table_calls, capsys):
    assert cli._build(str(large_file)).explain()["pallas_kernel"] == "table+filter"
    assert cli.main(["serial", str(capture), str(large_file), "udp"]) == 0
    got = capsys.readouterr().out
    assert table_calls and set(table_calls) == {("totals", True)}
    assert jax_main(["serial", str(capture), str(large_file), "udp"]) == 0
    want = capsys.readouterr().out

    def body(text):
        return [ln for ln in text.splitlines() if not ln.startswith("Elapsed time = ")]

    assert body(got) == body(want)
    assert len(body(got)) > 50


@pytest.mark.parametrize("flags", [[], ["--per-packet"]])
def test_match_json_large_file_equals_jax(capture, large_file, table_calls, capsys, flags):
    argv = ["match", "--pcap", str(capture), "--patterns", str(large_file), "--json", *flags]
    assert cli.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert table_calls and {kind for kind, _ in table_calls} == {"rows" if flags else "totals"}
    assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    for key in ("patterns", "counts", "packets", "valid_payloads", "payload_bytes"):
        assert got[key] == want[key], key
    assert got["execution"]["pallas_kernel"] == "table+filter"
    assert got["execution"]["device"] == "cpu"
