"""The CUDA kernels of the torch package against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without one.
This file imports no jax, so it also runs where jax is not installed::

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m gpu

Counts are integers: every comparison is exact (tolerance 0).
"""

import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
from multithreading_string_matching_tpu_torch.ops.table import filter_count, partition, table_count
from multithreading_string_matching_tpu_torch.ops.window import WindowProgram, window_count

pytestmark = pytest.mark.gpu

STANDIN = (
    pathlib.Path(__file__).resolve().parent.parent
    / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"
)
DUPS = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"abcdefgh", b"abcde"]
NUL = [b"a\x00b", b"\x00\x00", b"ab", b"\x00", b"b\x00"]
LONG = [b"abcdefghijklmnopq", b"ab", b"bcd"]
RS = [b"rs%06d" % i for i in range(3072)]

# name: (patterns, seed, rows, width, alphabet)
CASES = {
    "dups-128": (DUPS, 1, 16, 128, b"abc\x00"),
    "dups-width-13": (DUPS, 2, 7, 13, b"abc\x00"),
    "dups-width-100": (DUPS, 3, 5, 100, b"abc\x00"),
    "nul": (NUL, 4, 12, 61, b"ab\x00"),
    "longer-than-row": (LONG, 5, 40, 8, b"abcd"),
    "zero-rows": (DUPS, 6, 0, 32, b"abc"),
    "zero-width": (DUPS, 7, 4, 0, b"abc"),
    "multi-segment": (DUPS, 8, 3, 9000, b"abc"),
    "rs3072-chunked": (RS, 9, 64, 256, b"rs0123"),
    "many-blocks": (DUPS, 10, 9000, 24, b"abc"),
}

_rng = np.random.default_rng(11)
MIXED_K = list(dict.fromkeys(
    bytes(_rng.integers(97, 100, size=_rng.integers(1, 33)).tolist()) for _ in range(300)
))
# Large-set cases for the table kernels: name: (patterns, seed, rows, width, alphabet)
TABLE_CASES = {
    **CASES,
    "mixed-k1-8": (MIXED_K, 12, 64, 300, b"abc"),
    "nul-k1-9": ([b"\x00" * k for k in range(1, 10)] + [b"a\x00b\x00c\x00d"], 13, 40, 90, b"ab\x00"),
    "one-pattern-class": ([b"abcdefghijklmnopq", b"ab", b"abc", b"abcd"], 14, 40, 64, b"abcdefghijklmnopq"),
    "shared-prefix": ([b"pt00%04d" % i for i in range(64)], 15, 64, 128, b"pt0123"),
    "filter-word-without-pattern": ([b"abcdwxyz", b"efghijkl", b"mnopqrst"], 16, 64, 200,
                                    b"wxyzijklqrst"),
    "k-up-to-64": ([b"a" * 36, b"ab" * 32, b"b" * 132, b"ab" * 128], 17, 12, 5000, b"ab"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _tile(seed, n, L, alphabet, dev, plant=()):
    """Random rows of ``alphabet`` (not zero past their lengths); with
    ``plant``, row r also holds ``plant[r % len(plant)]`` where it fits."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    payloads = letters[rng.integers(0, len(letters), size=(n, L))]
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    for r in range(n if plant else 0):
        pat = plant[r % len(plant)]
        if len(pat) <= L:
            o = int(rng.integers(0, L - len(pat) + 1))
            payloads[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    return torch.from_numpy(payloads).to(dev), torch.from_numpy(lengths).to(dev)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_equal_plain(cuda_device, case):
    pats, seed, n, L, alphabet = CASES[case]
    words, masks, lens = WindowProgram.build(pats).tables(cuda_device)
    p, ln = _tile(seed, n, L, alphabet, cuda_device)
    for fn, per_row in ((cw.window_count_totals, False), (cw.window_count_rows, True)):
        got = fn(p, ln, words, masks, lens)
        want = window_count(words, masks, lens, p, ln, per_packet=per_row)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want)


def test_wrappers_count_launches_and_refuse_bad_inputs(cuda_device):
    words, masks, lens = WindowProgram.build(DUPS).tables(cuda_device)
    p, ln = _tile(1, 8, 64, b"abc", cuda_device)
    before = dict(cw.LAUNCHES)
    cw.window_count_totals(p, ln, words, masks, lens)
    cw.window_count_rows(p, ln, words, masks, lens)
    assert cw.LAUNCHES["window_count_totals"] == before["window_count_totals"] + 1
    assert cw.LAUNCHES["window_count_rows"] == before["window_count_rows"] + 1
    with pytest.raises(TypeError):
        cw.window_count_totals(p.long(), ln, words, masks, lens)
    with pytest.raises(ValueError, match="contiguous"):
        cw.window_count_totals(p[:, ::2], ln, words, masks, lens)
    with pytest.raises(ValueError):
        cw.window_count_totals(p, ln.cpu(), words, masks, lens)
    with pytest.raises(ValueError):
        cw.window_count_totals(p, ln[:3], words, masks, lens)


def test_matcher_on_card_equals_plain_on_cpu(cuda_device):
    pats = load_patterns(STANDIN)
    rng = np.random.default_rng(3)
    payloads = rng.integers(0, 256, size=(700, 300)).astype(np.uint8)
    for _ in range(2000):
        pat = pats[int(rng.integers(0, len(pats)))]
        r, o = int(rng.integers(0, 700)), int(rng.integers(0, 300 - len(pat)))
        payloads[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    lengths = rng.integers(0, 301, size=700).astype(np.int32)
    gpu, cpu = Matcher(pats, device=cuda_device), Matcher(pats, device="cpu")
    for staging in ("auto", "packed", "bucketed"):
        got = gpu.count(payloads, lengths, staging=staging)
        assert np.array_equal(got, cpu.count(payloads, lengths, staging=staging))
    assert np.array_equal(gpu.count(payloads, lengths, per_packet=True),
                          cpu.count(payloads, lengths, per_packet=True))
    assert gpu.count(payloads, lengths).sum() > 1000


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_table_kernels_equal_plain(cuda_device, case):
    """The four table/filter kernels, and both totals kernels with reps=3,
    equal their plain versions on every word-count class."""
    pats, seed, n, L, alphabet = TABLE_CASES[case]
    p, ln = _tile(seed, n, L, alphabet, cuda_device, plant=pats)
    for filtered in (False, True):
        plain = filter_count if filtered else table_count
        totals = ct.filter_count_totals if filtered else ct.table_count_totals
        rows = ct.filter_count_rows if filtered else ct.table_count_rows
        for c in partition(WindowProgram.build(pats), filtered)[0]:
            tabs = c.tables(cuda_device)
            want = plain(*tabs, p, ln, c.K)
            assert torch.equal(want, table_count(*tabs, p, ln, c.K))
            for reps in (1, 3):
                got = totals(p, ln, *tabs, c.K, reps=reps)
                torch.cuda.synchronize()
                assert got.dtype == torch.int32 and torch.equal(got, reps * want), (filtered, c.K, reps)
            got = rows(p, ln, *tabs, c.K)
            torch.cuda.synchronize()
            assert torch.equal(got, plain(*tabs, p, ln, c.K, per_row=True)), (filtered, c.K)


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_repeats_equal_plain(cuda_device, case):
    pats, seed, n, L, alphabet = CASES[case]
    words, masks, lens = WindowProgram.build(pats).tables(cuda_device)
    p, ln = _tile(seed, n, L, alphabet, cuda_device)
    before = cw.LAUNCHES["window_count_totals_repeated"]
    got = cw.window_count_totals(p, ln, words, masks, lens, reps=3)
    torch.cuda.synchronize()
    assert torch.equal(got, 3 * window_count(words, masks, lens, p, ln))
    assert cw.LAUNCHES["window_count_totals_repeated"] == before + int(n * L > 0)


def test_table_wrappers_count_launches_and_refuse_bad_inputs(cuda_device):
    (c,) = partition(WindowProgram.build([b"abcdefgh", b"bcdefgha"]), True)[0]
    words, masks, lens = c.tables(cuda_device)
    p, ln = _tile(1, 8, 64, b"abcdefgh", cuda_device)
    before = dict(ct.LAUNCHES)
    ct.filter_count_totals(p, ln, words, masks, lens, c.K)
    ct.filter_count_totals(p, ln, words, masks, lens, c.K, reps=2)
    ct.filter_count_rows(p, ln, words, masks, lens, c.K)
    ct.table_count_totals(p, ln, words, masks, lens, c.K)
    ct.table_count_rows(p, ln, words, masks, lens, c.K)
    for name, added in (("filter_count_totals", 1), ("filter_count_totals_repeated", 1),
                        ("filter_count_rows", 1), ("table_count_totals", 1),
                        ("table_count_rows", 1), ("table_count_totals_repeated", 0)):
        assert ct.LAUNCHES[name] == before[name] + added, name
    with pytest.raises(ValueError, match="filter column"):
        ct.filter_count_totals(p, ln, words[:, :c.K].contiguous(), masks[:, :c.K].contiguous(),
                               lens, c.K)
    with pytest.raises(ValueError, match="reps"):
        ct.table_count_totals(p, ln, words, masks, lens, c.K, reps=0)
    with pytest.raises(TypeError):
        ct.table_count_totals(p.long(), ln, words, masks, lens, c.K)
    with pytest.raises(ValueError):
        ct.table_count_rows(p, ln.cpu(), words, masks, lens, c.K)


def test_large_set_matcher_on_card_equals_plain_on_cpu(cuda_device):
    pats = [b"rs%06d" % i for i in range(700)] + MIXED_K
    rng = np.random.default_rng(4)
    payloads = rng.integers(0, 256, size=(600, 400)).astype(np.uint8)
    for _ in range(3000):
        pat = pats[int(rng.integers(0, len(pats)))]
        r, o = int(rng.integers(0, 600)), int(rng.integers(0, 400 - len(pat)))
        payloads[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    lengths = rng.integers(0, 401, size=600).astype(np.int32)
    gpu, cpu = Matcher(pats, device=cuda_device), Matcher(pats, device="cpu")
    assert gpu.explain()["pallas_kernel"] == "table+filter"
    assert isinstance(gpu.kernels, ct.CudaTableMatcher)
    want = cpu.count(payloads, lengths)
    assert want.sum() > 1000
    for staging in ("auto", "bucketed"):
        assert np.array_equal(gpu.count(payloads, lengths, staging=staging), want)
    assert np.array_equal(gpu.count(payloads, lengths, per_packet=True),
                          cpu.count(payloads, lengths, per_packet=True))
