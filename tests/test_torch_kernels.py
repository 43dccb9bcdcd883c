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
from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _tile(seed, n, L, alphabet, dev):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    payloads = letters[rng.integers(0, len(letters), size=(n, L))]
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
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
