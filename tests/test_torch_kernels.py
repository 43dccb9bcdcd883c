"""The CUDA kernels of the torch package against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without one.
This file imports no jax, so it also runs where jax is not installed::

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m gpu

Counts are integers: every comparison is exact (tolerance 0).
"""

import ctypes
import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
from multithreading_string_matching_tpu_torch.ops.table import filter_count, partition, table_count
from multithreading_string_matching_tpu_torch.ops.window import (
    WindowProgram,
    window_count,
    window_count_halo_plain,
    window_find_plain,
    window_stream_chunk,
)

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


def _one_bucket(n, alphabet, seed):
    """``n`` 4-byte patterns whose probe keys share one hash bucket of a
    launch over ``n`` patterns with one probe mask, by the kernels' own hash
    (``cw.probe_bucket``: the library's ``msm_probe_bucket``)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    groups = {}
    while True:
        pat = bytes(letters[rng.integers(0, len(letters), size=4)].tolist())
        group = groups.setdefault(cw.probe_bucket(int.from_bytes(pat, "little"), 0, n), set())
        group.add(pat)
        if len(group) == n:
            return sorted(group)


def _long_rules(n, seed):
    """``n`` unique patterns of 29-32 bytes: one word-count class, K = 8."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)
    out = {}
    while len(out) < n:
        out.setdefault(bytes(letters[rng.integers(0, 36, size=int(rng.integers(29, 33)))]), None)
    return list(out)


HEX16 = b"0123456789abcdef"
# Cases aimed at the hashed probe: name: (patterns, seed, rows, width,
# alphabet); a callable makes its patterns on the card (the library's hash).
PROBE_CASES = {
    "one-probe-key-3072": ([b"HTTP/1.%04d" % i for i in range(3072)], 71, 64, 300,
                           b"HTP/1.0123456789"),
    "one-bucket": (lambda: _one_bucket(64, HEX16, 72), 72, 64, 300, HEX16),
    "four-masks-1-2-3-4-bytes": ([b"a", b"b", b"ab", b"ca", b"abc", b"bca", b"abca", b"cabc",
                                  b"abcab"], 73, 64, 200, b"abc"),
    "nul-inside-keys": ([b"\x00a\x00b", b"a\x00\x00", b"\x00", b"\x00\x00\x00\x00",
                         b"a\x00b\x00c\x00d\x00", b"\x00\x00ab"], 74, 64, 120, b"ab\x00"),
    "filter-word-twice": ([b"wxyzabcdwxyz", b"abcdefgh", b"ijklabcd", b"abcdmnop",
                           b"qrstabcd"], 75, 64, 200, b"wxyzabcd"),
    "u1-k8": ([b"abcdefghijklmnopqrstuvwxyz012345"], 76, 64, 300, b"abcdefghijklmnopqrstuvwxyz012345"),
    "u3072-k8": (_long_rules(3072, 77), 77, 128, 400, b"abcdefghijklmnopqrstuvwxyz0123456789"),
    # more patterns than one hash table holds (csrc/probe.cuh kMaxChunk =
    # 4,096): three chunks, each re-staging the tile
    "u9000-three-chunks":([b"c%05d" % i for i in range(9000)], 78, 64, 300, b"c0123456789"),
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


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_cases_equal_plain(cuda_device, case):
    """The hash's hard cases, on planted rows: every kernel of both
    libraries (window totals with reps 1 and 3, rows, halo; table and
    filter totals with reps 1 and 3, rows) equals its plain version."""
    pats, seed, n, L, alphabet = PROBE_CASES[case]
    pats = pats() if callable(pats) else pats
    p, ln = _tile(seed, n, L, alphabet, cuda_device, plant=pats)
    wp = WindowProgram.build(pats)
    words, masks, lens = wp.tables(cuda_device)
    want = window_count(words, masks, lens, p, ln)
    assert want.sum() > 0
    for reps in (1, 3):
        got = cw.window_count_totals(p, ln, words, masks, lens, reps=reps)
        torch.cuda.synchronize()
        assert torch.equal(got, reps * want), reps
    got = cw.window_count_rows(p, ln, words, masks, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, window_count(words, masks, lens, p, ln, per_packet=True))
    H = max(int(wp.max_len) - 1, 1)
    ms = torch.from_numpy(np.random.default_rng(seed).integers(0, H + 1, size=n).astype(np.int32))
    ms = ms.to(cuda_device)
    eff = torch.clamp(ln, min=0)
    got = cw.window_count_halo(p, eff, ms, words, masks, lens, H)
    torch.cuda.synchronize()
    assert torch.equal(got, window_count_halo_plain(p, eff, ms, H, (words, masks, lens)))
    for filtered in (False, True):
        plain = filter_count if filtered else table_count
        totals = ct.filter_count_totals if filtered else ct.table_count_totals
        rows = ct.filter_count_rows if filtered else ct.table_count_rows
        for c in partition(wp, filtered)[0]:
            tabs = c.tables(cuda_device)
            want = plain(*tabs, p, ln, c.K)
            for reps in (1, 3):
                got = totals(p, ln, *tabs, c.K, reps=reps)
                torch.cuda.synchronize()
                assert torch.equal(got, reps * want), (filtered, c.K, reps)
            got = rows(p, ln, *tabs, c.K)
            torch.cuda.synchronize()
            assert torch.equal(got, plain(*tabs, p, ln, c.K, per_row=True)), (filtered, c.K)


def test_probe_bucket_is_the_kernels_hash(cuda_device):
    """``cw.probe_bucket`` asks the library (``msm_probe_bucket``): table
    sizes are the least power of two >= twice a chunk's patterns, at least
    64, and a chunk holds at most 4,096 patterns; the one-bucket case's keys
    really share a bucket, and a bad mask index is refused."""
    assert {cw.probe_bucket(k, 0, 1) for k in range(4096)} == set(range(64))
    assert {cw.probe_bucket(k, 0, 64) for k in range(1 << 16)} == set(range(128))
    assert max(cw.probe_bucket(k, 3, 3072) for k in range(1 << 16)) == 8191
    assert max(cw.probe_bucket(k, 0, 100_000) for k in range(1 << 16)) == (1 << 13) - 1
    key = int.from_bytes(b"HTTP", "little")
    assert cw.probe_bucket(key, 0, 64) != cw.probe_bucket(key, 1, 64)  # the mask index hashes
    pats = _one_bucket(64, HEX16, 72)
    assert len({cw.probe_bucket(int.from_bytes(q, "little"), 0, 64) for q in pats}) == 1
    with pytest.raises(RuntimeError, match="msm_probe_bucket"):
        cw.probe_bucket(key, cw.MAX_PROBE_MASKS, 64)


def test_probe_wildcards_and_mask_limit(cuda_device):
    """A probe of mask 0 and word 0 fires everywhere, and the C entry points
    take a ninth probe mask on the same wildcard chain: both stay exact.
    The wrappers refuse more than MAX_PROBE_MASKS probe masks."""
    p, ln = _tile(81, 48, 160, b"abcd", cuda_device, plant=[b"abcdabcd", b"dcba"])
    # Pattern 0: any 4 bytes, then "abcd"; 1: "dcba"; 2: never fires.
    words = torch.tensor([[0, int.from_bytes(b"abcd", "little")],
                          [int.from_bytes(b"dcba", "little"), 0], [1, 0]], dtype=torch.int32)
    masks = torch.tensor([[0, -1], [-1, 0], [0, 0]], dtype=torch.int32)
    lens = torch.tensor([8, 4, 4], dtype=torch.int32)
    words, masks, lens = words.to(cuda_device), masks.to(cuda_device), lens.to(cuda_device)
    want = table_count(words, masks, lens, p, ln, 2)
    assert want[0] > 0 and want[1] > 0 and want[2] == 0
    got = ct.table_count_totals(p, ln, words, masks, lens, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(cw.window_count_totals(p, ln, words, masks, lens), want)
    # Nine probe masks: the wrappers raise; the C entry point counts exactly.
    nine = [(1 << (8 * (b + 1))) - 1 for b in range(3)] + [0xFFFFFFFF, 0xFF00, 0xFF0000,
                                                         0xFF000000, 0x00FF00FF, 0xFFFF0000]
    pats = [b"abcd", b"bcda", b"cdab", b"dabc", b"aabb", b"abab", b"dddd", b"acac", b"cdcd"]
    w9 = torch.tensor([int.from_bytes(q, "little") & m for q, m in zip(pats, nine)],
                      dtype=torch.int64).to(torch.int32)[:, None]
    m9 = torch.tensor(nine, dtype=torch.int64).to(torch.int32)[:, None]
    l9 = torch.full((9,), 4, dtype=torch.int32)
    w9, m9, l9 = w9.to(cuda_device), m9.to(cuda_device), l9.to(cuda_device)
    with pytest.raises(ValueError, match="masks"):
        cw.window_count_totals(p, ln, w9, m9, l9)
    with pytest.raises(ValueError, match="masks"):
        ct.table_count_rows(p, ln, w9, m9, l9, 1)
    want = window_count(w9, m9, l9, p, ln)
    out = torch.zeros(9, dtype=torch.int32, device=cuda_device)
    cw.LIBRARY.call("msm_window_count_totals", p.data_ptr(), ln.data_ptr(), w9.data_ptr(),
                    m9.data_ptr(), l9.data_ptr(), out.data_ptr(), p.shape[0], p.shape[1], 9, 1,
                    1, 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and want.sum() > 0


# -- the halo kernel (flow-stream rounds) ------------------------------------

# name: (patterns, seed, rows, halo-free width C, alphabet)
HALO_CASES = {
    "small": ([b"ab", b"bca", b"aaaa", b"abcab"], 21, 64, 64, b"abc"),
    "nul": ([b"a\x00b", b"\x00c", b"ca", b"\x00\x00\x01"], 22, 64, 96, b"abc\x00\x01"),
    "wider-than-a-segment": (DUPS, 23, 12, 5000, b"abc"),
    "sub-lane-width": (load_patterns(STANDIN), 24, 300, 2048,
                       b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ/:. "),
    "rs3072": (RS, 25, 64, 256, b"rs0123"),
}


def _halo_lanes(pats, seed, n, C, alphabet, dev):
    """Rows ``[halo | bytes]`` with random real halo fills, random valid
    lengths (some 0) and planted patterns; bytes past a row's length are
    not zero."""
    wp = WindowProgram.build(pats)
    H = max(int(wp.max_len) - 1, 1)
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    x = letters[rng.integers(0, len(letters), size=(n, H + C))]
    for r in range(n):
        pat = pats[r % len(pats)]
        for _ in range(3):
            o = int(rng.integers(0, H + C - len(pat) + 1))
            x[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    fill = rng.integers(0, H + 1, size=n)
    eff = np.minimum(rng.integers(0, C + 1, size=n) + H, H + C)
    eff[::7] = 0
    ms = (H - fill).astype(np.int32)
    return (wp, H, torch.from_numpy(x).to(dev), torch.from_numpy(eff.astype(np.int32)).to(dev),
            torch.from_numpy(ms).to(dev))


@pytest.mark.parametrize("case", sorted(HALO_CASES))
def test_halo_kernel_equals_plain(cuda_device, case):
    wp, H, x, eff, ms = _halo_lanes(*HALO_CASES[case], cuda_device)
    words, masks, lens = wp.tables(cuda_device)
    before = cw.LAUNCHES["window_count_halo"]
    got = cw.window_count_halo(x, eff, ms, words, masks, lens, H)
    torch.cuda.synchronize()
    assert cw.LAUNCHES["window_count_halo"] == before + 1
    want = window_count_halo_plain(x, eff, ms, H, (words, masks, lens))
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(cw.CudaWindowMatcher(wp, cuda_device).count_tile_halo(x, eff, ms), want)


def test_halo_wrapper_refuses_bad_inputs(cuda_device):
    wp, H, x, eff, ms = _halo_lanes(*HALO_CASES["small"], cuda_device)
    words, masks, lens = wp.tables(cuda_device)
    with pytest.raises(ValueError):
        cw.window_count_halo(x, eff, ms[:3], words, masks, lens, H)
    with pytest.raises(TypeError):
        cw.window_count_halo(x, eff, ms.long(), words, masks, lens, H)
    with pytest.raises(ValueError):
        cw.window_count_halo(x, eff, ms.cpu(), words, masks, lens, H)
    with pytest.raises(ValueError):
        cw.window_count_halo(x, eff, ms, words, masks, lens, -1)


def test_window_stream_chunk_on_card_equals_cpu(cuda_device):
    pats = [b"a\x00b", b"\x00c", b"ca", b"abcab"]
    wp = WindowProgram.build(pats)
    kern = cw.CudaWindowMatcher(wp, cuda_device)
    rng = np.random.default_rng(31)
    payloads = rng.integers(0, 4, size=(16, 300)).astype(np.uint8) + 96
    payloads[rng.random(payloads.shape) < 0.1] = 0
    lengths = rng.integers(0, 301, size=16).astype(np.int32)
    halos = {"cpu": None, "plain": None, "kernel": None}
    before = cw.LAUNCHES["window_count_halo"]
    for start in range(0, 300, 37):
        c = payloads[:, start : start + 37]
        rel = (lengths - start).astype(np.int32)
        want, halos["cpu"] = window_stream_chunk(wp, c, rel, halos["cpu"])
        dc = torch.from_numpy(np.ascontiguousarray(c)).to(cuda_device)
        plain, halos["plain"] = window_stream_chunk(wp, dc, rel, halos["plain"])
        got, halos["kernel"] = window_stream_chunk(wp, dc, rel, halos["kernel"],
                                                   halo_count=kern.count_tile_halo)
        torch.cuda.synchronize()
        assert torch.equal(plain.cpu(), want) and torch.equal(got.cpu(), want)
        assert torch.equal(halos["kernel"].data.cpu(), halos["cpu"].data)
    assert cw.LAUNCHES["window_count_halo"] > before


@pytest.mark.parametrize("pats", [load_patterns(STANDIN), RS[:700]],
                         ids=["standin", "rs700-table-route"])
def test_flow_stream_on_card_equals_cpu(cuda_device, tmp_path, pats):
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
    from multithreading_string_matching_tpu_torch.io.synth import synth_tcp_flows_pcap
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher

    rng = np.random.default_rng(41)
    flows = []
    for i in range(40):
        pay = bytearray(rng.integers(0, 256, size=int(rng.integers(2000, 9000)), dtype=np.uint8))
        for _ in range(20):
            p = pats[int(rng.integers(0, len(pats)))]
            o = int(rng.integers(0, len(pay) - len(p)))
            pay[o : o + len(p)] = p
        flows.append(((f"10.3.0.{i + 1}", "10.3.1.1", 5000 + i, 80), bytes(pay)))
    path = tmp_path / "flows.pcap"
    synth_tcp_flows_pcap(path, flows, segment_len=700, interleave_seed=1)
    pcap = read_pcap(path)
    out = {}
    for dev in ("cpu", cuda_device):
        fs = FlowStreamMatcher(Matcher(pats, device=dev), "tcp", engine="window",
                               scan_bytes=20_000)
        before = dict(cw.LAUNCHES)
        for s in range(0, pcap.num_packets, 40):
            fs.feed_pcap_slice(slice_pcap(pcap, s, s + 40))
        fs.flush()
        out[str(dev)] = fs.counts()
        launched = cw.LAUNCHES["window_count_halo"] - before["window_count_halo"]
        assert launched == (fs._round if dev != "cpu" else 0)
    assert np.array_equal(out["cpu"], out[str(cuda_device)]) and out["cpu"].sum() > 100


# -- the pattern-shard kernels (ShardTableKernel) ------------------------------

# name: (patterns, shards, seed, rows, width, alphabet)
SHARD_CASES = {
    "padded-slots": ([b"abc", b"bcab", b"cabca", b"ab"], 1, 51, 64, 256, b"abc"),
    "short-in-k8": ([b"a", b"ab", b"abc", b"abcabcabcabcabcabcabcabcabcabca"], 2, 52, 64, 300,
                    b"abc"),
    "nul-not-zero-filled": (NUL + [b"a\x00b\x00c\x00d"], 3, 53, 40, 90, b"ab\x00"),
    "k-max-64": ([b"a" * 36, b"ab" * 32, b"b" * 132, b"ab" * 128, b"ab", b"b"], 2, 54, 12, 5000,
                 b"ab"),
    "mixed-k1-8": (MIXED_K, 4, 55, 64, 300, b"abc"),
    "rs3072": (RS, 1, 56, 64, 256, b"rs0123"),
}


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shard_kernels_equal_plain(cuda_device, case):
    """Each shard block's totals and per-row counts, table and filter
    forms, equal the plain versions; padded slots count 0; the launches go
    to the shard keys, not the class route's."""
    from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
        build_pattern_shards,
    )

    pats, n_sh, seed, n, L, alphabet = SHARD_CASES[case]
    p, ln = _tile(seed, n, L, alphabet, cuda_device, plant=pats)
    wp = WindowProgram.build(pats)
    for filtered in (False, True):
        plan = build_pattern_shards(wp, n_sh, filtered=filtered)
        kern = ct.ShardTableKernel(plan.K, plan.S, plan.use_fit, filtered, cuda_device)
        plain = filter_count if filtered else table_count
        form = "filter" if filtered else "table"
        before = dict(ct.LAUNCHES)
        found = 0
        for d in range(n_sh):
            rows = slice(d * plan.S, (d + 1) * plan.S)
            w, m = (torch.from_numpy(np.ascontiguousarray(a[rows]).view(np.int32)).to(cuda_device)
                    for a in (plan.words, plan.masks))
            lens = torch.from_numpy(plan.lens[rows]).to(cuda_device)
            want = plain(w, m, lens.view(-1), p, ln, plan.K)
            got = kern.counts(w, m, lens, p, ln)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, want), (form, d)
            assert not got[plan.valid(d):].any()
            got_rows = kern.rows(w, m, lens, p, ln)
            torch.cuda.synchronize()
            assert torch.equal(got_rows, plain(w, m, lens.view(-1), p, ln, plan.K, per_row=True))
            found += int(got.sum())
        assert found > 0
        for k, v in ct.LAUNCHES.items():
            added = n_sh if k in (f"shard_{form}_count_totals", f"shard_{form}_count_rows") else 0
            assert v == before[k] + added, (form, k)


def test_pattern_sharded_virtual_meshes_on_card(cuda_device):
    """A 4-shard and a 2x2 mesh on one card through the pattern-sharded
    entry points, and a 2-shard flow round, equal the CPU's plain counts;
    one shard kernel launch per shard and call."""
    from multithreading_string_matching_tpu_torch.parallel.mesh import (
        count_flow_round_sharded,
        make_mesh,
    )
    from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
        count_matches_pattern_sharded,
        count_rows_pattern_sharded,
        count_rows_summary_pattern_sharded,
        make_2d_mesh,
        make_pattern_mesh,
    )

    pats = RS[:400] + MIXED_K
    rng = np.random.default_rng(57)
    payloads = rng.integers(0, 256, size=(300, 400)).astype(np.uint8)
    for _ in range(1500):
        pat = pats[int(rng.integers(0, len(pats)))]
        r, o = int(rng.integers(0, 300)), int(rng.integers(0, 400 - len(pat)))
        payloads[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    lengths = rng.integers(0, 401, size=300).astype(np.int32)
    gpu, cpu = Matcher(pats, device=cuda_device), Matcher(pats, device="cpu")
    want = cpu.count(payloads, lengths)
    want_rows = cpu.count(payloads, lengths, per_packet=True)
    assert want.sum() > 500
    for mesh, shards in ((make_pattern_mesh([cuda_device] * 4), 4),
                         (make_2d_mesh(2, 2, [cuda_device] * 4), 4)):
        before = dict(ct.LAUNCHES)
        got = count_matches_pattern_sharded(gpu, payloads, lengths, mesh)
        assert np.array_equal(got, want)
        assert ct.LAUNCHES["shard_filter_count_totals"] == before["shard_filter_count_totals"] + shards
        assert ct.LAUNCHES["filter_count_totals"] == before["filter_count_totals"]
        assert np.array_equal(count_rows_pattern_sharded(gpu, payloads, lengths, mesh), want_rows)
        tot, hits = count_rows_summary_pattern_sharded(gpu, payloads, lengths, mesh)
        assert np.array_equal(tot[gpu.window.dup_map], want)
        assert np.array_equal(hits, want_rows.sum(axis=1) > 0)
    wp, H, x, eff, ms = _halo_lanes(*HALO_CASES["small"], "cpu")
    m = Matcher([b"ab", b"bca", b"aaaa", b"abcab"], device=cuda_device)
    before = cw.LAUNCHES["window_count_halo"]
    got = count_flow_round_sharded(m, x.numpy(), eff.numpy(), ms.numpy(),
                                   make_mesh([cuda_device] * 2), engine="pallas")
    torch.cuda.synchronize()
    assert cw.LAUNCHES["window_count_halo"] == before + 2
    assert torch.equal(got.cpu(), window_count_halo_plain(x, eff, ms, H, wp.tables("cpu")))


# -- the matrix-unit kernel (ops/mxu.py) ---------------------------------------

# name: (patterns, seed, rows, width, alphabet)
MXU_CASES = {
    "ragged-width-1000": (load_patterns(STANDIN), 61, 37, 1000,
                          b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ/:. "),
    "width-13": ([b"ab", b"b", b"abcdefgh"], 62, 9, 13, b"abc"),
    "m-max-99": ([b"a", b"ab" * 49 + b"a", b"b" * 99, b"ba"], 63, 20, 517, b"ab"),
    "u-1": ([b"abc"], 64, 50, 300, b"abc"),
    "u-127": ([b"x%03d" % i for i in range(127)], 65, 40, 260, b"x0123"),
    "u-128": ([b"x%03d" % i for i in range(128)], 66, 40, 260, b"x0123"),
    "u-129": ([b"x%03d" % i for i in range(129)], 67, 40, 260, b"x0123"),
    "u-3072": (RS, 68, 64, 256, b"rs0123"),
    "zero-rows": ([b"ab"], 69, 0, 64, b"ab"),
    # the wgmma tiling's edges: N-tile widths, pt x 3,072 at C = 64, rows
    # shorter than, equal to and past one M-tile, and more row segments
    # than the persistent grid has blocks
    "u-88": ([b"x%03d" % i for i in range(88)], 70, 40, 260, b"x0123"),
    "u-96": ([b"x%03d" % i for i in range(96)], 71, 40, 260, b"x0123"),
    "u-256": ([b"x%03d" % i for i in range(256)], 72, 40, 260, b"x0123"),
    "u-257": ([b"x%03d" % i for i in range(257)], 73, 40, 260, b"x0123"),
    "pt-3072-c64": ([b"pt%06d" % i for i in range(3072)], 74, 97, 517, b"pt0123"),
    "width-1": ([b"a", b"b", b"ab"], 75, 300, 1, b"ab"),
    "width-63": ([b"ab", b"bab", b"a" * 20], 76, 300, 63, b"ab"),
    "width-65": ([b"ab", b"bab", b"a" * 20], 77, 300, 65, b"ab"),
    "segments-past-grid": (load_patterns(STANDIN), 78, 3000, 1100,
                           b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ/:. "),
    # four k-steps: N = 96 takes one M-tile at a time, N = 64 two
    "u-90-k4": ([b"k%014d" % i for i in range(90)], 79, 200, 700, b"k0123456789"),
    "u-60-k4": ([b"q%015d" % i for i in range(60)], 80, 200, 700, b"q0123456789"),
}

# Patterns of 8, 20 and 33 bytes (C = 264: three groups of k-steps).
BOUNDARY_PATS = [b"abcdefgh", b"xy" * 10, b"q" + b"r" * 31 + b"q"]


@pytest.mark.parametrize("case", sorted(MXU_CASES))
def test_mxu_kernel_equals_plain(cuda_device, case):
    """``mxu_count`` (int8 wgmma) equals ``mxu_count_plain`` on the card,
    with reps 1 and 3, on rows zero past their lengths."""
    from multithreading_string_matching_tpu_torch.ops import mxu

    pats, seed, n, L, alphabet = MXU_CASES[case]
    p, ln = _tile(seed, n, L, alphabet, cuda_device, plant=pats)
    p = torch.where(torch.arange(L, device=cuda_device)[None, :] < ln[:, None], p, 0)
    P, tgt, m_max = mxu.bit_tables(pats)
    P, tgt = torch.from_numpy(P).to(cuda_device), torch.from_numpy(tgt).to(cuda_device)
    want = mxu.mxu_count_plain(P, tgt, m_max, p)
    before = dict(mxu.LAUNCHES)
    for reps in (1, 3):
        got = mxu.mxu_count(p, P, tgt, reps=reps)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, reps * want), reps
    launched = int(n > 0)
    assert mxu.LAUNCHES == {"mxu_count": before["mxu_count"] + launched,
                            "mxu_count_repeated": before["mxu_count_repeated"] + launched}
    m = mxu.MxuMatcher(pats, cuda_device)
    assert torch.equal(m.count_tiles([(p, ln)]), want[: len(pats)])
    assert n == 0 or want.sum() > 0


@pytest.mark.parametrize("L", [2085, 4133])
def test_mxu_kernel_segment_boundaries(cuda_device, L):
    """A pattern planted at every offset that touches or straddles a
    64-position boundary of long rows is counted once, as by the plain
    version, with reps 1 and 3: every M-tile boundary, where the kernel's
    units (and their alternating ring slots) may start, and the
    2,048-position unit limit inside a row."""
    from multithreading_string_matching_tpu_torch.ops import mxu

    rows = []
    for pat in BOUNDARY_PATS:
        for b in range(64, L, 64):
            for o in range(max(0, b - len(pat) - 1), min(b + 2, L - len(pat) + 1)):
                row = np.full(L, ord("z"), np.uint8)
                row[o : o + len(pat)] = np.frombuffer(pat, np.uint8)
                rows.append(row)
    p = torch.from_numpy(np.stack(rows)).to(cuda_device)
    P, tgt, m_max = mxu.bit_tables(BOUNDARY_PATS)
    P, tgt = torch.from_numpy(P).to(cuda_device), torch.from_numpy(tgt).to(cuda_device)
    want = mxu.mxu_count_plain(P, tgt, m_max, p)
    assert want[:3].tolist() == [sum(bytes(r).count(pat) for r in rows) for pat in BOUNDARY_PATS]
    for reps in (1, 3):
        got = mxu.mxu_count(p, P, tgt, reps=reps, live=len(BOUNDARY_PATS))
        torch.cuda.synchronize()
        assert torch.equal(got, reps * want), reps


def test_mxu_wrapper_refuses_bad_inputs(cuda_device):
    from multithreading_string_matching_tpu_torch.ops import mxu

    P, tgt, _ = mxu.bit_tables([b"ab", b"b"])
    P, tgt = torch.from_numpy(P).to(cuda_device), torch.from_numpy(tgt).to(cuda_device)
    p, _ = _tile(1, 8, 64, b"ab", cuda_device)
    with pytest.raises(ValueError):
        mxu.mxu_count(p.long(), P, tgt)
    with pytest.raises(ValueError):
        mxu.mxu_count(p, P[:100].contiguous(), tgt[:100])
    with pytest.raises(ValueError):
        mxu.mxu_count(p, P, tgt.cpu())
    with pytest.raises(ValueError, match="reps"):
        mxu.mxu_count(p, P, tgt, reps=0)
    out = torch.zeros(128, dtype=torch.int32, device=cuda_device)
    # The C entry point refuses a depth that is not a multiple of 32; the
    # wrapper turns its return code into an error.
    with pytest.raises(RuntimeError, match="launch failed"):
        mxu.LIBRARY.call("msm_mxu_count", p.data_ptr(), P.data_ptr(), tgt.data_ptr(),
                         out.data_ptr(), 8, 64, 128, 8, 1, 0,
                         torch.cuda.current_stream().cuda_stream)


# -- window_find: one ordered launch (csrc/window_find.cu) ------------------------

FIND_CASES = {
    **{f"probe-{k}": v for k, v in PROBE_CASES.items()
       if k in ("one-probe-key-3072", "one-bucket", "four-masks-1-2-3-4-bytes",
                "nul-inside-keys", "u9000-three-chunks")},
    **{k: CASES[k] for k in ("dups-width-13", "nul", "longer-than-row", "zero-rows",
                             "zero-width", "multi-segment", "many-blocks")},
}


@pytest.mark.parametrize("case", sorted(FIND_CASES))
def test_window_find_equals_plain(cuda_device, case):
    """One launch writes every match once, in order: the triples equal the
    plain bitmap's sorted nonzeros, and their count the totals kernel's."""
    pats, seed, n, L, alphabet = FIND_CASES[case]
    pats = pats() if callable(pats) else pats
    p, ln = _tile(seed, n, L, alphabet, cuda_device,
                  plant=pats if case.startswith("probe-") else ())
    words, masks, lens = WindowProgram.build(pats).tables(cuda_device)
    before = cw.LAUNCHES["window_find"]
    got = cw.window_find(p, ln, words, masks, lens)
    want = window_find_plain(words, masks, lens, p, ln)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert got.shape[0] == int(window_count(words, masks, lens, p, ln).sum())
    assert cw.LAUNCHES["window_find"] == before + (n > 0 and L > 0)
    if case.startswith("probe-"):
        assert got.shape[0] > 0


@pytest.mark.parametrize("L", [2 * 2048 + 37, 3 * 2048])
def test_window_find_segment_boundaries(cuda_device, L):
    """Matches planted across every 2,048-byte boundary of long rows (and so
    across the kernel's 16,384-position tiles) are each found once, at the
    right start."""
    pats = [b"abcdefgh", b"xyz", b"hxyza"]
    rng = np.random.default_rng(L)
    payloads = rng.integers(ord("0"), ord("9") + 1, size=(6, L)).astype(np.uint8)
    for r in range(6):
        for b in range(2048, L, 2048):
            o = b - 1 - r % 7
            q = pats[(r + b // 2048) % len(pats)]
            payloads[r, o : o + len(q)] = np.frombuffer(q, np.uint8)
    lengths = np.full(6, L, np.int32)
    lengths[5] = 2048 + 3  # a row that ends inside its second segment
    p, ln = torch.from_numpy(payloads).to(cuda_device), torch.from_numpy(lengths).to(cuda_device)
    words, masks, lens = WindowProgram.build(pats).tables(cuda_device)
    got = cw.window_find(p, ln, words, masks, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, window_find_plain(words, masks, lens, p, ln))
    starts = got[:, 1].cpu().numpy()
    assert ((starts < 2048) & (starts + 8 > 2048)).any()


def test_window_find_refuses_bad_inputs(cuda_device):
    words, masks, lens = WindowProgram.build(DUPS).tables(cuda_device)
    p, ln = _tile(1, 8, 64, b"abc", cuda_device)
    with pytest.raises(TypeError):
        cw.window_find(p.long(), ln, words, masks, lens)
    with pytest.raises(ValueError, match="contiguous"):
        cw.window_find(p[:, ::2], ln, words, masks, lens)
    with pytest.raises(ValueError):
        cw.window_find(p, ln[:3], words, masks, lens)
    with pytest.raises(ValueError, match="cap"):
        cw.window_find(p, ln, words, masks, lens, cap=-1)
    size = ctypes.c_longlong()
    cw.FIND_LIBRARY.call("msm_window_find_scratch", 8, 64, ctypes.byref(size))
    assert size.value == 3  # the ticket, M and one tile's flag
    scratch = torch.full((size.value,), -1, dtype=torch.int64, device=cuda_device)
    out = torch.zeros((4, 3), dtype=torch.int64, device=cuda_device)
    # The C entry point clears its scratch, counts past cap and writes
    # nothing there.
    cw.FIND_LIBRARY.call("msm_window_find", p.data_ptr(), ln.data_ptr(), words.data_ptr(),
                         masks.data_ptr(), lens.data_ptr(), out.data_ptr(), 0,
                         scratch.data_ptr(), 8, 64, words.shape[0], words.shape[1], 0,
                         torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert int(scratch[1]) == int(window_count(words, masks, lens, p, ln).sum()) > 4
    assert not out.any()
    for bad in ((None, 8, 64), (scratch.data_ptr(), 1 << 16, 1 << 15)):
        with pytest.raises(RuntimeError, match="launch failed"):
            cw.FIND_LIBRARY.call("msm_window_find", p.data_ptr(), ln.data_ptr(),
                                 words.data_ptr(), masks.data_ptr(), lens.data_ptr(),
                                 out.data_ptr(), 0, bad[0], bad[1], bad[2], words.shape[0],
                                 words.shape[1], 0, torch.cuda.current_stream().cuda_stream)


@pytest.mark.parametrize("L", [1, 2, 3, 5, 7, 8])
def test_window_find_narrow_rows(cuda_device, L):
    """Rows narrower than a lane's 4 positions and a window: every position
    takes the full probe, over many tiles."""
    pats = [b"a", b"ab", b"\x00", b"a\x00", b"ba", b"\x00\x00a"]
    rng = np.random.default_rng(200 + L)
    n = 3 * 16384 // L + 7
    payloads = rng.choice(np.frombuffer(b"ab\x00", np.uint8), size=(n, L)).astype(np.uint8)
    lengths = rng.integers(-1, L + 4, size=n).astype(np.int32)
    p, ln = torch.from_numpy(payloads).to(cuda_device), torch.from_numpy(lengths).to(cuda_device)
    words, masks, lens = WindowProgram.build(pats).tables(cuda_device)
    want = window_find_plain(words, masks, lens, p, ln)
    got = cw.window_find(p, ln, words, masks, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and want.shape[0] > n // 4


def _find_trap(name):
    """(patterns, payloads, lengths) of the ordered kernel's traps at sizes
    that cross its 16,384-position tiles and turn its 3-stage ring."""
    rng = np.random.default_rng(sum(name.encode()))
    nul = [b"\x00", b"A\x00", b"\x00\x00", b"AA\x00\x00", b"A\x00\x00\x00\x00"]
    if name == "dense-A":  # up to 3 + 5 patterns at every position
        p = np.full((700, 131), ord("A"), np.uint8)
        p[::3, 100:] = 0
        return [b"A", b"AA", b"AAA"] + nul, p, rng.integers(0, 140, 700).astype(np.int32)
    if name == "row-boundary":  # heads at row ends, tails at the next row's start
        L = 45
        p = rng.integers(ord("a"), ord("f"), size=(3000, L)).astype(np.uint8)
        for r in range(2999):
            k = 1 + r % 3
            p[r, L - k:] = np.frombuffer(b"wxyz"[:k], np.uint8)
            p[r + 1, : 4 - k] = np.frombuffer(b"wxyz"[k:], np.uint8)
        p[::97, 10:14] = np.frombuffer(b"wxyz", np.uint8)
        return [b"wxyz", b"vwxyz1", b"z1", b"yz"], p, np.full(3000, L, np.int32)
    if name == "lengths-past-width":  # NUL-tailed patterns over zeros past L
        L = 37
        p = rng.choice(np.frombuffer(b"A\x00", np.uint8), size=(4000, L)).astype(np.uint8)
        p[:, 0] = ord("A")
        lens = rng.integers(L - 2, L + 9, size=4000).astype(np.int32)
        return nul, p, lens
    if name == "zero-length-rows":
        p = rng.choice(np.frombuffer(b"ab\x00", np.uint8), size=(2500, 77)).astype(np.uint8)
        lens = rng.integers(0, 78, 2500).astype(np.int32)
        lens[::2] = 0
        lens[1::10] = -5
        return [b"ab", b"\x00", b"b\x00a", b"abab"], p, lens
    if name == "chunks-at-one-position":  # 9,000 patterns, hits of three chunks at one start
        pats = [b"c%05d" % i for i in range(9000)] + [b"c", b"c0", b"c00", b"c000"]
        p = rng.choice(np.frombuffer(b"c0123456789", np.uint8), size=(300, 300)).astype(np.uint8)
        for r in range(300):
            p[r, r % 290 : r % 290 + 6] = np.frombuffer(b"c%05d" % (r * 29 % 9000), np.uint8)
        return pats, p, rng.integers(0, 301, 300).astype(np.int32)
    raise KeyError(name)


FIND_TRAPS = ["dense-A", "row-boundary", "lengths-past-width", "zero-length-rows",
              "chunks-at-one-position"]


@pytest.mark.parametrize("name", FIND_TRAPS)
def test_window_find_traps_equal_plain(cuda_device, name):
    """The traps of the one-pass kernel, each over many tiles, and again in
    row slices whose bases fall at unaligned addresses, and with a forced
    rerun (a first capacity of 1 row)."""
    pats, payloads, lengths = _find_trap(name)
    words, masks, lens = WindowProgram.build(pats).tables(cuda_device)
    p, ln = torch.from_numpy(payloads).to(cuda_device), torch.from_numpy(lengths).to(cuda_device)
    want = window_find_plain(words, masks, lens, p, ln)
    got = cw.window_find(p, ln, words, masks, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and want.shape[0] > 0
    assert p.numel() > 3 * 16384
    before = dict(cw.LAUNCHES)
    assert torch.equal(cw.window_find(p, ln, words, masks, lens, cap=1), want)
    assert cw.LAUNCHES["window_find"] == before["window_find"] + 1
    assert cw.LAUNCHES["window_find_rerun"] == before["window_find_rerun"] + (want.shape[0] > 1)
    for s0 in (1, 3, 7):
        s1 = s0 + payloads.shape[0] // 2
        sub = window_find_plain(words, masks, lens, p[s0:s1], ln[s0:s1])
        assert p[s0:s1].data_ptr() % 16 != 0 or payloads.shape[1] % 16 == 0
        assert torch.equal(cw.window_find(p[s0:s1], ln[s0:s1], words, masks, lens), sub)


@pytest.mark.parametrize("pats, nocase", [(load_patterns(STANDIN), False),
                                          (load_patterns(STANDIN), True),
                                          (_long_rules(700, 79), False)],
                         ids=["standin", "standin-nocase", "table-route-700"])
def test_matcher_find_matches_on_card_equals_cpu(cuda_device, monkeypatch, pats, nocase):
    """``Matcher.find_matches`` on the card runs window_find whatever the
    engine routes counts to, in row slices under the position bound."""
    from multithreading_string_matching_tpu_torch.parallel import mesh as mesh_mod

    rng = np.random.default_rng(80)
    payloads = rng.integers(0x20, 0x7F, size=(700, 300)).astype(np.uint8)
    for r in range(700):
        q = pats[r % len(pats)][:300]
        o = int(rng.integers(0, 300 - len(q) + 1))
        payloads[r, o : o + len(q)] = np.frombuffer(q, np.uint8)
    lengths = rng.integers(0, 301, size=700).astype(np.int32)
    gpu = Matcher(pats, device=cuda_device, case_insensitive=nocase)
    cpu = Matcher(pats, device="cpu", case_insensitive=nocase)
    before = cw.LAUNCHES["window_find"]
    got = gpu.find_matches(payloads, lengths)
    assert cw.LAUNCHES["window_find"] == before + 1
    want = cpu.find_matches(payloads, lengths)
    assert np.array_equal(got, want) and len(want) > 300
    assert np.array_equal(gpu.counts_from_match_rows(got), gpu.count(payloads, lengths))
    monkeypatch.setattr(mesh_mod, "SUMMARY_MAX_POSITIONS", 64 * 300 + 1)
    assert np.array_equal(gpu.find_matches(payloads, lengths), want)
    assert cw.LAUNCHES["window_find"] == before + 1 + 11  # ceil(700 / 64) slices


# -- the DFA scans (csrc/scan.cu) ------------------------------------------

from multithreading_string_matching_tpu_torch.models.aho_corasick import AhoCorasick  # noqa: E402
from multithreading_string_matching_tpu_torch.models.kmp import stack_kmp_dfas  # noqa: E402
from multithreading_string_matching_tpu_torch.ops import scan as sc  # noqa: E402

_r = np.random.default_rng(21)
# name: (patterns, seed, rows, width, alphabet)
SCAN_CASES = {
    "dups": (DUPS, 1, 64, 200, b"abc\x00"),
    "nul": (NUL, 2, 40, 61, b"ab\x00"),
    "standin": (None, 3, 300, 700, b"LinuxHTP /\x00abc"),
    "unaligned-width": (DUPS, 4, 33, 13, b"abc"),
    "many-lanes": (DUPS, 5, 5000, 24, b"abc"),
    "long-99": ([b"ab" * 49 + b"c", b"abab", b"c"], 6, 30, 400, b"abc"),
    "mixed-k": (MIXED_K, 7, 64, 300, b"abc"),
    # More than 65,536 states: an int32 table read from device memory.
    "int32-table": ([bytes(_r.integers(97, 123, size=256).tolist()) for _ in range(300)],
                    8, 64, 600, b"abcdefghijklmnopqrstuvwxyz"),
}


def _scan_case(case, dev):
    pats, seed, n, L, alphabet = SCAN_CASES[case]
    pats = load_patterns(STANDIN) if pats is None else pats
    p, l = _tile(seed, n, L, alphabet, dev, plant=pats)
    l = (l.cpu() + torch.from_numpy(np.random.default_rng(seed).integers(-8, 9, n))).int().to(dev)
    return pats, p, l


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_ac_scan_equals_plain(cuda_device, case):
    """Totals, rows and final states, from the root and from carried
    in-table states (the dead state among them), over lengths <= 0 and past
    the width, at the default segment size and at 16- and 23-byte segments
    (warm-ups across every boundary, patterns longer than a segment); states
    outside the table are refused."""
    pats, p, l = _scan_case(case, cuda_device)
    ac = AhoCorasick.build(pats)
    c_gpu = sc.CompiledAC.from_automaton(ac, cuda_device)
    c_cpu = sc.CompiledAC.from_automaton(ac, "cpu")
    assert c_gpu.table.dtype == (torch.int16 if ac.goto.shape[0] <= 65536 else torch.int32)
    rng = np.random.default_rng(1)
    init = rng.integers(0, ac.goto.shape[0], size=p.shape[0]).astype(np.int32)
    init[::7] = c_gpu.dead
    for states in (np.zeros(p.shape[0], np.int32), init):
        for per_packet in (False, True):
            for seg in (None, 16, 23):
                before = sc.LAUNCHES["ac_scan"]
                got, got_st = sc.ac_scan(c_gpu, p, l, torch.from_numpy(states).to(cuda_device),
                                         per_packet=per_packet, seg_bytes=seg)
                torch.cuda.synchronize()
                assert sc.LAUNCHES["ac_scan"] == before + 1
                want, want_st = sc.ac_scan(c_cpu, p.cpu(), l.cpu(), torch.from_numpy(states),
                                           per_packet=per_packet)
                assert torch.equal(got.cpu(), want) and torch.equal(got_st.cpu(), want_st)
    assert want.sum() > 0
    for bad in (c_gpu.dead + 1, c_gpu.dead + 8, -1, -5):
        states = init.copy()
        states[1] = bad
        before = sc.LAUNCHES["ac_scan"]
        with pytest.raises(ValueError):
            sc.ac_scan(c_gpu, p, l, torch.from_numpy(states).to(cuda_device))
        with pytest.raises(ValueError):
            sc.ac_scan_tiles(c_gpu, [(p, l)], states=[torch.from_numpy(states).to(cuda_device)])
        assert sc.LAUNCHES["ac_scan"] == before


@pytest.mark.parametrize("case", ["dups", "standin", "long-99", "int32-table"])
def test_ac_scan_tiles_equals_plain(cuda_device, case):
    """One launch over a list of tiles of several widths: totals and rows
    equal the plain version tile by tile, with and without carried
    states."""
    pats, p, l = _scan_case(case, cuda_device)
    ac = AhoCorasick.build(pats)
    c_gpu = sc.CompiledAC.from_automaton(ac, cuda_device)
    c_cpu = sc.CompiledAC.from_automaton(ac, "cpu")
    n = p.shape[0]
    cuts = [0, n // 3, n // 2, n]
    tiles = [(p[a:b, : max(1, p.shape[1] - 7 * k)].contiguous(), l[a:b].contiguous())
             for k, (a, b) in enumerate(zip(cuts[:-1], cuts[1:]))]
    rng = np.random.default_rng(2)
    states = [torch.from_numpy(rng.integers(0, c_gpu.dead + 1, t[0].shape[0]).astype(np.int32))
              for t in tiles]
    for per_packet in (False, True):
        before = sc.LAUNCHES["ac_scan"]
        got = sc.ac_scan_tiles(c_gpu, tiles, per_packet=per_packet)
        got_c, got_st = sc.ac_scan_tiles(c_gpu, tiles, per_packet=per_packet,
                                         states=[s.to(cuda_device) for s in states])
        torch.cuda.synchronize()
        assert sc.LAUNCHES["ac_scan"] == before + 2
        want = sc.ac_scan_tiles(c_cpu, [(a.cpu(), b.cpu()) for a, b in tiles],
                                per_packet=per_packet)
        want_c, want_st = sc.ac_scan_tiles(c_cpu, [(a.cpu(), b.cpu()) for a, b in tiles],
                                           per_packet=per_packet, states=states)
        assert torch.equal(got.cpu(), want) and torch.equal(got_c.cpu(), want_c)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got_st, want_st))
    assert want.sum() > 0


@pytest.mark.parametrize("case", ["dups", "nul", "standin", "long-99", "unaligned-width"])
@pytest.mark.parametrize("fill", [1, 10**6])
def test_kmp_scan_equals_plain(cuda_device, case, fill, monkeypatch):
    """The grouped kernel at as few groups as shared memory allows (fill 1)
    and at one pattern a group (fill 10^6), one tile and a tile list."""
    monkeypatch.setattr(sc, "KMP_FILL_LANES", fill)
    pats, p, l = _scan_case(case, cuda_device)
    dfas, accept = stack_kmp_dfas(pats)
    k_gpu = sc.CompiledKMP.from_numpy(dfas, accept, cuda_device)
    k_cpu = sc.CompiledKMP.from_numpy(dfas, accept)
    n = p.shape[0]
    tiles = [(p[: n // 2], l[: n // 2]), (p[n // 2:, : max(1, p.shape[1] - 5)].contiguous(),
                                          l[n // 2:])]
    for per_packet in (False, True):
        before = sc.LAUNCHES["kmp_scan"]
        got = sc.kmp_scan(k_gpu, p, l, per_packet=per_packet)
        got_t = sc.kmp_scan_tiles(k_gpu, tiles, per_packet=per_packet)
        torch.cuda.synchronize()
        assert sc.LAUNCHES["kmp_scan"] == before + 2
        want = sc.kmp_scan(k_cpu, p.cpu(), l.cpu(), per_packet=per_packet)
        want_t = sc.kmp_scan_tiles(k_cpu, [(a.cpu(), b.cpu()) for a, b in tiles],
                                   per_packet=per_packet)
        assert torch.equal(got.cpu(), want) and want.sum() > 0
        assert torch.equal(got_t.cpu(), want_t)


def test_scan_wrappers_refuse_bad_inputs(cuda_device):
    ac = AhoCorasick.build(DUPS)
    c = sc.CompiledAC.from_automaton(ac, cuda_device)
    p, l = _tile(1, 8, 32, b"ab", cuda_device)
    st = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        sc.ac_scan(sc.CompiledAC.from_automaton(ac, "cpu"), p, l, st)  # tables elsewhere
    with pytest.raises(TypeError):
        sc.ac_scan(c, p, l.long(), st)
    with pytest.raises(ValueError):
        sc.ac_scan(c, p, l, st[:4])
    with pytest.raises(ValueError):
        sc.ac_scan(c, p[:, ::2], l, st)  # not contiguous
    dfas, accept = stack_kmp_dfas(DUPS)
    with pytest.raises(ValueError):
        sc.kmp_scan(sc.CompiledKMP.from_numpy(dfas, accept), p, l)
    empty = torch.zeros((0, 32), dtype=torch.uint8, device=cuda_device)
    none = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    out, new = sc.ac_scan(c, empty, none, none)
    assert out.shape == (len(ac.unique_patterns),) and not out.any() and new.numel() == 0


@pytest.mark.parametrize("engine", ["ac", "kmp"])
def test_matcher_dfa_engines_on_card_equal_cpu(cuda_device, tmp_path, engine):
    """``Matcher(engine='ac'|'kmp', device='cuda')`` equals ``device='cpu'``:
    counts, per-packet rows, a count_pcap and carried-state chunks."""
    from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap

    pats = load_patterns(STANDIN)
    path = tmp_path / "cap.pcap"
    synth_udp_pcap(path, 600, payload_len=400, payload_len_jitter=300, patterns=pats,
                   plant_rate=0.4, seed=3)
    gpu = Matcher(pats, engine=engine, device=cuda_device)
    cpu = Matcher(pats, engine=engine, device="cpu")
    before = sc.LAUNCHES[f"{engine}_scan"]
    got = gpu.count_pcap(path)
    assert sc.LAUNCHES[f"{engine}_scan"] == before + 1  # one launch over every bucket tile
    assert np.array_equal(got, cpu.count_pcap(path)) and got.sum() > 100
    p, l = _tile(4, 200, 300, b"LinuxHTP ", "cpu", plant=pats)
    p, l = p.numpy(), l.numpy()
    assert np.array_equal(gpu.count(p, l, per_packet=True), cpu.count(p, l, per_packet=True))
    st_g, st_c = gpu.streaming_state(200), cpu.streaming_state(200)
    for c in range(0, 300, 64):
        cg, st_g = gpu.count_chunk(p[:, c:c + 64], l - c, st_g)
        cc, st_c = cpu.count_chunk(p[:, c:c + 64], l - c, st_c)
        assert np.array_equal(cg, cc)
    assert torch.equal(st_g.cpu(), st_c)
