"""The torch package's large-set kernels' host side and plain versions
against the JAX package: filter words, the word-count partition, and the
tile-count surface of ``CudaTableMatcher(device="cpu")`` (whose wrappers
take the plain table and filter versions on CPU tensors) against
``PallasTableMatcher`` in interpret mode, as tests/test_pallas_table.py and
tests/test_pallas_filter.py run it, and against the JAX window engine.

Counts are integers: every comparison is exact (tolerance 0).  The CUDA
kernels themselves need a card: tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.ops.pallas_table import PallasTableMatcher, _filter_words
from multithreading_string_matching_tpu.ops.pallas_window import PallasWindowMatcher
from multithreading_string_matching_tpu.ops.window import WindowProgram as JaxProgram
from multithreading_string_matching_tpu.ops.window import count_matches_window as jax_count
from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
from multithreading_string_matching_tpu_torch.ops.cuda_window import CudaWindowMatcher
from multithreading_string_matching_tpu_torch.ops.table import (
    filter_count,
    filter_offsets,
    filter_words,
    partition,
    table_count,
)
from multithreading_string_matching_tpu_torch.ops.window import WindowProgram

torch.set_num_threads(1)

# Mixed word counts, duplicates, shared prefixes and a NUL pattern.
MIXED = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"abcdefgh", b"abcde",
         b"bbbbabcdea", b"a", b"caca", b"a\x00b"]
_rng = np.random.default_rng(26)
RANDOM200 = [bytes(_rng.integers(1, 5, size=_rng.integers(1, 13)).tolist()) for _ in range(200)]
SETS = {
    "mixed": MIXED,
    "shared-prefix": [b"pt00%04d" % i for i in range(8)] + [b"pt00"],
    "nul": [b"a\x00b", b"\x00\x00", b"ab", b"\x00", b"b\x00", b"\x00\x00\x00\x00\x00"],
    "repeated-word": [b"abcdabcd", b"abcdabcdab", b"xyzw", b"abcd"],
    "random200": RANDOM200,
    "rs300": [b"rs%06d" % i for i in range(300)],
}


def _tile(seed, n, L, alphabet=b"abc\x00"):
    """Random bytes everywhere (rows are NOT zero past their length)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    payloads = letters[rng.integers(0, len(letters), size=(n, L))]
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    if n:
        lengths[0] = 0
    return payloads, lengths


def _planted(seed, pats, n, L, alphabet):
    """Rows rich in occurrences of ``pats``, some flush against the row end."""
    payloads, lengths = _tile(seed, n, L, alphabet)
    rng = np.random.default_rng(seed + 1)
    for r in range(n):
        p = pats[int(rng.integers(0, len(pats)))]
        if len(p) <= L:
            o = L - len(p) if r % 3 == 0 else int(rng.integers(0, L - len(p) + 1))
            payloads[r, o:o + len(p)] = np.frombuffer(p, np.uint8)
        lengths[r] = L if r % 2 else lengths[r]
    return payloads, lengths


# name: (pattern set, tile)
CASES = {
    "mixed-128": ("mixed", lambda: _tile(1, 16, 128)),
    "mixed-width-13": ("mixed", lambda: _tile(2, 7, 13)),
    "mixed-width-100": ("mixed", lambda: _tile(3, 5, 100)),
    "mixed-zero-rows": ("mixed", lambda: _tile(4, 0, 32)),
    "mixed-zero-width": ("mixed", lambda: _tile(5, 4, 0)),
    "shared-prefix": ("shared-prefix", lambda: _planted(6, SETS["shared-prefix"], 12, 40, b"pt0123")),
    "nul": ("nul", lambda: _tile(7, 12, 61, b"ab\x00")),
    "repeated-word": ("repeated-word", lambda: _planted(8, SETS["repeated-word"], 10, 48, b"abcdxyzw")),
    "random200": ("random200", lambda: _tile(9, 16, 128, bytes(range(1, 5)))),
    "rs300": ("rs300", lambda: _planted(10, SETS["rs300"], 24, 64, b"rs0123")),
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_filter_words_equal_jax(name):
    fw, fm = filter_words(WindowProgram.build(SETS[name]))
    jw, jm = _filter_words(JaxProgram.build(SETS[name]))
    assert fw.dtype == fm.dtype == np.uint32
    assert np.array_equal(fw, jw) and np.array_equal(fm, jm)


@pytest.mark.parametrize("zero_padded", [False, True])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("name", sorted(SETS))
def test_partition_equals_jax(name, filtered, zero_padded):
    classes, inv, use_fit = partition(WindowProgram.build(SETS[name]), filtered, zero_padded)
    jclasses, jinv, juse_fit = PallasTableMatcher._partition(
        JaxProgram.build(SETS[name]), 4, 16, filtered, zero_padded
    )
    assert use_fit == juse_fit
    assert np.array_equal(inv, np.asarray(jinv))
    assert [(c.K, c.num) for c in classes] == [(c.K, c.num) for c in jclasses]
    for c, j in zip(classes, jclasses):
        assert c.words.shape == (c.num, c.K + int(filtered))
        assert np.array_equal(c.words, j.words[: j.num])
        assert np.array_equal(c.masks, j.masks[: j.num])
        assert np.array_equal(c.lens, j.lens[: j.num, 0])


@pytest.mark.parametrize("name", sorted(SETS))
def test_filter_offsets_point_at_the_filter_word(name):
    for c in partition(WindowProgram.build(SETS[name]), True)[0]:
        w, m = (torch.from_numpy(a.astype(np.int64)) for a in (c.words, c.masks))
        off = filter_offsets(w, m, c.K).numpy()
        assert ((off % 4 == 0) & (off >= 0) & (off < 4 * c.K)).all()
        k = off // 4
        rows = np.arange(c.num)
        assert np.array_equal(c.words[rows, k], c.words[:, c.K])
        assert np.array_equal(c.masks[rows, k], c.masks[:, c.K])


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_table_matcher_equals_jax_window(case, filtered):
    """Totals and per-row counts of the plain table/filter versions, across
    every class, equal the JAX window engine's."""
    name, make = CASES[case]
    pats = SETS[name]
    payloads, lengths = make()
    m = ct.CudaTableMatcher(WindowProgram.build(pats), "cpu", filtered=filtered)
    ref = JaxProgram.build(pats)
    for expand in (False, True):
        want = np.asarray(jax_count(ref, payloads, lengths, expand_duplicates=expand))
        got = m.count_tiles([(payloads, lengths)], expand_duplicates=expand).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want)
    want_rows = np.asarray(jax_count(ref, payloads, lengths, per_packet=True, expand_duplicates=False))
    (rows,) = m.count_tiles_per_row([(payloads, lengths)], expand_duplicates=False)
    assert np.array_equal(rows.numpy(), want_rows)


@pytest.mark.parametrize("filtered", [False, True])
def test_surface_equals_pallas_table_interpret(filtered):
    """Totals, per-row counts, repeats (reps x totals) and the summary equal
    PallasTableMatcher in interpret mode on rows not zero-filled."""
    pats = [b"ab", b"abab", b"abcdefgh", b"ca", b"caca", b"a\x00b", b"bcab", b"abcab", b"ab"]
    payloads, lengths = _tile(11, 8, 128)
    tiles = [(payloads, lengths)]
    jm = PallasTableMatcher(JaxProgram.build(pats), row_tile=8, interpret=True,
                            pattern_block=4, filtered=filtered)
    m = ct.CudaTableMatcher(WindowProgram.build(pats), "cpu", filtered=filtered)
    totals = m.count_tiles(tiles).numpy()
    assert totals.sum() > 0
    assert np.array_equal(totals, np.asarray(jm.count_tiles(tiles)))
    (rows,) = m.count_tiles_per_row(tiles)
    assert np.array_equal(rows.numpy(), np.asarray(jm.count_tiles_per_row(tiles)[0])[:8])
    rep = m.count_tiles_repeated(tiles, 3).numpy()
    assert np.array_equal(rep, np.asarray(jm.count_tiles_repeated(tiles, 3)))
    assert np.array_equal(rep, 3 * m.count_tiles(tiles, expand_duplicates=False).numpy())
    tot, hits = m.count_tile_summary(payloads, lengths)
    jtot, jhits = jm.count_tile_summary(payloads, lengths)
    assert np.array_equal(tot.numpy(), np.asarray(jtot))
    assert np.array_equal(hits.numpy(), np.asarray(jhits)[:8])


def test_window_repeats_equal_pallas_window_interpret():
    pats = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"abcdefgh", b"abcde"]
    payloads, lengths = _tile(12, 8, 128)
    tiles = [(payloads, lengths), (payloads[:5, :100], np.minimum(lengths[:5], 100))]
    pwm = PallasWindowMatcher(JaxProgram.build(pats), row_tile=8, interpret=True)
    m = CudaWindowMatcher(WindowProgram.build(pats), "cpu")
    got = m.count_tiles_repeated(tiles, 3).numpy()
    assert got.dtype == np.int32 and got.sum() > 0
    assert np.array_equal(got, np.asarray(pwm.count_tiles_repeated(tiles, 3)))
    assert np.array_equal(got, 3 * m.count_tiles(tiles, expand_duplicates=False).numpy())
    assert not m.count_tiles_repeated([], 3).any()


def test_filter_false_positive_verifies_to_zero():
    """The filter word present without the pattern counts nothing; the real
    match (flush against the row end) counts once."""
    pats = [b"abcdwxyz"]
    c = partition(WindowProgram.build(pats), True)[0][0]
    assert c.words[0, 2] == np.frombuffer(b"wxyz", np.uint32)[0]
    pay = np.zeros((3, 64), np.uint8)
    pay[0, 10:14] = np.frombuffer(b"wxyz", np.uint8)
    pay[1, 56:64] = np.frombuffer(b"abcdwxyz", np.uint8)
    pay[2, 0:4] = np.frombuffer(b"abcd", np.uint8)
    lens = np.full(3, 64, np.int32)
    tabs = c.tables("cpu")
    p, ln = torch.from_numpy(pay), torch.from_numpy(lens)
    assert filter_count(*tabs, p, ln, c.K).tolist() == [1]
    assert filter_count(*tabs, p, ln, c.K, per_row=True).tolist() == [[0], [1], [0]]
    assert table_count(*tabs, p, ln, c.K).tolist() == [1]


def test_wrappers_route_cpu_tensors_to_plain():
    cls = partition(WindowProgram.build(MIXED), True)[0]
    payloads, lengths = _tile(13, 9, 70)
    p, ln = torch.from_numpy(payloads), torch.from_numpy(lengths)
    before = dict(ct.LAUNCHES)
    for c in cls:
        tabs = c.tables("cpu")
        plain = table_count(*tabs, p, ln, c.K)
        assert np.array_equal(filter_count(*tabs, p, ln, c.K), plain)
        for fn in (ct.table_count_totals, ct.filter_count_totals):
            assert torch.equal(fn(p, ln, *tabs, c.K), plain)
            assert torch.equal(fn(p, ln, *tabs, c.K, reps=4), 4 * plain)
        rows = table_count(*tabs, p, ln, c.K, per_row=True)
        for fn in (ct.table_count_rows, ct.filter_count_rows):
            assert torch.equal(fn(p, ln, *tabs, c.K), rows)
    assert ct.LAUNCHES == before  # the plain version is not a launch
    meta = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no table-count kernel"):
        ct.table_count_totals(meta, torch.zeros(2, dtype=torch.int32), *cls[0].tables("cpu"), 1)
