"""Every engine of the torch ``Matcher`` on the six adversarial corners of
the JAX package's engine fuzz test (``tests/test_fuzz_engines.py``), on
the CPU: binary payloads with embedded NULs, zero-length rows, payloads
shorter, equal or longer than the patterns, duplicate and overlapping
patterns, single-byte patterns, NUL patterns (the exact-fit path) and a
60-byte pattern.

Each (case, engine) is its own test.  Totals and per-packet matrices are
held to ``tests/oracle.py`` and to the JAX ``Matcher`` on the same numpy
inputs, and ``find_matches`` triples to the JAX package's; integers, so
every comparison is exact (tolerance 0).
"""

import functools

import numpy as np
import pytest
import torch

import oracle
from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu_torch.api import ENGINES, Matcher

torch.set_num_threads(1)

# The tuples of tests/test_fuzz_engines.py's CASES:
# (seed, num_payloads, max_len, alphabet, patterns)
CASES = [
    (0, 17, 40, 4, [b"ab", b"aba", b"b", b"abab", b"ab", b"\x00a", b"ba"]),
    (1, 9, 200, 3, [b"aa", b"aaa", b"aaaa", b"a"]),          # heavy overlap
    (2, 33, 64, 256, [b"\x00", b"\xff\xfe", b"ab\x00cd"]),    # binary + NUL
    (3, 5, 13, 2, [b"abcdefghijkl", b"ab", b"ba", b"ab"]),    # pattern ~= payload len
    (4, 64, 128, 5, [bytes([a, b]) for a in range(3) for b in range(3)]),
    (5, 12, 256, 7, [bytes(range(1, 61)), b"\x01\x02", bytes(range(1, 61))]),  # K = 15
]


def _inputs(seed, n, lmax, alpha, pats):
    """The JAX test's inputs: an empty row, a full-width row, a planted hit
    of the first pattern."""
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, alpha, size=(n, lmax)).astype(np.uint8)
    lengths = rng.integers(0, lmax + 1, size=n).astype(np.int32)
    lengths[0] = 0
    lengths[-1] = lmax
    if len(pats[0]) <= lmax:
        payloads[-1, : len(pats[0])] = np.frombuffer(pats[0], np.uint8)
    return payloads, lengths


@functools.lru_cache(maxsize=None)
def _reference(case: int):
    """``(payloads, lengths, oracle totals, oracle matrix, JAX totals, JAX
    matrix, JAX find_matches triples)`` of one case, computed once."""
    seed, n, lmax, alpha, pats = CASES[case]
    payloads, lengths = _inputs(seed, n, lmax, alpha, pats)
    texts = [payloads[i, : lengths[i]].tobytes() for i in range(n)]
    jm = JaxMatcher(pats)
    return (
        payloads, lengths,
        np.array(oracle.oracle_counts(texts, pats)),
        np.array([oracle.oracle_counts([t], pats) for t in texts]),
        np.asarray(jm.count(payloads, lengths, engine="window")),
        np.asarray(jm.count(payloads, lengths, engine="window", per_packet=True)),
        np.asarray(jm.find_matches(payloads, lengths)),
    )


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"case{c[0]}" for c in CASES])
def test_engine_matches_oracle_and_jax(case, engine):
    payloads, lengths, want, want_pp, jax_totals, jax_pp, jax_rows = _reference(case)
    pats = CASES[case][4]
    assert np.array_equal(jax_totals, want) and np.array_equal(jax_pp, want_pp)
    assert want.sum() > 0  # the planted hit: no case passes vacuously

    m = Matcher(pats, device="cpu")
    got = m.count(payloads, lengths, engine=engine)
    assert got.dtype == np.int32 and np.array_equal(got, want), engine
    got_pp = m.count(payloads, lengths, engine=engine, per_packet=True)
    assert np.array_equal(got_pp, want_pp), f"{engine} per-packet"

    # The staged-tile path on deliberately dirty rows: prepare() must zero
    # every byte past a row's length.
    dirty = payloads.copy()
    dirty[np.arange(payloads.shape[1])[None, :] >= lengths[:, None]] = 0xEE
    assert np.array_equal(m.count(dirty, lengths, engine=engine), want), f"{engine} dirty rows"

    rows = m.find_matches(payloads, lengths)
    assert rows.dtype == np.int64 and np.array_equal(rows, jax_rows)
    assert np.array_equal(m.counts_from_match_rows(rows), want)
