"""KMP failure function and per-pattern counting DFAs, built on the host.

Counterpart of ``multithreading_string_matching_tpu/models/kmp.py`` (numpy
only, equal arrays).  The reference counts overlapping occurrences with a
branchy per-byte KMP matcher (serial.c:190-238); here each pattern's LPS
table is compiled into a dense DFA ``delta: int32[m+1, 256]`` with the
failure closure folded in, so the scan is branch-free::

    state  = delta[state, byte]
    count += (state == m)

State m is "an occurrence just ended"; its row restarts at ``lps[m-1]``, so
overlapping occurrences chain exactly as the reference's matcher does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

ALPHABET = 256


def lps_table(pattern: bytes) -> np.ndarray:
    """Longest-proper-prefix-suffix table (serial.c:217-238 semantics):
    ``lps[i]`` is the length of the longest proper prefix of
    ``pattern[:i+1]`` that is also a suffix of it."""
    m = len(pattern)
    if m == 0:
        raise ValueError("empty pattern")
    lps = np.zeros(m, dtype=np.int32)
    j = 0
    for i in range(1, m):
        while j > 0 and pattern[i] != pattern[j]:
            j = int(lps[j - 1])
        if pattern[i] == pattern[j]:
            j += 1
        lps[i] = j
    return lps


def kmp_dfa(pattern: bytes) -> np.ndarray:
    """Dense counting DFA ``delta: int32[m+1, 256]`` for one pattern."""
    p = np.frombuffer(bytes(pattern), dtype=np.uint8)
    m = len(p)
    lps = lps_table(pattern)
    delta = np.zeros((m + 1, ALPHABET), dtype=np.int32)
    delta[0, p[0]] = 1
    for s in range(1, m):
        # Mismatches replicate the failure state's row; the matching byte advances.
        delta[s] = delta[lps[s - 1]]
        delta[s, p[s]] = s + 1
    # Accept state: restart from lps[m-1] (overlap-preserving).
    delta[m] = delta[lps[m - 1]]
    return delta


def stack_kmp_dfas(patterns: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pattern DFAs stacked into ``int32[P, m_max+1, 256]``, and
    ``accept: int32[P]`` (each pattern's length, its accept state).

    Rows past a shorter pattern's accept row are zeros and unreachable: the
    scan restarts at ``lps`` on accept and never enters them."""
    if not patterns:
        raise ValueError("no patterns")
    dfas = [kmp_dfa(p) for p in patterns]
    m_max = max(len(p) for p in patterns)
    out = np.zeros((len(patterns), m_max + 1, ALPHABET), dtype=np.int32)
    accept = np.zeros(len(patterns), dtype=np.int32)
    for i, (p, d) in enumerate(zip(patterns, dfas)):
        out[i, : d.shape[0]] = d
        accept[i] = len(p)
    return out, accept


def count_occurrences_host(text: bytes, pattern: bytes) -> int:
    """Host-side overlapping-occurrence count: the positions where
    ``pattern`` ends inside ``text`` (BASELINE.md variant A)."""
    if len(text) < len(pattern):
        return 0
    count = 0
    start = 0
    while True:
        idx = text.find(pattern, start)
        if idx < 0:
            return count
        count += 1
        start = idx + 1
