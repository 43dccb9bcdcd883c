"""Pure-Python counting oracle for the soak tools.

The counting part of the repository's executable spec of the reference's
semantics (variant A of BASELINE.md), kept apart from every table builder
and kernel of the package: straightforward ``bytes.find`` loops over each
text, so the soak tools compare the kernels with code that shares nothing
with them but the spec.

- :func:`count_overlapping`: the positions where a pattern ends inside a
  text, overlapping occurrences included;
- :func:`oracle_counts`: those counts summed over texts, per pattern;
- :func:`oracle_matrix`: the same per text (a per-packet matrix);
- :func:`match_positions`: every ``(text, start, pattern)`` triple, sorted,
  the ``find_matches`` contract.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def starts(text: bytes, pattern: bytes) -> List[int]:
    """Every start of ``pattern`` in ``text``, overlapping ones included."""
    out = []
    if not pattern or len(text) < len(pattern):
        return out
    i = text.find(pattern)
    while i >= 0:
        out.append(i)
        i = text.find(pattern, i + 1)
    return out


def count_overlapping(text: bytes, pattern: bytes) -> int:
    """Number of positions where ``pattern`` ends in ``text`` (overlaps
    counted)."""
    return len(starts(text, pattern))


def oracle_counts(texts: Sequence[bytes], patterns: Sequence[bytes]) -> List[int]:
    """Per pattern, its occurrences summed over ``texts``."""
    return [sum(count_overlapping(t, p) for t in texts) for p in patterns]


def oracle_matrix(texts: Sequence[bytes], patterns: Sequence[bytes]) -> List[List[int]]:
    """``[text][pattern]`` occurrence counts."""
    return [[count_overlapping(t, p) for p in patterns] for t in texts]


def match_positions(texts: Sequence[bytes], patterns: Sequence[bytes]
                    ) -> List[Tuple[int, int, int]]:
    """Every ``(text, start, pattern)`` triple, sorted by text, start, then
    pattern index."""
    rows = [(n, i, u) for n, t in enumerate(texts) for u, p in enumerate(patterns)
            for i in starts(t, p)]
    rows.sort()
    return rows
