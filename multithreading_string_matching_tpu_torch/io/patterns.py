"""Pattern-file loading: the ``fscanf(fp, "%s", str)`` token contract.

Counterpart of ``multithreading_string_matching_tpu/io/patterns.py``.  Tokens
are maximal runs of non-whitespace bytes in file order, duplicates kept
(every entry reports independently); patterns are ``bytes``.
"""

from __future__ import annotations

import os
from typing import List, Union

# The reference reads each token into a 100-byte buffer: longer tokens are
# an error rather than reproduced undefined behaviour.
MAX_PATTERN_LEN = 99


def split_c_tokens(data: bytes) -> List[bytes]:
    """Split raw bytes exactly as a ``fscanf("%s")`` loop would."""
    return bytes(data).split()  # no separator == runs of C whitespace


def unescape_token(tok: bytes) -> bytes:
    """Decode ``\\xNN`` hex escapes (and ``\\\\``) in one pattern token, so a
    pattern file can name whitespace and NUL bytes."""
    if b"\\" not in tok:
        return tok
    out = bytearray()
    i, n = 0, len(tok)
    while i < n:
        b = tok[i]
        if b != 0x5C:  # '\'
            out.append(b)
            i += 1
            continue
        nxt = tok[i + 1 : i + 2]
        if nxt == b"\\":
            out.append(0x5C)
            i += 2
        elif nxt == b"x" and i + 4 <= n:
            hexpair = tok[i + 2 : i + 4]
            # int(.., 16) alone would accept a sign character.
            if not all(c in b"0123456789abcdefABCDEF" for c in hexpair):
                raise ValueError(
                    f"bad \\x escape in pattern token {tok[:20]!r}"
                )
            out.append(int(hexpair, 16))
            i += 4
        else:
            raise ValueError(
                f"bad escape in pattern token {tok[:20]!r} "
                "(only \\xNN and \\\\ are recognized)"
            )
    return bytes(out)


def load_patterns(
    path: Union[str, os.PathLike], *, syntax: str = "plain"
) -> List[bytes]:
    """Read a strings.txt-style pattern file into an ordered list of bytes.

    ``syntax="escaped"`` also decodes ``\\xNN`` / ``\\\\`` per token.
    """
    if syntax not in ("plain", "escaped"):
        raise ValueError(f"unknown pattern syntax {syntax!r}")
    with open(path, "rb") as f:
        data = f.read()
    patterns = split_c_tokens(data)
    if syntax == "escaped":
        patterns = [unescape_token(p) for p in patterns]
    for p in patterns:
        if len(p) > MAX_PATTERN_LEN:
            raise ValueError(
                f"pattern {p[:20]!r}... is {len(p)} bytes; the reference's "
                f"fixed 100-byte token buffer caps patterns at {MAX_PATTERN_LEN}"
            )
        if not p:
            raise ValueError("empty pattern")
    if not patterns:
        raise ValueError(f"no patterns found in {path!r}")
    return patterns
