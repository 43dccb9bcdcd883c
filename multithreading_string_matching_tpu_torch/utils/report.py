"""Result reporting (component C15); counterpart of
``multithreading_string_matching_tpu/utils/report.py``, byte for byte.

Compat mode reproduces the reference output byte-for-byte so conformance can
be checked with a plain diff: a banner line, then one
``"<pattern>: <count> times!"`` line per NONZERO pattern in file order
(duplicates each get their own line), then the elapsed-time line
(serial.c:163-169 and its copies; live adds a sniffed-packets line and an
"Oops!" line when nothing matched, live_openmp_task.c:228-241).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

BANNER = "Printing the number of appereances of each string throughout the entire pcap file:"
OOPS = "Oops! We have not found any matches"


def format_report(
    patterns: Sequence[bytes],
    counts: np.ndarray,
    elapsed: Optional[float] = None,
    *,
    sniffed: Optional[int] = None,
    oops_line: bool = False,
) -> str:
    counts = np.asarray(counts)
    if counts.ndim != 1:
        raise ValueError(
            f"format_report needs per-pattern [P] counts, got shape "
            f"{counts.shape} (per-packet matrices belong in --json output)"
        )
    lines = []
    if sniffed is not None:
        # live_openmp_task.c:229 prints `"\n\n%d packet sniffed\n\n"` (sic —
        # no plural s) immediately before the banner; reproduce the exact
        # byte stream, blank lines included.
        lines.extend(["", "", f"{sniffed} packet sniffed", ""])
    lines.append(BANNER)
    any_nonzero = False
    for p, c in zip(patterns, np.asarray(counts).tolist()):
        if c != 0:
            any_nonzero = True
            lines.append(f"{p.decode('latin-1')}: {c} times!")
    if oops_line and not any_nonzero:
        lines.append(OOPS)  # live_openmp_task.c:240-241
    if elapsed is not None:
        lines.append(f"Elapsed time = {elapsed:f} seconds")
    return "\n".join(lines)
