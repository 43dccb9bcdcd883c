"""Self time of the program's spans where a traced pass holds tens of
thousands of them (the live sensor opens a feed's spans for every 10
frames): the same number as ``_spans.self_ms``, with each span's children
found by a search over the spans sorted by start instead of a scan of every
host record, so that a reader takes a fraction of a second there and not
minutes."""

import bisect

from gpubench import trace
from gpubench.metrics import _spans


def self_ms(rec, name) -> float:
    """Milliseconds of the window inside spans called ``name`` less, for
    each, the union of the other ``msm.*`` spans that lie inside it."""
    if not rec.get("window_us"):
        return 0.0
    w0, w1 = rec["window_us"]
    spans = sorted((a, b, i, n) for i, (n, a, b) in enumerate(rec["host"])
                   if n.startswith(_spans.PREFIX))
    starts = [s[0] for s in spans]
    total = 0.0
    for a, b, i, n in spans:
        lo, hi = max(a, w0), min(b, w1)
        if n != name or hi <= lo:
            continue
        first, last = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        kids = [(c, d) for c, d, j, _ in spans[first:last] if j != i and d <= b]
        total += (hi - lo) - sum(d - c for c, d in trace.merged(kids, lo, hi))
    return total / 1e3
