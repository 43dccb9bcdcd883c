"""Host milliseconds per payload MB of the program's ``msm.pack`` spans
(one a feed of the packed-tile counter: case fold, row packing, writes
into the staging slot), each less the union of the ``msm.*`` spans inside
it (the stager's waits and dispatches, drains): packing's self time in the
traced window."""

from gpubench.metrics import _spans


def read(rec):
    if not _spans.traced(rec):
        return None
    return _spans.per_MB(rec, _spans.self_ms(rec, "msm.pack"))
