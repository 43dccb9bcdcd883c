"""``pack_ms_per_MB`` in the live sensor's cell: host milliseconds per
payload MB of the program's ``msm.pack`` spans (one a feed of the
packed-tile counter, here one a 10-frame batch), each less the union of
the ``msm.*`` spans inside it: packing's self time in the traced window.
The number ``pack_ms_per_MB.py`` gives, computed by ``_nested.self_ms``,
which reads a pass of 10,000 feeds in a fraction of a second."""

from gpubench.metrics import _nested, _spans


def read(rec):
    if not _spans.traced(rec):
        return None
    return _spans.per_MB(rec, _nested.self_ms(rec, "msm.pack"))
