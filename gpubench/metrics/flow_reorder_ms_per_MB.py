"""Host milliseconds per stream MB of the program's ``msm.flow.reorder``
spans (one a scan round of the sequence-order flow monitor: each flow's
held segments put in sequence order, trimmed of bytes already given and
joined), each less the union of the ``msm.*`` spans inside it: the
reordering's self time in the traced window.  A program that opens no such
span has nothing here to read."""

from gpubench.metrics import _spans


def read(rec):
    if not _spans.traced(rec) or not _spans.clipped(rec, "msm.flow.reorder"):
        return None
    return _spans.per_MB(rec, _spans.self_ms(rec, "msm.flow.reorder"))
