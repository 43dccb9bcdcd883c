"""Host milliseconds per stream MB of the program's ``msm.flow.layout``
spans (one a scan round of the flow monitor: the tails, the padded lane
buffer, the sub-lane re-layout, the fold, the stored tails), each less the
union of the ``msm.*`` spans inside it (the round's copies and launch,
drains): the round's host self time in the traced window."""

from gpubench.metrics import _spans


def read(rec):
    if not _spans.traced(rec):
        return None
    return _spans.per_MB(rec, _spans.self_ms(rec, "msm.flow.layout"))
