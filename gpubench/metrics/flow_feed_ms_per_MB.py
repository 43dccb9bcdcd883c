"""Host milliseconds per stream MB of the program's ``msm.flow.feed`` spans
(one a chunk fed to the flow monitor: the segment parse, the flow keys,
each segment appended to its flow's pending bytes), each less the union of
the ``msm.*`` spans inside it (the rounds a feed fires, their dispatches
and drains): the feed's self time in the traced window."""

from gpubench.metrics import _spans


def read(rec):
    if not _spans.traced(rec):
        return None
    return _spans.per_MB(rec, _spans.self_ms(rec, "msm.flow.feed"))
