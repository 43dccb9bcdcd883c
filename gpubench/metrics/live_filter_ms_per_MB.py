"""Host milliseconds per payload MB in the program's ``msm.live.filter``
spans (one a batch: the live stream's capture filter, which frames are
the protocol), summed over the traced window.  A program without the span
has nothing here to read."""

from gpubench.metrics import _spans


def read(rec):
    if not _spans.traced(rec) or not _spans.clipped(rec, "msm.live.filter"):
        return None
    return _spans.per_MB(rec, _spans.summed_ms(rec, "msm.live.filter"))
