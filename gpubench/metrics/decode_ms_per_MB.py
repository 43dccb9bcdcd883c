"""Host milliseconds per payload MB in the program's ``msm.decode``
spans (one a batch: the header decode and payload gather on
the streamed path), summed over the traced window."""

from gpubench.metrics import _spans


def read(rec):
    if not _spans.traced(rec):
        return None
    return _spans.per_MB(rec, _spans.summed_ms(rec, "msm.decode"))
