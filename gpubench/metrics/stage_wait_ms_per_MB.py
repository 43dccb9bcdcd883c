"""Host milliseconds per payload MB in the program's ``msm.stage.wait``
spans (the host blocked until a staging slot's last copy left it), summed
over the traced window."""

from gpubench.metrics import _spans


def read(rec):
    if not _spans.traced(rec):
        return None
    return _spans.per_MB(rec, _spans.summed_ms(rec, "msm.stage.wait"))
