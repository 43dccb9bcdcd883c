"""Host milliseconds per payload MB of the program's ``msm.live.feed``
spans (one a batch fed to the live stream: the decode, the capture
filter, the dump bookkeeping, the rows handed to the packed tiles), each
less the union of the ``msm.*`` spans inside it (the decode, the filter,
packing and the stager's waits and dispatches, drains): the feed's self
time in the traced window (``_nested.self_ms``).  A program without the
span has nothing here to read."""

from gpubench.metrics import _nested, _spans


def read(rec):
    if not _spans.traced(rec) or not _spans.clipped(rec, "msm.live.feed"):
        return None
    return _spans.per_MB(rec, _nested.self_ms(rec, "msm.live.feed"))
