"""Staging allocations a traced pass: the program's ``msm.stage.alloc``
spans in the traced window (pinned host slots and their device twins
built or grown) over the passes traced."""

from gpubench.metrics import _spans


def read(rec):
    if not _spans.traced(rec) or not rec.get("passes"):
        return None
    return len(_spans.clipped(rec, "msm.stage.alloc")) / rec["passes"]
