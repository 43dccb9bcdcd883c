"""Per cent of the traced window in which no kernel, copy or fill ran on
the card: 100 x (1 - union of their intervals / window)."""

from gpubench import trace


def read(rec):
    return trace.idle_share_pct(rec)
