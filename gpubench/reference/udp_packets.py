"""The ``udp_packets`` reference, the default of a configuration: the
reference program's UDP payload rule (``gpubench/reference/pcap.py``), one
packet at a time, and exact overlapping counts over those payloads
(``gpubench/reference/count.py``).  No match spans two packets."""

from gpubench.reference.count import count_payloads
from gpubench.reference.pcap import udp_payloads


def capture_counts(path, patterns, mode: str = "udp", device="cpu"):
    """int64 counts of ``patterns`` over the capture at ``path``, and the
    payload bytes they were counted over."""
    if mode != "udp":
        raise ValueError(f"the reference reads UDP payloads only, not {mode!r}")
    payloads = udp_payloads(path)
    return count_payloads(payloads, patterns, device=device), sum(len(p) for p in payloads)
