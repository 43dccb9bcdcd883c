"""The benchmark's plain reference: a pcap reader with the reference
program's payload rule, and exact overlapping counts in plain PyTorch.  It
imports nothing of the program under test."""

from gpubench.reference.count import count_payloads
from gpubench.reference.pcap import udp_payloads


def capture_counts(path, patterns, mode: str = "udp", device="cpu"):
    """int64 counts of ``patterns`` over the capture at ``path``, and the
    payload bytes they were counted over."""
    if mode != "udp":
        raise ValueError(f"the reference reads UDP payloads only, not {mode!r}")
    payloads = udp_payloads(path)
    return count_payloads(payloads, patterns, device=device), sum(len(p) for p in payloads)
