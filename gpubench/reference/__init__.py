"""The benchmark's plain references.  A configuration names the module
(``gpubench/reference/<name>.py``, found by the registry) whose counts hold
its guarantees; the modules share the parts exported here: a pcap reader
with the reference program's payload rule, and exact overlapping counts in
plain PyTorch.  Nothing here imports the program under test."""

from gpubench.reference.count import count_payloads
from gpubench.reference.pcap import udp_payloads

__all__ = ["count_payloads", "udp_payloads"]
