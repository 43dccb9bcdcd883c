"""The ``udp`` capture generator, the default of a traffic mix's ``capture``:
Ethernet/IPv4/UDP frames one payload each, written by
``gpubench/gen/synth.synth_udp_pcap`` from the mix's ``packets``,
``payload_len`` and the optional parameters below.  Its payload bytes are
the valid UDP payload bytes of the capture."""

from __future__ import annotations

from typing import List, Optional

from gpubench.gen.synth import synth_udp_pcap

KEYS = ("payload_len_jitter", "content", "lead_nul", "plant_rate", "ihl6_rate")


def write(path, capture: dict, patterns: List[bytes], weights: Optional[List[float]],
          seed: int) -> int:
    kw = {k: capture[k] for k in KEYS if k in capture}
    return synth_udp_pcap(path, int(capture["packets"]), payload_len=int(capture["payload_len"]),
                          patterns=patterns, plant_weights=weights, seed=seed, **kw)
