"""Synthetic corpus generation: seeded classic-pcap captures.

Counterpart of ``multithreading_string_matching_tpu/io/synth.py``'s
``synth_udp_pcap``: the same seed writes the same bytes, so a capture made
by either package feeds both.  Packets exercise the decode paths (IHL 5 and
6, runts, non-UDP protocols) and payloads carry planted pattern occurrences
at a controlled rate.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np


def synth_udp_pcap(
    path,
    num_packets: int,
    *,
    payload_len: int = 1024,
    payload_len_jitter: int = 0,
    patterns: Optional[Sequence[bytes]] = None,
    plant_rate: float = 0.01,
    invalid_rate: float = 0.0,
    seed: int = 0,
) -> int:
    """Write a synthetic Ethernet/IPv4/UDP capture; returns total payload bytes.

    ``plant_rate``: fraction of packets that get one pattern planted at a
    random offset.  ``invalid_rate``: fraction of packets made undecodable
    (runts / wrong protocol).
    """
    from multithreading_string_matching_tpu_torch.io.pcap import classic_global_header

    rng = np.random.default_rng(seed)
    total_payload = 0
    with open(path, "wb") as f:
        f.write(classic_global_header())
        for i in range(num_packets):
            r = rng.random()
            if r < invalid_rate:
                kind = rng.integers(0, 2)
                pkt = (
                    bytes(rng.integers(0, 256, size=10, dtype=np.uint8))  # runt
                    if kind == 0
                    else _eth_ipv4(b"x" * 20, proto=6)  # TCP proto in udp mode
                )
            else:
                ln = payload_len
                if payload_len_jitter:
                    ln = int(rng.integers(max(0, payload_len - payload_len_jitter),
                                          payload_len + payload_len_jitter + 1))
                payload = rng.integers(0, 256, size=ln, dtype=np.uint8)
                if patterns is not None and rng.random() < plant_rate and ln > 0:
                    p = patterns[int(rng.integers(0, len(patterns)))]
                    if len(p) <= ln:
                        off = int(rng.integers(0, ln - len(p) + 1))
                        payload[off : off + len(p)] = np.frombuffer(p, np.uint8)
                # ~10% of packets carry IP options (ihl=6).
                ihl = 6 if rng.random() < 0.1 else 5
                pkt = _eth_ipv4(payload.tobytes(), proto=17, ihl=ihl)
                total_payload += ln
            f.write(struct.pack("<IIII", i, 0, len(pkt), len(pkt)))
            f.write(pkt)
    return total_payload


def _eth_ipv4(payload: bytes, proto: int = 17, ihl: int = 5) -> bytes:
    ip = bytearray(ihl * 4)
    ip[0] = (4 << 4) | ihl
    ip[9] = proto
    total = ihl * 4 + 8 + len(payload)
    ip[2:4] = total.to_bytes(2, "big")
    udp = struct.pack(">HHHH", 1234, 5678, 8 + len(payload), 0)
    return b"\x00" * 12 + b"\x08\x00" + bytes(ip) + udp + payload
