"""The ``tcp_flows`` reference: what a TCP flow monitor counts.  Each
direction of each TCP connection is one stream, its segments' payloads
laid end to end in capture order, and every overlapping occurrence of
every pattern inside one stream counts once, wherever the segments split
it (``gpubench/reference/count.py``, one payload a stream); no match spans
two streams.

The parse, written from the formats alone for the benchmark's check: an
Ethernet frame carries a TCP segment when its ethertype is 0x0800, its IP
header length (IHL words) is at least 20 bytes, its protocol byte is 6 and
its TCP data offset is at least 20 bytes, each within the captured bytes.
The payload starts after the TCP header and ends at the IP total length
(RFC 791), so the zeros that pad a short frame are not stream bytes; it is
clipped to the wire length and to the captured bytes.  A total length
shorter than the IP and TCP headers (0 in captures of hosts that offload
segmentation) is not trusted, and the payload runs to the wire length.  A stream is keyed
by (source address, destination address, source port, destination port).
"""

from __future__ import annotations

from typing import Dict, List

from gpubench.reference.count import count_payloads
from gpubench.reference.pcap import ETH_HLEN, MIN_IP_HLEN, read_records

IPPROTO_TCP = 6
MIN_TCP_HLEN = 20


def tcp_streams(path) -> List[bytes]:
    """Every TCP stream of the capture at ``path``, in order of first
    appearance."""
    with open(path, "rb") as f:
        data = f.read()
    streams: Dict[bytes, List[bytes]] = {}
    for off, incl, orig in read_records(data):
        end = off + incl
        ip = off + ETH_HLEN
        if incl < ETH_HLEN + MIN_IP_HLEN or data[off + 12 : off + 14] != b"\x08\x00":
            continue
        ihl = (data[ip] & 0x0F) * 4
        if ihl < MIN_IP_HLEN or data[ip + 9] != IPPROTO_TCP:
            continue
        tcp = ip + ihl
        if tcp + 13 > end:
            continue
        doff = (data[tcp + 12] >> 4) * 4
        if doff < MIN_TCP_HLEN:
            continue
        start = tcp + doff
        total = int.from_bytes(data[ip + 2 : ip + 4], "big")
        # A total length shorter than the two headers (0 from a TSO host)
        # is no datagram's length: the payload runs to the wire length.
        ip_end = ip + total if total >= ihl + doff else off + orig
        stop = min(ip_end, off + orig, end)
        key = data[ip + 12 : ip + 20] + data[tcp : tcp + 4]
        streams.setdefault(key, []).append(data[start:stop] if stop > start else b"")
    return [b"".join(parts) for parts in streams.values()]


def capture_counts(path, patterns, mode: str = "tcp", device="cpu"):
    """int64 counts of ``patterns`` over the TCP streams of the capture at
    ``path``, and the stream bytes they were counted over."""
    if mode != "tcp":
        raise ValueError(f"the reference reads TCP streams only, not {mode!r}")
    streams = tcp_streams(path)
    return count_payloads(streams, patterns, device=device), sum(len(s) for s in streams)
