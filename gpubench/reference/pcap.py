"""A plain classic-pcap reader and the reference program's payload rules.

Written from the file format and the reference C program's rules, for the
benchmark's check alone: it shares no code with the program under test.

UDP (``packet_dumping.h`` of Lemnon95/multithreading_string_matching, read
with an explicit payload length): an Ethernet frame of wire length ``L``
carries a UDP payload when ``L >= 14``, ``L - 14 >= 20``, the IPv4 header
length ``ihl * 4`` fits (``L - 14 >= ihl * 4``), the protocol byte is 17 and
``L - 14 - ihl * 4 >= 8``.  The payload starts after the 8-byte UDP header
and runs to the wire length, clipped to the captured bytes.  The ethertype
is not looked at.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

ETH_HLEN = 14
MIN_IP_HLEN = 20
UDP_HLEN = 8
IPPROTO_UDP = 17

# magic -> byte order of the headers
_MAGICS = {
    b"\xd4\xc3\xb2\xa1": "<", b"\x4d\x3c\xb2\xa1": "<",
    b"\xa1\xb2\xc3\xd4": ">", b"\xa1\xb2\x3c\x4d": ">",
}


def read_records(data: bytes) -> List[Tuple[int, int, int]]:
    """``(offset, captured length, wire length)`` of every record of a
    classic pcap held in ``data``; the offset is that of the frame's first
    byte.  Only Ethernet captures are accepted."""
    if len(data) < 24 or data[:4] not in _MAGICS:
        raise ValueError("not a classic pcap file")
    order = _MAGICS[data[:4]]
    linktype = struct.unpack(order + "I", data[20:24])[0]
    if linktype != 1:
        raise ValueError(f"linktype {linktype}: the reference reads Ethernet captures only")
    rec = struct.Struct(order + "IIII")
    out = []
    pos, end = 24, len(data)
    while pos + 16 <= end:
        _, _, incl, orig = rec.unpack_from(data, pos)
        pos += 16
        if pos + incl > end:
            raise ValueError("truncated pcap record")
        out.append((pos, incl, orig))
        pos += incl
    return out


def udp_payload(data: bytes, offset: int, caplen: int, wirelen: int):
    """``(start, length)`` of the frame's UDP payload within ``data`` by the
    reference's rule, or ``None`` when the frame carries none."""
    L = wirelen
    if L < ETH_HLEN or L - ETH_HLEN < MIN_IP_HLEN or caplen < ETH_HLEN + 1:
        return None
    ihl = (data[offset + ETH_HLEN] & 0x0F) * 4
    if L - ETH_HLEN < ihl or caplen < ETH_HLEN + 10:
        return None
    if data[offset + ETH_HLEN + 9] != IPPROTO_UDP or L - ETH_HLEN - ihl < UDP_HLEN:
        return None
    start = ETH_HLEN + ihl + UDP_HLEN
    length = L - start
    if length < 0:
        return None
    length = max(0, min(length, caplen - start))
    return offset + start, length


def udp_payloads(path) -> List[bytes]:
    """Every UDP payload of the capture at ``path``, in capture order."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    for off, incl, orig in read_records(data):
        got = udp_payload(data, off, incl, orig)
        if got is not None:
            s, n = got
            out.append(data[s : s + n])
    return out
