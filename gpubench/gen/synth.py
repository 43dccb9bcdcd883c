"""Seeded classic-pcap UDP captures, written in bulk from a traffic mix's
parameters: what the ``udp`` generator (``gpubench/gen/udp.py``) writes.

Every frame is Ethernet/IPv4/UDP; a share of them carries 4 bytes of IP
options (IHL 6).  A payload's length is uniform over ``payload_len ±
payload_len_jitter``.  Its bytes are uniform over 0-255 (``content:
"bytes"``) or over printable ASCII (``"text"``, 0x20-0x7E), with its first
byte NUL where ``lead_nul`` is set.  A share ``plant_rate`` of the packets
gets one pattern written at a uniform offset (after the lead NUL), the
pattern drawn from the pattern file's entries by ``plant_weights`` where
the mix gives them, or uniformly.  The same arguments write the same bytes.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

MAGIC_USEC_LE = 0xA1B2C3D4
LINKTYPE_ETHERNET = 1
REC_HLEN, ETH_HLEN, UDP_HLEN = 16, 14, 8
TEXT_LO, TEXT_HI = 0x20, 0x7E          # printable ASCII


def classic_global_header(linktype: int = LINKTYPE_ETHERNET, snaplen: int = 65535) -> bytes:
    """The 24-byte classic-pcap global header (microsecond timestamps)."""
    return struct.pack("<IHHiIII", MAGIC_USEC_LE, 2, 4, 0, 0, snaplen, linktype)


def _headers(lens: np.ndarray, ihl: np.ndarray) -> np.ndarray:
    """uint8[n, 62]: row i holds packet i's record, Ethernet, IPv4 and UDP
    headers in its first ``16 + 14 + 4 * ihl + 8`` bytes."""
    n = len(lens)
    h = np.zeros((n, REC_HLEN + ETH_HLEN + 24 + UDP_HLEN), dtype=np.uint8)
    frame = (ETH_HLEN + 4 * ihl + UDP_HLEN + lens).astype("<u4")
    h[:, 0:4] = np.arange(n, dtype="<u4").view(np.uint8).reshape(n, 4)
    h[:, 8:12] = frame.view(np.uint8).reshape(n, 4)
    h[:, 12:16] = h[:, 8:12]
    ip = REC_HLEN + ETH_HLEN
    h[:, ip - 2] = 0x08                                   # ethertype IPv4
    h[:, ip] = 0x40 | ihl
    h[:, ip + 2 : ip + 4] = (4 * ihl + UDP_HLEN + lens).astype(">u2").view(np.uint8).reshape(n, 2)
    h[:, ip + 9] = 17
    udp_len = (UDP_HLEN + lens).astype(">u2").view(np.uint8).reshape(n, 2)
    ports = np.frombuffer(struct.pack(">HH", 1234, 5678), dtype=np.uint8)
    for words in (5, 6):
        rows = ihl == words
        u = ip + 4 * words
        h[rows, u : u + 4] = ports
        h[rows, u + 4 : u + 6] = udp_len[rows]
    return h


def synth_udp_pcap(
    path,
    num_packets: int,
    *,
    payload_len: int,
    payload_len_jitter: int = 0,
    content: str = "bytes",
    lead_nul: bool = False,
    patterns: Optional[Sequence[bytes]] = None,
    plant_rate: float = 0.0,
    plant_weights: Optional[Sequence[float]] = None,
    ihl6_rate: float = 0.1,
    seed: int = 0,
) -> int:
    """Write the capture; returns its total payload bytes.  ``plant_weights``
    has one weight a pattern-file entry."""
    rng = np.random.default_rng(seed)
    n = int(num_packets)
    lo = max(0, payload_len - payload_len_jitter)
    lens = rng.integers(lo, payload_len + payload_len_jitter + 1, size=n)
    ihl = np.where(rng.random(n) < ihl6_rate, 6, 5)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    total = int(starts[-1])
    if content == "bytes":
        body = rng.integers(0, 256, size=total, dtype=np.uint8)
    elif content == "text":
        body = rng.integers(TEXT_LO, TEXT_HI + 1, size=total, dtype=np.uint8)
    else:
        raise ValueError(f"unknown payload content {content!r}")
    skip = 1 if lead_nul else 0
    if lead_nul:
        body[starts[:-1][lens > 0]] = 0
    if patterns and plant_rate > 0:
        plens = np.array([len(p) for p in patterns])
        w = None
        if plant_weights is not None:
            w = np.asarray(plant_weights, dtype=np.float64)
            w = w / w.sum()
        pick = rng.choice(len(patterns), size=n, p=w)
        room = lens - skip - plens[pick]
        offs = skip + np.floor(rng.random(n) * (np.maximum(room, 0) + 1)).astype(np.int64)
        planted = (rng.random(n) < plant_rate) & (room >= 0)
        for k in np.unique(pick[planted]):
            at = (starts[:-1] + offs)[planted & (pick == k)]
            for j, b in enumerate(patterns[k]):
                body[at + j] = b
    hdr = _headers(lens, ihl)
    hlen = REC_HLEN + ETH_HLEN + 4 * ihl + UDP_HLEN
    # The records lie end to end: each header's bytes, then its payload's.
    is_hdr = np.repeat(np.tile(np.array([True, False]), n), np.stack([hlen, lens], 1).reshape(-1))
    out = np.empty(len(is_hdr), dtype=np.uint8)
    out[is_hdr] = hdr[np.arange(hdr.shape[1]) < hlen[:, None]]
    out[~is_hdr] = body
    with open(path, "wb") as f:
        f.write(classic_global_header())
        f.write(out.data)
    return total
