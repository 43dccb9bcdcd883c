"""The ``tcp_reorder`` reference: what a TCP flow monitor that puts each
flow's segments in sequence order counts, with a reorder window of one
round.

The rule, for each direction of each TCP connection (a flow, keyed as
``tcp_flows`` keys it, parsed by its rule: a payload ends at the IP total
length):

1. Payload segments are held with their TCP sequence numbers, in capture
   order.
2. A round falls after each chunk of ``batch_packets`` records of the
   capture once at least ``scan_bytes`` raw payload bytes have been held
   since the last round, and once more after the last record.
3. In a round each flow's held segments go in sequence order, ties in
   capture order.  A sequence number is read relative to the flow's base
   in a signed 2^31 window; the base is set at the flow's first round, to
   its lowest sequence number there, each read relative to the first one
   captured.
4. The flow's edge starts at the base.  In that order a segment gives its
   bytes past the edge and moves the edge to its end; a segment that ends at
   or behind the edge gives nothing.  So bytes that an earlier segment or
   an earlier round already gave are dropped (first bytes win), and a hole
   is skipped and never filled: a segment whose round has passed its place
   gives only what lies past the edge.
5. A flow's stream is its rounds' outputs end to end; every overlapping
   occurrence of every pattern in it counts once (``count.py``), none
   across two flows.

The bytes returned beside the counts are the raw payload bytes on the wire,
retransmissions included.  ``batch_packets`` and ``scan_bytes`` default to
the deployment's, ``match --flows --reorder --stream`` at the CLI's
defaults.  Nothing here comes from the program under test.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from gpubench.reference.count import count_payloads
from gpubench.reference.pcap import ETH_HLEN, MIN_IP_HLEN, read_records
from gpubench.reference.tcp_flows import IPPROTO_TCP, MIN_TCP_HLEN

BATCH_PACKETS = 8192
SCAN_BYTES = 1 << 20
SEQ_SPACE = 1 << 32


def tcp_segments(path) -> Iterator[Tuple[int, bytes, int, bytes]]:
    """``(record index, flow key, sequence number, payload)`` of every TCP
    segment of the capture at ``path`` with a payload, in capture order,
    by ``tcp_flows``' parse."""
    with open(path, "rb") as f:
        data = f.read()
    for rec, (off, incl, orig) in enumerate(read_records(data)):
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
        ip_end = ip + total if total >= ihl + doff else off + orig
        stop = min(ip_end, off + orig, end)
        if stop > start:
            key = data[ip + 12 : ip + 20] + data[tcp : tcp + 4]
            yield rec, key, int.from_bytes(data[tcp + 4 : tcp + 8], "big"), data[start:stop]


def signed(d: int) -> int:
    """``d`` modulo 2^32 read in the signed window ``[-2^31, 2^31)``."""
    return (d + (1 << 31)) % SEQ_SPACE - (1 << 31)


class Reassembly:
    """Each flow's stream and what the rounds did: segments and raw bytes
    held, segments placed ahead of one of their flow captured before them,
    bytes dropped as already given, and the rounds."""

    def __init__(self):
        self.streams: Dict[bytes, bytearray] = {}
        self.segments = self.held_bytes = self.moved = self.trimmed_bytes = self.rounds = 0


def _round(held: Dict[bytes, List[Tuple[int, bytes]]], flows: Dict[bytes, list],
           out: Reassembly) -> None:
    """One round over every flow's held ``(seq, payload)`` segments, given
    in capture order; ``flows`` keeps each flow's ``[base, edge]``."""
    out.rounds += 1
    for key, segs in held.items():
        st = flows.get(key)
        if st is None:
            s0 = segs[0][0]
            st = flows[key] = [(s0 + min(signed(q - s0) for q, _ in segs)) % SEQ_SPACE, 0]
        base, edge = st
        placed = sorted(range(len(segs)), key=lambda i: (signed(segs[i][0] - base), i))
        first_after = len(segs)       # the first capture among those placed after
        for i in reversed(placed):
            out.moved += i > first_after
            first_after = min(first_after, i)
        stream = out.streams.setdefault(key, bytearray())
        for i in placed:
            rel, payload = signed(segs[i][0] - base), segs[i][1]
            end = rel + len(payload)
            if end <= edge:
                out.trimmed_bytes += len(payload)
                continue
            out.trimmed_bytes += max(0, edge - rel)
            stream += payload[max(0, edge - rel) :]
            edge = end
        st[1] = edge
    held.clear()


def reassemble(path, *, batch_packets: int = BATCH_PACKETS,
               scan_bytes: int = SCAN_BYTES) -> Reassembly:
    """Every flow of the capture at ``path`` by the rule above."""
    out = Reassembly()
    held: Dict[bytes, List[Tuple[int, bytes]]] = {}
    flows: Dict[bytes, list] = {}
    since, chunk = 0, 0
    for rec, key, seq, payload in tcp_segments(path):
        while rec >= (chunk + 1) * batch_packets:      # a chunk ended before this record
            chunk += 1
            if since >= scan_bytes:
                _round(held, flows, out)
                since = 0
        held.setdefault(key, []).append((seq, payload))
        out.segments += 1
        out.held_bytes += len(payload)
        since += len(payload)
    if held:
        _round(held, flows, out)
    return out


def capture_counts(path, patterns, mode: str = "tcp", device="cpu", *,
                   batch_packets: int = BATCH_PACKETS, scan_bytes: int = SCAN_BYTES):
    """int64 counts of ``patterns`` over the reassembled TCP streams of the
    capture at ``path``, and the raw payload bytes on the wire."""
    if mode != "tcp":
        raise ValueError(f"the reference reads TCP streams only, not {mode!r}")
    r = reassemble(path, batch_packets=batch_packets, scan_bytes=scan_bytes)
    return count_payloads(list(r.streams.values()), patterns, device=device), r.held_bytes
