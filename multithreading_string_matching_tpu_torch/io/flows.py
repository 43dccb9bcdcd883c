"""Flow reassembly: TCP/UDP 5-tuple conversations as byte streams.

Counterpart of ``multithreading_string_matching_tpu/io/flows.py``.  The
reference scans each packet alone, so a signature split across two
segments of one connection is invisible to it.  This module groups packets
into flows (direction-sensitive 5-tuples) and concatenates each flow's
payload bytes, in capture order or, with ``reorder``, in TCP sequence
order with first-bytes-win trimming; any engine then scans the
reassembled streams, and a match across a segment boundary counts like the
concatenated-flow oracle's.

The parse is the honest one (``decode_headers(strict=True)``: real IHL,
real TCP data offset, protocol checked), and a payload ends at the IP
total length, so an Ethernet trailer never joins a stream (the JAX
package runs to the wire length).  Truncated captures contribute only
their captured bytes.  :func:`count_flows_chunked` scans the streams
in fixed-width chunks with carried DFA states (the AC engine).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from multithreading_string_matching_tpu_torch.io.decode import decode_headers, l2_sizes
from multithreading_string_matching_tpu_torch.io.pcap import PcapFile


@dataclass(frozen=True)
class FlowBatch:
    """Reassembled flows in PayloadBatch's padded shape, so every Matcher
    entry point takes the rows as they are."""

    payloads: np.ndarray        # uint8[Fq, Lmax] zero-padded concatenated bytes
    lengths: np.ndarray         # int64[Fq] true stream byte counts
    keys: np.ndarray            # uint8[Fq, 12 or 37] flow keys (flow_keys)
    segments: np.ndarray        # int64[Fq] segment (packet) count per flow
    flow_of_packet: np.ndarray  # int64[N_packets] flow id, -1 for non-flow packets
    num_packets: int
    num_flows: int              # true flow count (rows past it are padding)
    # Segment map (flow-major, stream order within each flow): packet index
    # and stream start of every non-empty segment; flow f's segments are
    # [seg_bounds[f], seg_bounds[f+1]).
    seg_packets: np.ndarray     # int64[S]
    seg_starts: np.ndarray      # int64[S]
    seg_bounds: np.ndarray      # int64[F+1]

    def packet_of_offset(self, f: int, offset: int) -> int:
        """Capture packet number (0-based) whose segment holds stream byte
        ``offset`` of flow ``f``."""
        lo, hi = int(self.seg_bounds[f]), int(self.seg_bounds[f + 1])
        if lo == hi:
            raise IndexError(f"flow {f} has no payload segments")
        starts = self.seg_starts[lo:hi]
        j = int(np.searchsorted(starts, offset, side="right")) - 1
        return int(self.seg_packets[lo + max(0, j)])

    @property
    def total_payload_bytes(self) -> int:
        return int(self.lengths.sum())

    def stream(self, f: int) -> bytes:
        return self.payloads[f, : int(self.lengths[f])].tobytes()

    def key_tuple(self, f: int):
        """``(src_ip, dst_ip, sport, dport)`` of flow ``f``."""
        return key_tuple_bytes(self.keys[f])


V4_KEY_BYTES = 12   # src4 | dst4 | sport | dport
V6_KEY_BYTES = 37   # version | src16 | dst16 | sport | dport


def key_tuple_bytes(k):
    """``(src_ip, dst_ip, sport, dport)`` from one raw key row (``bytes`` or
    uint8 array) of either key space, told apart by width: dotted quads for
    v4, colon hex for v6."""
    if not isinstance(k, np.ndarray):
        k = np.frombuffer(bytes(k), np.uint8)
    if k.shape[0] == V6_KEY_BYTES:
        if int(k[0]) == 6:
            def v6s(a):
                return ":".join(f"{int(a[i]) << 8 | int(a[i + 1]):x}" for i in range(0, 16, 2))

            src, dst = v6s(k[1:17]), v6s(k[17:33])
        else:
            src = ".".join(str(int(b)) for b in k[1:5])
            dst = ".".join(str(int(b)) for b in k[17:21])
        return src, dst, int(k[33]) << 8 | int(k[34]), int(k[35]) << 8 | int(k[36])
    return (
        ".".join(str(int(b)) for b in k[0:4]),
        ".".join(str(int(b)) for b in k[4:8]),
        int(k[8]) << 8 | int(k[9]),
        int(k[10]) << 8 | int(k[11]),
    )


def _flow_geom(pcap: PcapFile, ipv6: bool, vlan: bool = False):
    """``(l2 int64[N], is6 bool[N], iplen int64[N])``: per-packet link-layer
    size (VLAN tag walk included with ``vlan``), IP version, and L3 header
    length (IHL for v4; the fixed 40 bytes for v6, whose extension headers
    are not followed).  Computed once per batch and shared by flow_keys,
    tcp_seqs and tcp_flags."""
    buf, base, cap = pcap.buf, pcap.offsets, pcap.caplens
    l2 = l2_sizes(pcap, vlan=vlan)
    n = base.shape[0]
    vhl = np.zeros(n, np.int64)
    ok_vhl = cap >= l2 + 1
    if len(buf):
        np.copyto(vhl, buf[np.minimum(base + l2, len(buf) - 1)], where=ok_vhl,
                  casting="unsafe")
    is6 = ((vhl >> 4) == 6) if ipv6 else np.zeros(n, bool)
    iplen = np.where(is6, 40, (vhl & 0x0F) * 4)
    return l2, is6, iplen


def flow_keys(pcap: PcapFile, mode: str = "tcp", *, ipv6: bool = False,
              vlan: bool = False, _geom=None):
    """``(valid bool[N], keys uint8[N, KW], payload_off, payload_len)`` under
    the strict decode; a key is readable only when the capture holds the IP
    addresses and the transport ports.

    ``ipv6=False``: 12-byte v4 keys ``src4|dst4|sport|dport``.
    ``ipv6=True``: 37-byte keys ``ver|src16|dst16|sport|dport`` for both
    families in one space (v4 addresses left-aligned, the version byte
    keeps the families apart).  ``vlan=True`` skips up to two stacked
    802.1Q/802.1ad tags; the VLAN ID is not part of the key.

    A payload ends where its IP datagram ends (RFC 791's total length; for
    IPv6 the fixed header and its payload length), clipped to the wire
    length and the captured bytes: the zeros that pad a short frame to the
    Ethernet minimum are no stream bytes.  A length field that ends inside
    the IP and TCP headers (0 in captures of TSO hosts, IPv6 jumbograms)
    is ignored and the payload runs to the wire length.  The per-packet
    modes keep the reference program's wire-length rule
    (``decode_headers``)."""
    valid, off, ln = decode_headers(pcap, mode, strict=True, ipv6=ipv6, vlan=vlan)
    buf, base, cap = pcap.buf, pcap.offsets, pcap.caplens
    n = base.shape[0]
    l2, is6, iplen = _geom if _geom is not None else _flow_geom(pcap, ipv6, vlan)
    # Key bytes must be captured: addresses end at l2+20 (v4) / l2+40 (v6),
    # ports at l2+iplen+4.
    addr_end = np.where(is6, 40, 20)
    valid = valid & (cap >= l2 + addr_end) & (cap >= l2 + iplen + 4)
    if len(buf):
        # The length field (v4 bytes 2-3, v6 bytes 4-5) lies inside the
        # captured addresses of every valid row.
        at = base + l2 + np.where(is6, 4, 2)
        hi = buf[np.minimum(at, len(buf) - 1)].astype(np.int64)
        lo = buf[np.minimum(at + 1, len(buf) - 1)].astype(np.int64)
        ip_end = l2 + np.where(is6, 40, 0) + ((hi << 8) | lo)
        # A length that ends inside the headers (0 from a TSO host, an
        # IPv6 jumbogram) is not a datagram's: the wire length stands.
        ln = np.where(ip_end >= off, np.minimum(ln, ip_end - off), ln)
    avail = np.where(valid, np.clip(cap - off, 0, ln), 0)
    if not ipv6:
        keys = np.zeros((n, V4_KEY_BYTES), np.uint8)
        if len(buf):
            ipidx = (base + l2 + 12)[:, None] + np.arange(8)[None, :]
            pidx = (base + l2 + iplen)[:, None] + np.arange(4)[None, :]
            idx = np.concatenate([ipidx, pidx], axis=1)
            np.copyto(keys, buf[np.minimum(idx, len(buf) - 1)], where=valid[:, None],
                      casting="unsafe")
        return valid, keys, off, avail
    keys = np.zeros((n, V6_KEY_BYTES), np.uint8)
    if len(buf):
        keys[:, 0] = np.where(valid, np.where(is6, 6, 4), 0)
        cols16 = np.arange(16)[None, :]
        alen = np.where(is6, 16, 4)[:, None]
        src_off = np.where(is6, l2 + 8, l2 + 12)
        dst_off = np.where(is6, l2 + 24, l2 + 16)
        for out_base, offv in ((1, src_off), (17, dst_off)):
            g = buf[np.minimum((base + offv)[:, None] + cols16, len(buf) - 1)]
            np.copyto(keys[:, out_base : out_base + 16], np.where(cols16 < alen, g, 0),
                      where=valid[:, None], casting="unsafe")
        pidx = (base + l2 + iplen)[:, None] + np.arange(4)[None, :]
        np.copyto(keys[:, 33:37], buf[np.minimum(pidx, len(buf) - 1)],
                  where=valid[:, None], casting="unsafe")
    return valid, keys, off, avail


def tcp_seqs(pcap: PcapFile, valid: np.ndarray, *, ipv6: bool = False,
             vlan: bool = False, _geom=None) -> np.ndarray:
    """int64[N] TCP sequence numbers of the valid rows.  Raises when a
    valid segment's capture cuts inside the 4 sequence bytes: reordering
    cannot guess an order."""
    buf, base, cap = pcap.buf, pcap.offsets, pcap.caplens
    n = base.shape[0]
    l2, _, iplen = _geom if _geom is not None else _flow_geom(pcap, ipv6, vlan)
    readable = cap >= l2 + iplen + 8
    if bool((valid & ~readable).any()):
        raise ValueError(
            "reorder=True needs the TCP sequence number captured: a valid "
            "segment's caplen cuts inside the TCP header (seq bytes 4-8)"
        )
    seqs = np.zeros(n, np.int64)
    if len(buf):
        idx = (base + l2 + iplen + 4)[:, None] + np.arange(4)[None, :]
        raw = buf[np.minimum(idx, len(buf) - 1)].astype(np.int64)
        vals = (raw[:, 0] << 24) | (raw[:, 1] << 16) | (raw[:, 2] << 8) | raw[:, 3]
        np.copyto(seqs, vals, where=valid & readable)
    return seqs


def tcp_flags(pcap: PcapFile, *, ipv6: bool = False, vlan: bool = False,
              _geom=None) -> np.ndarray:
    """uint8[N] TCP flag bytes (FIN=0x01, SYN=0x02, RST=0x04, ...) where the
    capture holds them, else 0: the FIN/RST hook of flow eviction, which is
    a resource policy and never raises."""
    buf, base, cap = pcap.buf, pcap.offsets, pcap.caplens
    n = base.shape[0]
    l2, _, iplen = _geom if _geom is not None else _flow_geom(pcap, ipv6, vlan)
    readable = cap >= l2 + iplen + 14
    flags = np.zeros(n, np.uint8)
    if len(buf):
        idx = base + l2 + iplen + 13
        np.copyto(flags, buf[np.minimum(idx, len(buf) - 1)], where=readable,
                  casting="unsafe")
    return flags


def reorder_plan(f_nz, seq_nz, len_nz):
    """Sequence order and first-bytes-win trimming for per-segment flow ids,
    TCP seqs and byte lengths given in capture order.

    Returns ``(order, trim, keep_len)``: take segments in ``order``
    (flow-major, then by sequence, capture order breaking ties) and drop
    the first ``trim[i]`` bytes of each (bytes an earlier segment already
    gave; a pure retransmission keeps 0).  Holes are not filled.  Sequence
    wrap is a signed +/-2^31 window around each flow's first captured seq,
    so one flow's captured extent must stay under 2 GiB (raised when it
    visibly does not)."""
    nseg = f_nz.shape[0]
    if nseg == 0:
        return (np.zeros(0, np.int64),) * 3
    F = int(f_nz.max()) + 1
    first = np.full(F, nseg, np.int64)
    np.minimum.at(first, f_nz, np.arange(nseg))
    seq0 = seq_nz[first[f_nz]]
    rel = ((seq_nz - seq0 + 2**31) % 2**32) - 2**31
    minrel = np.full(F, np.iinfo(np.int64).max)
    np.minimum.at(minrel, f_nz, rel)
    rel = rel - minrel[f_nz]          # non-negative within each flow
    if int((rel + len_nz).max()) >= 2**31:
        raise ValueError(
            "a flow's captured stream extent exceeds the 2 GiB reorder "
            "window; split the capture or use the streaming reassembler"
        )
    order = np.lexsort((np.arange(nseg), rel, f_nz))
    f_s = f_nz[order]
    rel_s = rel[order]
    len_s = len_nz[order].astype(np.int64)
    end = rel_s + len_s
    # Exclusive running max of covered end within each flow: shift each
    # flow's ends into a band of its own, take one global running max, and
    # take the band off again (an earlier flow's end lands below the band,
    # so coverage clips to 0 at every flow's start).
    big = int(end.max()) + 1
    key = f_s * big + end
    excl = np.empty(nseg, np.int64)
    excl[0] = -1
    np.maximum.accumulate(key[:-1], out=excl[1:])
    covered = np.clip(excl - f_s * big, 0, None)
    trim = np.clip(covered - rel_s, 0, len_s)
    return order, trim, len_s - trim


def extract_flows(
    pcap: PcapFile,
    mode: str = "tcp",
    *,
    pad_len_to: int = 128,
    pad_flows_to: int = 8,
    reorder: bool = False,
    ipv6: bool = False,
    vlan: bool = False,
) -> FlowBatch:
    """Group packets into flows and concatenate their payloads.

    Rows are zero past their length; widths round up to ``pad_len_to`` and
    the flow axis to ``pad_flows_to`` (padding rows have length 0).  Flow
    ids follow each key's first appearance on the wire."""
    if reorder and mode != "tcp":
        raise ValueError("reorder=True applies to TCP flows only")
    geom = _flow_geom(pcap, ipv6, vlan)
    valid, keys, off, ln = flow_keys(pcap, mode, ipv6=ipv6, vlan=vlan, _geom=geom)
    n = valid.shape[0]
    flow_of_packet = np.full(n, -1, np.int64)
    vidx = np.flatnonzero(valid)
    if vidx.size == 0:
        return FlowBatch(
            payloads=np.zeros((0, 0), np.uint8), lengths=np.zeros(0, np.int64),
            keys=np.zeros((0, keys.shape[1]), np.uint8), segments=np.zeros(0, np.int64),
            flow_of_packet=flow_of_packet, num_packets=n, num_flows=0,
            seg_packets=np.zeros(0, np.int64), seg_starts=np.zeros(0, np.int64),
            seg_bounds=np.zeros(1, np.int64),
        )
    # Distinct keys -> dense flow ids in first-seen order (np.unique sorts by
    # key bytes; remap so flow 0 is the first flow on the wire).
    kv = keys[vidx]
    _, first_idx, inv = np.unique(
        kv.view([("k", f"V{kv.shape[1]}")]).ravel(), return_index=True, return_inverse=True
    )
    fid = np.argsort(np.argsort(first_idx))[inv]
    flow_of_packet[vidx] = fid
    F = int(fid.max()) + 1

    seg_lens = ln[vidx]
    segments = np.bincount(fid, minlength=F).astype(np.int64)
    # Reassembly plan over non-empty segments, flow-major; the write cursor
    # of a segment is the within-flow exclusive prefix sum of lengths.  The
    # plan is also the segment map packet_of_offset reads.
    nz = seg_lens > 0
    pkt_nz = vidx[nz]
    f_nz = fid[nz]
    len_nz = seg_lens[nz]
    src_nz = pcap.offsets[pkt_nz] + off[pkt_nz]
    if reorder:
        seqs = tcp_seqs(pcap, valid, ipv6=ipv6, vlan=vlan, _geom=geom)
        order2, trim, len_s = reorder_plan(f_nz, seqs[pkt_nz], len_nz)
        src_s = (src_nz[order2] + trim).astype(np.int64)
    else:
        order2 = np.argsort(f_nz, kind="stable")
        len_s = len_nz[order2].astype(np.int64)
        src_s = src_nz[order2].astype(np.int64)
    f_s = f_nz[order2]
    seg_packets = pkt_nz[order2].astype(np.int64)
    flow_len = np.bincount(f_s, weights=len_s, minlength=F).astype(np.int64)

    lmax = int(flow_len.max()) if F else 0
    lmax_q = max(pad_len_to, -(-lmax // pad_len_to) * pad_len_to)
    f_q = max(pad_flows_to, -(-F // pad_flows_to) * pad_flows_to)
    payloads = np.zeros((f_q, lmax_q), np.uint8)
    cums = np.cumsum(len_s) - len_s
    cnt = np.bincount(f_s, minlength=F)
    span_first = np.cumsum(cnt) - cnt  # first sorted index of each flow
    seg_starts = cums - (
        np.repeat(cums[span_first[cnt > 0]], cnt[cnt > 0]) if len_s.size
        else np.zeros(0, np.int64)
    )
    seg_bounds = np.zeros(F + 1, np.int64)
    np.cumsum(cnt, out=seg_bounds[1:])
    from multithreading_string_matching_tpu_torch.io import native

    if native.available() and len_s.size:
        native.scatter_segments(pcap.buf, src_s, len_s, f_s.astype(np.int64), seg_starts,
                                payloads)
    else:
        for s in range(len_s.size):
            c = int(seg_starts[s])
            payloads[f_s[s], c : c + int(len_s[s])] = pcap.buf[src_s[s] : src_s[s] + len_s[s]]

    lengths = np.zeros(f_q, np.int64)
    lengths[:F] = flow_len
    keys_out = np.zeros((f_q, kv.shape[1]), np.uint8)
    keys_out[:F] = kv[np.sort(first_idx)]  # flow f = the f-th distinct key on the wire
    segs_out = np.zeros(f_q, np.int64)
    segs_out[:F] = segments
    return FlowBatch(
        payloads=payloads, lengths=lengths, keys=keys_out, segments=segs_out,
        flow_of_packet=flow_of_packet, num_packets=n, num_flows=F,
        seg_packets=seg_packets, seg_starts=seg_starts, seg_bounds=seg_bounds,
    )


def count_flows_chunked(matcher, fb: FlowBatch, chunk_width: int = 2048) -> np.ndarray:
    """Scan reassembled flows in fixed-width chunks with carried DFA states
    (``Matcher.count_chunk``, the ``ac_scan`` kernel on the card): the
    one-shot counts of the full rows, with each launch's width bounded.
    Returns int64[P] counts; the states stay on the matcher's device
    between chunks."""
    F, L = fb.payloads.shape
    if F == 0 or L == 0:
        return np.zeros(len(matcher.patterns), np.int64)
    states = matcher.streaming_state(F)
    total = np.zeros(len(matcher.patterns), np.int64)
    for c in range(0, L, chunk_width):
        chunk = fb.payloads[:, c : c + chunk_width]
        rel = np.clip(fb.lengths - c, 0, chunk.shape[1]).astype(np.int32)
        counts, states = matcher.count_chunk(chunk, rel, states)
        total += np.asarray(counts, dtype=np.int64)
    return total
