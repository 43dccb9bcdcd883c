"""Synthetic corpus generation: seeded classic-pcap captures.

Counterpart of ``multithreading_string_matching_tpu/io/synth.py``'s
``synth_udp_pcap`` and ``synth_tcp_flows_pcap``: the same seed writes the
same bytes, so a capture made by either package feeds both.  UDP packets
exercise the decode paths (IHL 5 and 6, runts, non-UDP protocols) with
planted pattern occurrences; TCP flow captures control segmentation,
interleaving, reordering, retransmission, overlap and VLAN tags.
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


def synth_tcp_flows_pcap(
    path,
    flows,
    *,
    segment_len: int = 0,
    interleave_seed: Optional[int] = None,
    noise_packets: int = 0,
    seed: int = 0,
    reorder_seed: Optional[int] = None,
    retransmit_rate: float = 0.0,
    overlap_rate: float = 0.0,
    vlan_rate: float = 0.0,
) -> int:
    """Write a capture of TCP flows with controlled segmentation; returns
    the total stream bytes.

    ``flows``: ``((src_ip, dst_ip, sport, dport), payload)`` or ``(key,
    payload, segment_lens)`` items; the stream splits into ``segment_lens``,
    else fixed ``segment_len`` pieces, else one segment.  Segments keep
    per-flow order; ``interleave_seed`` shuffles which flow emits at each
    slot (another flow's packet lands between two halves of a signature).
    ``noise_packets`` appends UDP frames that are not TCP flow segments.

    Wire faults that sequence-aware reassembly must survive (sequence
    numbers stay true to each byte's stream position):

    - ``reorder_seed``: shuffle each flow's segment emission order;
    - ``retransmit_rate``: after a segment, re-emit a random earlier one;
    - ``overlap_rate``: prepend a tail of the previous segment, with the
      sequence number rewound by as much;
    - ``vlan_rate``: wrap a flow frame in an 802.1Q tag (about 1 in 4 of
      them in an 802.1ad + 802.1Q pair); noise packets stay untagged.
    """
    from multithreading_string_matching_tpu_torch.io.pcap import classic_global_header

    rng = np.random.default_rng(seed)
    frames = []  # (flow index, frame bytes)
    total = 0
    for fi, spec in enumerate(flows):
        key, payload = spec[0], bytes(spec[1])
        seglens = spec[2] if len(spec) > 2 else None
        total += len(payload)
        if seglens is None:
            step = segment_len if segment_len > 0 else max(1, len(payload))
            seglens = [step] * (-(-len(payload) // step)) if payload else [0]
        pos = 0
        seq = 1000 * (fi + 1)
        segs = []  # (seq, bytes) in stream order, before the fault knobs
        for sl in seglens:
            seg = payload[pos : pos + sl]
            pos += sl
            segs.append((seq, seg))
            seq += len(seg)
        if pos < len(payload):
            raise ValueError("segment_lens shorter than payload")
        if overlap_rate > 0:
            out = []
            for si, (sq, seg) in enumerate(segs):
                if si and out and rng.random() < overlap_rate:
                    prev_seg = segs[si - 1][1]
                    ov = int(rng.integers(1, len(prev_seg) + 1)) if prev_seg else 0
                    if ov:
                        seg = prev_seg[len(prev_seg) - ov :] + seg
                        sq -= ov
                out.append((sq, seg))
            segs = out
        emit = list(segs)
        if retransmit_rate > 0:
            out = []
            for si, s in enumerate(emit):
                out.append(s)
                if rng.random() < retransmit_rate:
                    out.append(emit[int(rng.integers(0, si + 1))])
            emit = out
        if reorder_seed is not None:
            np.random.default_rng(reorder_seed + fi).shuffle(emit)
        mk = _eth_ipv6_tcp if ":" in str(key[0]) else _eth_ipv4_tcp
        for sq, seg in emit:
            fr = mk(seg, key, sq)
            if vlan_rate > 0 and rng.random() < vlan_rate:
                fr = _vlan_wrap(fr, rng, double=rng.random() < 0.25)
            frames.append((fi, fr))
    if interleave_seed is not None:
        # Shuffle which flow emits at each slot, then emit each flow's
        # frames in order: cross-flow interleaving, per-flow order kept.
        tags = [fi for fi, _ in frames]
        np.random.default_rng(interleave_seed).shuffle(tags)
        by_flow = {}
        for fi, fr in frames:
            by_flow.setdefault(fi, []).append(fr)
        nxt = {fi: 0 for fi in by_flow}
        out_frames = []
        for fi in tags:
            out_frames.append(by_flow[fi][nxt[fi]])
            nxt[fi] += 1
    else:
        out_frames = [fr for _, fr in frames]
    for _ in range(noise_packets):
        pay = rng.integers(0, 256, size=int(rng.integers(0, 64)), dtype=np.uint8).tobytes()
        out_frames.append(_eth_ipv4(pay, proto=17))
    with open(path, "wb") as f:
        f.write(classic_global_header())
        for i, pkt in enumerate(out_frames):
            f.write(struct.pack("<IIII", i, 0, len(pkt), len(pkt)))
            f.write(pkt)
    return total


def _vlan_wrap(frame: bytes, rng, *, double: bool) -> bytes:
    """Insert one 802.1Q tag, or an 802.1ad outer + 802.1Q inner pair, after
    the Ethernet addresses, keeping the original ethertype."""
    tags = b"\x81\x00" + int(rng.integers(1, 4095)).to_bytes(2, "big")
    if double:
        tags = b"\x88\xa8" + int(rng.integers(1, 4095)).to_bytes(2, "big") + tags
    return frame[:12] + tags + frame[12:]


def _ip4(s) -> bytes:
    if isinstance(s, (bytes, bytearray)):
        return bytes(s)
    return bytes(int(x) for x in str(s).split("."))


def _tcp_header(sport: int, dport: int, seq: int) -> bytes:
    # doff=5, flags PSH|ACK, window 65535.
    return struct.pack(">HHIIHHHH", sport, dport, seq, 0, (5 << 12) | 0x18, 65535, 0, 0)


def _eth_ipv4_tcp(payload: bytes, key, seq: int) -> bytes:
    src, dst, sport, dport = key
    ip = bytearray(20)
    ip[0] = (4 << 4) | 5
    ip[9] = 6
    ip[2:4] = (20 + 20 + len(payload)).to_bytes(2, "big")
    ip[12:16] = _ip4(src)
    ip[16:20] = _ip4(dst)
    return b"\x00" * 12 + b"\x08\x00" + bytes(ip) + _tcp_header(sport, dport, seq) + payload


def _eth_ipv6_tcp(payload: bytes, key, seq: int) -> bytes:
    """Ethernet + IPv6 (40-byte header, next header TCP) + TCP; addresses in
    any form ``inet_pton`` reads."""
    import socket

    src, dst, sport, dport = key
    ip6 = bytearray(40)
    ip6[0] = 6 << 4
    ip6[4:6] = (20 + len(payload)).to_bytes(2, "big")
    ip6[6] = 6      # next header: TCP
    ip6[7] = 64     # hop limit
    ip6[8:24] = socket.inet_pton(socket.AF_INET6, str(src))
    ip6[24:40] = socket.inet_pton(socket.AF_INET6, str(dst))
    return b"\x00" * 12 + b"\x86\xdd" + bytes(ip6) + _tcp_header(sport, dport, seq) + payload


def _eth_ipv4(payload: bytes, proto: int = 17, ihl: int = 5) -> bytes:
    ip = bytearray(ihl * 4)
    ip[0] = (4 << 4) | ihl
    ip[9] = proto
    total = ihl * 4 + 8 + len(payload)
    ip[2:4] = total.to_bytes(2, "big")
    udp = struct.pack(">HHHH", 1234, 5678, 8 + len(payload), 0)
    return b"\x00" * 12 + b"\x08\x00" + bytes(ip) + udp + payload
