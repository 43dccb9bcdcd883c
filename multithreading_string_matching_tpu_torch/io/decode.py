"""Vectorized Ethernet/IPv4/UDP/TCP payload extraction.

Counterpart of ``multithreading_string_matching_tpu/io/decode.py`` (whose
module docstring lists the reference predicate and every defined divergence
from it).  The header arithmetic runs as vectorized numpy over all packets
at once and materializes one zero-padded ``uint8[N, Lmax]`` payload tensor
plus ``int32[N]`` lengths — the host-side shape the port's staging consumes.

UDP: L >= l2; L - l2 >= 20; L - l2 >= ihl*4; proto == 17;
L - l2 - ihl*4 >= 8; payload at l2 + ihl*4 + 8.
TCP: ihl*4 >= 20; doff*4 >= 20; payload at l2 + ihl*4 + doff*4.
``strict=True`` adds the ethertype/ihl/protocol checks the reference omits;
``vlan``/``ipv6`` are opt-in extensions, off by default.
:func:`bpf_protocol_mask` is the live path's capture filter: which packets
are the protocol at all, whatever their payload's validity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from multithreading_string_matching_tpu_torch.io.pcap import PcapFile

IPPROTO_UDP = 17
IPPROTO_TCP = 6
ETHERTYPE_IPV4 = 0x0800
ETHERTYPE_IPV6 = 0x86DD
ETHERTYPE_VLAN = 0x8100   # 802.1Q
ETHERTYPE_QINQ = 0x88A8   # 802.1ad service tag
ETH_HLEN = 14
VLAN_HLEN = 4
LINKTYPE_ETHERNET = 1
LINKTYPE_NULL = 0          # BSD loopback: 4-byte family word
LINKTYPE_SLL = 113         # Linux cooked capture v1: 16-byte header
RAW_IP_LINKTYPES = (101, 12, 14)  # LINKTYPE_RAW and its BSD aliases
UDP_HLEN = 8
MIN_IP_HLEN = 20
MIN_TCP_HLEN = 20
IPV6_HLEN = 40


@dataclass(frozen=True)
class PayloadBatch:
    """Padded payload tensor + lengths, on the host."""

    payloads: np.ndarray      # uint8[N, Lmax] zero-padded payload bytes
    lengths: np.ndarray       # int32[N] true payload byte counts
    valid: np.ndarray         # bool[N_packets] which input packets were valid
    num_packets: int          # packets inspected (valid + invalid)

    @property
    def num_payloads(self) -> int:
        return int(self.payloads.shape[0])

    @property
    def total_payload_bytes(self) -> int:
        return int(self.lengths.sum())

    def payload(self, i: int) -> bytes:
        return self.payloads[i, : int(self.lengths[i])].tobytes()


def _safe_byte(buf: np.ndarray, idx: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """Gather buf[idx] where ok, else 0 — without out-of-bounds reads."""
    if buf.shape[0] == 0:
        return np.zeros(np.shape(idx), dtype=np.uint8)
    clipped = np.where(ok, idx, 0)
    return np.where(ok, buf[np.minimum(clipped, buf.shape[0] - 1)], 0)


def _linktype_geometry(lt: int):
    """``(et_base, l2_base)``: offset of the ethertype field (None for
    linktypes without one) and the fixed link-layer header size; Ethernet
    is the unknown-linktype fallback."""
    if lt == LINKTYPE_SLL:
        return 14, 16
    if lt in RAW_IP_LINKTYPES:
        return None, 0
    if lt == LINKTYPE_NULL:
        return None, 4
    return 12, ETH_HLEN


def _et_walk(buf, off, cap, et_base: int, n: int, *, vlan: bool):
    """Per-packet offset and value of the final ethertype field (after up to
    two stacked VLAN tags when ``vlan``), -1 where the capture is short."""
    et_off = np.full(n, et_base, dtype=np.int64)

    def read_et(o):
        ok = cap >= o + 2
        hi = _safe_byte(buf, off + o, ok).astype(np.int64)
        lo = _safe_byte(buf, off + o + 1, ok).astype(np.int64)
        return np.where(ok, (hi << 8) | lo, -1)

    et = read_et(et_off)
    if vlan:
        for _ in range(2):
            is_tag = (et == ETHERTYPE_VLAN) | (et == ETHERTYPE_QINQ)
            et_off = np.where(is_tag, et_off + VLAN_HLEN, et_off)
            et = read_et(et_off)
    return et_off, et


def l2_sizes(pcap: PcapFile, *, vlan: bool = False) -> np.ndarray:
    """``int64[N]`` per-packet link-layer header sizes: decode_headers' own
    L2 geometry (same linktype map, same up-to-two VLAN tag walk), so the
    flow layer reads IP headers where the validity predicate validated
    them.  Linktypes without an ethertype have no VLAN tags: there
    ``vlan`` changes nothing, as in decode_headers."""
    et_base, l2_base = _linktype_geometry(pcap.linktype)
    n = pcap.offsets.shape[0]
    if et_base is None or not vlan:
        return np.full(n, l2_base, np.int64)
    et_off, _ = _et_walk(pcap.buf, pcap.offsets, pcap.caplens, et_base, n, vlan=True)
    return et_off + 2


def decode_headers(
    pcap: PcapFile,
    mode: str,
    *,
    strict: bool = False,
    use_native: bool = True,
    vlan: bool = False,
    ipv6: bool = False,
):
    """Validity predicate + payload geometry for every packet.

    Returns ``(valid bool[N], payload_off int64[N], payload_len int64[N])``
    with offsets relative to each packet's start.
    """
    if mode not in ("udp", "tcp"):
        raise ValueError(f"mode must be 'udp' or 'tcp', got {mode!r}")
    lt = pcap.linktype
    if use_native and not (vlan or ipv6) and lt not in (
        LINKTYPE_SLL, LINKTYPE_NULL, *RAW_IP_LINKTYPES
    ):
        from multithreading_string_matching_tpu_torch.io import native

        if native.available():
            return native.decode(
                pcap.buf, pcap.offsets, pcap.caplens, pcap.origlens, mode, strict
            )
    buf = pcap.buf
    off = pcap.offsets
    cap = pcap.caplens
    L = pcap.origlens.astype(np.int64)
    n = off.shape[0]

    et_base, l2_base = _linktype_geometry(lt)
    l2 = np.full(n, l2_base, dtype=np.int64)
    is_v6 = strict_v4_ok = None
    if et_base is not None and (vlan or ipv6 or strict):
        et_off, et = _et_walk(buf, off, cap, et_base, n, vlan=vlan)
        if vlan:
            l2 = et_off + 2
        is_v6 = et == ETHERTYPE_IPV6
        strict_v4_ok = et == ETHERTYPE_IPV4
    elif lt == LINKTYPE_NULL and (ipv6 or strict):
        # AF_* family word in the capturing host's byte order: accept either.
        fam_ok = cap >= 4
        b = [_safe_byte(buf, off + k, fam_ok).astype(np.int64) for k in range(4)]
        fam_le = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
        fam_be = b[3] | (b[2] << 8) | (b[1] << 16) | (b[0] << 24)

        def fam_in(vals):
            m = np.zeros(n, dtype=bool)
            for v in vals:
                m |= (fam_le == v) | (fam_be == v)
            return m & fam_ok

        is_v6 = fam_in((24, 28, 30))  # AF_INET6 on BSD/macOS/Linux
        strict_v4_ok = fam_in((2,))   # AF_INET
    elif lt in RAW_IP_LINKTYPES and (ipv6 or strict):
        ver_ok = cap >= 1
        ver = _safe_byte(buf, off, ver_ok).astype(np.int64) >> 4
        is_v6 = ver_ok & (ver == 6)
        strict_v4_ok = ver_ok & (ver == 4)

    can_read_ihl = cap >= l2 + 1
    vhl = _safe_byte(buf, off + l2, can_read_ihl).astype(np.int64)
    iplen = (vhl & 0x0F) * 4
    can_read_proto = cap >= l2 + 10
    proto = _safe_byte(buf, off + l2 + 9, can_read_proto).astype(np.int64)

    ethertype_ok = True
    if strict and strict_v4_ok is not None:
        ethertype_ok = strict_v4_ok

    if mode == "udp":
        valid = L >= l2
        valid &= (L - l2) >= MIN_IP_HLEN
        valid &= can_read_ihl
        valid &= (L - l2) >= iplen
        valid &= can_read_proto & (proto == IPPROTO_UDP)
        valid &= (L - l2 - iplen) >= UDP_HLEN
        if strict:
            valid &= (iplen >= MIN_IP_HLEN) & ethertype_ok
        payload_off = l2 + iplen + UDP_HLEN
    else:
        valid = can_read_ihl
        valid &= iplen >= MIN_IP_HLEN
        thoff_idx = off + l2 + iplen + 12
        can_read_thoff = cap >= l2 + iplen + 13
        valid &= can_read_thoff
        thb = _safe_byte(buf, thoff_idx, valid).astype(np.int64)
        tcplen = (thb >> 4) * 4
        valid &= tcplen >= MIN_TCP_HLEN
        if strict:
            valid &= can_read_proto & (proto == IPPROTO_TCP) & ethertype_ok
        payload_off = l2 + iplen + tcplen

    if ipv6 and is_v6 is not None:
        want = IPPROTO_UDP if mode == "udp" else IPPROTO_TCP
        can_read_next = cap >= l2 + 7
        next_hdr = _safe_byte(buf, off + l2 + 6, can_read_next).astype(np.int64)
        v6 = is_v6 & ((L - l2) >= IPV6_HLEN) & can_read_next
        v6 &= next_hdr == want  # extension-header chains are not followed
        if mode == "udp":
            v6 &= (L - l2 - IPV6_HLEN) >= UDP_HLEN
            v6_off = l2 + IPV6_HLEN + UDP_HLEN
        else:
            th6_idx = off + l2 + IPV6_HLEN + 12
            can_read_th6 = cap >= l2 + IPV6_HLEN + 13
            v6 &= can_read_th6
            th6 = _safe_byte(buf, th6_idx, v6).astype(np.int64)
            tcp6 = (th6 >> 4) * 4
            v6 &= tcp6 >= MIN_TCP_HLEN
            v6_off = l2 + IPV6_HLEN + tcp6
        valid = np.where(is_v6, v6, valid)
        payload_off = np.where(is_v6, v6_off, payload_off)

    payload_len = L - payload_off
    valid &= payload_len >= 0     # C would wrap unsigned; rejected here
    payload_off = np.where(valid, payload_off, 0)
    payload_len = np.where(valid, payload_len, 0)
    return valid, payload_off, payload_len


def bpf_protocol_mask(pcap: PcapFile, mode: str) -> np.ndarray:
    """The live program's BPF ``"udp"``/``"tcp"`` capture-filter analogue
    (live_openmp_task.c:127,133): which packets ARE the protocol — the IP
    protocol / IPv6 next-header field matches — independent of the stricter
    payload-extraction validity predicate (a truncated UDP packet still
    passes the BPF filter and counts as "sniffed").

    Untagged frames only, like the reference's filter expressions (tcpdump
    ``udp`` does not match VLAN-encapsulated traffic without ``vlan`` in
    the expression)."""
    if mode not in ("udp", "tcp"):
        raise ValueError(f"mode must be 'udp' or 'tcp', got {mode!r}")
    want = IPPROTO_UDP if mode == "udp" else IPPROTO_TCP
    buf, off, cap = pcap.buf, pcap.offsets, pcap.caplens
    n = off.shape[0]
    lt = pcap.linktype
    if lt == LINKTYPE_SLL:
        et_base, l2 = 14, 16
    elif lt in RAW_IP_LINKTYPES:
        et_base, l2 = None, 0
    elif lt == LINKTYPE_NULL:
        et_base, l2 = None, 4
    else:
        et_base, l2 = 12, ETH_HLEN

    if et_base is not None:
        ok_et = cap >= et_base + 2
        hi = _safe_byte(buf, off + et_base, ok_et).astype(np.int64)
        lo = _safe_byte(buf, off + et_base + 1, ok_et).astype(np.int64)
        et = np.where(ok_et, (hi << 8) | lo, -1)
        is_v4 = et == ETHERTYPE_IPV4
        is_v6 = et == ETHERTYPE_IPV6
    elif lt == LINKTYPE_NULL:
        ok_fam = cap >= 4
        b = [_safe_byte(buf, off + k, ok_fam).astype(np.int64) for k in range(4)]
        fam_le = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
        fam_be = b[3] | (b[2] << 8) | (b[1] << 16) | (b[0] << 24)
        is_v4 = ok_fam & ((fam_le == 2) | (fam_be == 2))
        is_v6 = ok_fam & (
            np.isin(fam_le, (24, 28, 30)) | np.isin(fam_be, (24, 28, 30))
        )
    else:  # raw IP
        ok_v = cap >= 1
        ver = _safe_byte(buf, off, ok_v).astype(np.int64) >> 4
        is_v4 = ok_v & (ver == 4)
        is_v6 = ok_v & (ver == 6)

    ok_proto = cap >= l2 + 10
    proto = _safe_byte(buf, off + l2 + 9, ok_proto).astype(np.int64)
    ok_next = cap >= l2 + 7
    next_hdr = _safe_byte(buf, off + l2 + 6, ok_next).astype(np.int64)
    # IPv6 fragment (next-header 44): tcpdump's 'udp'/'tcp' — and the cBPF
    # program LiveSource installs (io/live.py bpf_protocol_program) — also
    # accept a fragment whose post-fragment-header next-header matches; the
    # fragment extension header starts right after the fixed 40-byte IPv6
    # header, so its next-header byte sits at l2 + 40.
    ok_frag = cap >= l2 + 41
    frag_next = _safe_byte(buf, off + l2 + 40, ok_frag).astype(np.int64)
    v6_hit = (next_hdr == want) | (
        (next_hdr == 44) & ok_frag & (frag_next == want)
    )
    return np.asarray(
        (is_v4 & ok_proto & (proto == want)) | (is_v6 & ok_next & v6_hit),
        dtype=bool,
    )


def _materialize_padded(
    buf: np.ndarray, starts: np.ndarray, lens: np.ndarray, pad_len_to: int,
) -> np.ndarray:
    """Scatter variable-length byte slices into a zero-padded [N, Lmax]
    tensor without a per-packet Python loop."""
    n = starts.shape[0]
    lmax = int(lens.max()) if n else 0
    lmax = max(lmax, 1)
    if pad_len_to > 1:
        lmax = -(-lmax // pad_len_to) * pad_len_to
    from multithreading_string_matching_tpu_torch.io import native

    if native.available():
        return native.fill_padded(buf, starts, lens, lmax)
    out = np.zeros((n, lmax), dtype=np.uint8)
    total = int(lens.sum())
    if total == 0:
        return out
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(total, dtype=np.int64) - np.repeat(cum, lens)
    src = np.repeat(starts, lens) + cols
    out[rows, cols] = buf[src]
    return out


def extract_payloads(
    pcap: PcapFile,
    mode: str = "udp",
    *,
    strict: bool = False,
    keep_invalid: bool = False,
    pad_len_to: int = 1,
    pad_n_to: int = 1,
    vlan: bool = False,
    ipv6: bool = False,
) -> PayloadBatch:
    """Decode + slice every packet's payload into a padded host tensor.

    ``keep_invalid=True`` keeps a zero-length row per invalid packet (equal
    counts, different row bookkeeping).  ``pad_len_to``/``pad_n_to`` round
    the dims up; padding rows have length 0 and padding bytes are 0.
    """
    valid, poff, plen = decode_headers(
        pcap, mode, strict=strict, vlan=vlan, ipv6=ipv6
    )
    # Clip payload reads to the captured bytes (never read past caplen).
    avail = np.maximum(pcap.caplens - poff, 0)
    read_len = np.minimum(plen, avail)

    if keep_invalid:
        starts = pcap.offsets + poff
        lens = np.where(valid, read_len, 0)
    else:
        starts = (pcap.offsets + poff)[valid]
        lens = read_len[valid]

    n = starts.shape[0]
    n_padded = max(n, 1)
    if pad_n_to > 1:
        n_padded = -(-n_padded // pad_n_to) * pad_n_to
    if n_padded != n:
        starts = np.concatenate([starts, np.zeros(n_padded - n, dtype=starts.dtype)])
        lens = np.concatenate([lens, np.zeros(n_padded - n, dtype=lens.dtype)])

    payloads = _materialize_padded(pcap.buf, starts, lens, pad_len_to)
    return PayloadBatch(
        payloads=payloads,
        lengths=lens.astype(np.int32),
        valid=valid,
        num_packets=pcap.num_packets,
    )
