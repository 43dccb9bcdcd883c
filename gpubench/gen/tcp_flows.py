"""The ``tcp_flows`` capture generator: a web-facing link's TCP
connections, interleaved, as an IDS sensor beside the servers sees them.

Each of ``connections`` connections has a client address and port of its
own and opens with SYN, SYN-ACK and ACK; the client sends one request
(``request_len``, uniform, printable ASCII) and the server one response
(``response_len``: a bounded Pareto, uniform random bytes, as compressed or
encrypted bodies look), in flights of up to ``flight_segments`` full
segments back to back (RFC 6928's initial window); the receiver sends a
pure ACK after every ``ack_every``-th data segment it gets (RFC 1122
4.2.3.2, RFC 5681 4.2); a FIN/ACK from each side and the last ACK close
it.  A share ``timestamps_share`` of the connections carries the
timestamps option (RFC 7323: a 32-byte TCP header, 1,448-byte segments at a
1,500-byte MTU); the rest a 20-byte header and 1,460-byte segments, whose
frames under 60 bytes go out padded with zeros to 60.  Sequence numbers
are true 32-bit ones from random initial numbers.  ``concurrent``
connections are open at a time: each step a uniformly drawn open
connection takes its next step (a handshake frame, the request, one flight
with the ACKs of the one before, the close), and a closed one is followed
by the next.

One pattern-file entry is planted every ``plant_every`` stream bytes on
average, at a uniform position; a share ``plant_straddle`` of them is moved
to straddle a segment boundary of its stream.  ``packets``, where given,
caps the frames written.  ``write`` returns the stream bytes: every TCP
payload to the IP total length.  TCP checksums are left zero, as a capture on
a host with checksum offload shows them.  The same arguments write the
same bytes.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from gpubench.gen.synth import REC_HLEN, ETH_HLEN, TEXT_HI, TEXT_LO, classic_global_header

IP_HLEN = 20
MIN_FRAME = 60                  # the Ethernet minimum, frame check sequence left out
MTU = 1500
HDR_MAX = REC_HLEN + ETH_HLEN + IP_HLEN + 40
SYN, SYN_ACK, ACK, DATA, FIN_ACK = 0x02, 0x12, 0x10, 0x10, 0x11
PSH = 0x08
CLIENT, SERVER = 0, 1
USEC_PER_FRAME = 7

# TCP options: with timestamps, SYNs carry MSS, SACK-permitted, timestamps,
# NOP and window scale (40-byte header), the rest NOP, NOP and timestamps
# (32 bytes); without, SYNs carry MSS, NOP, window scale, NOP, NOP and
# SACK-permitted (32 bytes), the rest none (20 bytes).  Timestamp values
# are filled in per frame.
_OPT_SYN_TS = bytes([2, 4, 0, 0, 4, 2, 8, 10]) + bytes(8) + bytes([1, 3, 3, 7])
_OPT_TS = bytes([1, 1, 8, 10]) + bytes(8)
_OPT_SYN = bytes([2, 4, 0, 0, 1, 3, 3, 7, 1, 1, 4, 2])


def bounded_pareto(rng, n: int, alpha: float, lo: float, hi: float) -> np.ndarray:
    """``n`` draws of a Pareto of shape ``alpha`` bounded to ``[lo, hi]``
    (inverse of its distribution function), as whole numbers."""
    u = rng.random(n)
    la, ha = lo ** alpha, hi ** alpha
    x = (-(u * ha - u * la - ha) / (ha * la)) ** (-1.0 / alpha)
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


class _Frames:
    """Frame fields in capture order, appended one frame at a time."""

    def __init__(self):
        self.cols = {k: [] for k in ("conn", "side", "flags", "seq", "ack", "src", "plen")}

    def add(self, conn, side, flags, seq, ack, src=0, plen=0):
        c = self.cols
        c["conn"].append(conn)
        c["side"].append(side)
        c["flags"].append(flags)
        c["seq"].append(seq & 0xFFFFFFFF)
        c["ack"].append(ack & 0xFFFFFFFF)
        c["src"].append(src)
        c["plen"].append(plen)

    def arrays(self, limit: Optional[int]) -> dict:
        return {k: np.array(v[:limit], dtype=np.int64) for k, v in self.cols.items()}


class _Conn:
    """One connection's state: the steps it has left to take."""

    def __init__(self, i, isn_c, isn_s, req_at, req_len, resp_at, resp_len, mss, flight, ack_every):
        self.i, self.mss, self.flight, self.ack_every = i, mss, flight, ack_every
        self.isn_c, self.isn_s = isn_c, isn_s
        self.req_at, self.req_len, self.resp_at, self.resp_len = req_at, req_len, resp_at, resp_len
        self.step = 0
        self.sent = 0            # response bytes sent
        self.unacked = []        # server sequence numbers still to ACK, after full pairs
        self.segs = 0            # response data segments sent

    def take(self, out: _Frames) -> bool:
        """Emit this connection's next step; ``True`` once it has closed."""
        i, c1, s1 = self.i, self.isn_c + 1, self.isn_s + 1
        if self.step == 0:
            out.add(i, CLIENT, SYN, self.isn_c, 0)
        elif self.step == 1:
            out.add(i, SERVER, SYN_ACK, self.isn_s, c1)
        elif self.step == 2:
            out.add(i, CLIENT, ACK, c1, s1)
            out.add(i, CLIENT, DATA | PSH, c1, s1, self.req_at, self.req_len)
        elif self.sent < self.resp_len:
            self._acks(out)
            for _ in range(self.flight):
                n = min(self.mss, self.resp_len - self.sent)
                if n <= 0:
                    break
                last = self.sent + n == self.resp_len
                out.add(i, SERVER, DATA | (PSH if last else 0), s1 + self.sent,
                        c1 + self.req_len, self.resp_at + self.sent, n)
                self.sent += n
                self.segs += 1
                if self.segs % self.ack_every == 0:
                    self.unacked.append(s1 + self.sent)
        else:
            self._acks(out)
            c_end, s_end = c1 + self.req_len, s1 + self.resp_len
            out.add(i, SERVER, FIN_ACK, s_end, c_end)
            out.add(i, CLIENT, FIN_ACK, c_end, s_end + 1)
            out.add(i, SERVER, ACK, s_end + 1, c_end + 1)
            return True
        self.step += 1
        return False

    def _acks(self, out: _Frames) -> None:
        """The client's pure ACKs of the flight before, in order."""
        for a in self.unacked:
            out.add(self.i, CLIENT, ACK, self.isn_c + 1 + self.req_len, a)
        self.unacked = []


def _plant(rng, stream, starts, lens, mss, patterns, weights, every, straddle) -> None:
    """Write pattern-file entries into ``stream`` (streams laid end to end
    at ``starts``): one every ``every`` bytes on average, a share
    ``straddle`` of them across a segment boundary of their stream."""
    total = len(stream)
    n = int(rng.poisson(total / every)) if every > 0 and patterns else 0
    if not n:
        return
    p = None
    if weights is not None:
        p = np.asarray(weights, dtype=np.float64)
        p = p / p.sum()
    pick = rng.choice(len(patterns), size=n, p=p)
    pos = rng.integers(0, total, size=n)
    cross = rng.random(n) < straddle
    back = rng.random(n)
    which = np.searchsorted(starts, pos, side="right") - 1
    for k, at, s, x, b in zip(pick, pos, which, cross, back):
        pat = patterns[k]
        m, ln, seg = len(pat), int(lens[s]), int(mss[s])
        if m > ln:
            continue
        rel = int(at - starts[s])
        if x and m > 1 and ln > seg:
            # The boundary nearest the drawn position, the pattern across it.
            edge = min(max(1, round(rel / seg)), (ln - 1) // seg) * seg
            rel = edge - 1 - int(b * (m - 1))
        rel = min(max(rel, 0), ln - m)
        o = int(starts[s]) + rel
        stream[o : o + m] = np.frombuffer(pat, dtype=np.uint8)


def _headers(f: dict, ts: np.ndarray, cli_ip, cli_port, srv_ip, srv_port, tsbase) -> tuple:
    """``(uint8[n, HDR_MAX] headers, int64[n] header bytes, int64[n] frame
    bytes)``: record, Ethernet, IPv4 and TCP headers of every frame."""
    n = len(f["conn"])
    conn, side, flags = f["conn"], f["side"], f["flags"]
    syn = (flags & SYN) != 0
    with_ts = ts[conn]
    thl = np.where(syn, np.where(with_ts, 40, 32), np.where(with_ts, 32, 20))
    ip_total = IP_HLEN + thl + f["plen"]
    frame = np.maximum(ETH_HLEN + ip_total, MIN_FRAME)
    hlen = REC_HLEN + ETH_HLEN + IP_HLEN + thl
    h = np.zeros((n, HDR_MAX), dtype=np.uint8)

    def put(col, values, dtype):
        v = np.ascontiguousarray(np.asarray(values).astype(dtype))
        w = np.dtype(dtype).itemsize
        h[:, col : col + w] = v.view(np.uint8).reshape(n, w)

    t_us = np.arange(n, dtype=np.int64) * USEC_PER_FRAME
    put(0, t_us // 1_000_000, "<u4")
    put(4, t_us % 1_000_000, "<u4")
    put(8, frame, "<u4")
    put(12, frame, "<u4")
    e = REC_HLEN
    client_mac = np.frombuffer(bytes.fromhex("02000000aa01"), np.uint8)
    server_mac = np.frombuffer(bytes.fromhex("02000000bb02"), np.uint8)
    to_server = side == CLIENT
    h[:, e : e + 6] = np.where(to_server[:, None], server_mac, client_mac)
    h[:, e + 6 : e + 12] = np.where(to_server[:, None], client_mac, server_mac)
    h[:, e + 12] = 0x08
    ip = e + ETH_HLEN
    h[:, ip] = 0x45
    put(ip + 2, ip_total, ">u2")
    put(ip + 4, (conn * 7919 + np.arange(n)) & 0xFFFF, ">u2")
    h[:, ip + 6] = 0x40                                  # don't fragment
    h[:, ip + 8] = np.where(to_server, 64, 57)
    h[:, ip + 9] = 6
    src_ip = np.where(to_server, cli_ip[conn], srv_ip[conn])
    dst_ip = np.where(to_server, srv_ip[conn], cli_ip[conn])
    put(ip + 12, src_ip, ">u4")
    put(ip + 16, dst_ip, ">u4")
    words = h[:, ip : ip + IP_HLEN].astype(np.int64)
    csum = (words[:, 0::2] << 8 | words[:, 1::2]).sum(axis=1)
    while (csum >> 16).any():
        csum = (csum & 0xFFFF) + (csum >> 16)
    put(ip + 10, ~csum & 0xFFFF, ">u2")
    tcp = ip + IP_HLEN
    put(tcp, np.where(to_server, cli_port[conn], srv_port[conn]), ">u2")
    put(tcp + 2, np.where(to_server, srv_port[conn], cli_port[conn]), ">u2")
    put(tcp + 4, f["seq"], ">u4")
    put(tcp + 8, f["ack"], ">u4")
    h[:, tcp + 12] = (thl // 4) << 4
    h[:, tcp + 13] = flags
    put(tcp + 14, np.where(syn, 64240, np.where(with_ts, 502, 64240)), ">u2")
    opt = tcp + 20
    for rows, block in ((syn & with_ts, _OPT_SYN_TS), (~syn & with_ts, _OPT_TS),
                        (syn & ~with_ts, _OPT_SYN)):
        h[rows, opt : opt + len(block)] = np.frombuffer(block, np.uint8)
    # Both SYNs announce the MSS of a 1,500-byte MTU; timestamps cost a
    # segment 12 of its bytes.
    h[syn, opt + 2 : opt + 4] = np.frombuffer(struct.pack(">H", MTU - 40), np.uint8)
    tsval = (tsbase[conn, side] + t_us // 1000) & 0xFFFFFFFF
    tsecr = np.where(flags == SYN, 0, (tsbase[conn, 1 - side] + t_us // 1000) & 0xFFFFFFFF)
    for rows, at in ((syn & with_ts, opt + 8), (~syn & with_ts, opt + 4)):
        h[rows, at : at + 4] = tsval[rows].astype(">u4").view(np.uint8).reshape(-1, 4)
        h[rows, at + 4 : at + 8] = tsecr[rows].astype(">u4").view(np.uint8).reshape(-1, 4)
    return h, hlen, frame


def write(path, capture: dict, patterns: List[bytes], weights: Optional[List[float]],
          seed: int) -> int:
    rng = np.random.default_rng(seed)
    n_conn = int(capture["connections"])
    req, resp = capture["request_len"], capture["response_len"]
    with_ts = rng.random(n_conn) < float(capture["timestamps_share"])
    mss = np.where(with_ts, MTU - 40 - 12, MTU - 40)
    req_len = rng.integers(int(req["min"]), int(req["max"]) + 1, size=n_conn)
    resp_len = bounded_pareto(rng, n_conn, float(resp["alpha"]), float(resp["min"]),
                              float(resp["max"]))
    isn = rng.integers(0, 1 << 32, size=(n_conn, 2), dtype=np.int64)
    tsbase = rng.integers(0, 1 << 32, size=(n_conn, 2), dtype=np.int64)
    # Unique (client address, client port) pairs: 10.0.0.0/8 clients on
    # ephemeral ports; servers in 192.0.2.0/24 on 443 or 80.
    pairs = set()
    cli_ip = np.zeros(n_conn, np.int64)
    cli_port = np.zeros(n_conn, np.int64)
    for i in range(n_conn):
        while True:
            a = (10 << 24) | int(rng.integers(1, 1 << 24))
            p = int(rng.integers(32768, 61000))
            if (a, p) not in pairs:
                pairs.add((a, p))
                cli_ip[i], cli_port[i] = a, p
                break
    srv_ip = (192 << 24) | (2 << 8) | rng.integers(10, 18, size=n_conn)
    srv_port = np.where(rng.random(n_conn) < 0.8, 443, 80)

    # Streams end to end: connection i's request, then its response.
    lens = np.stack([req_len, resp_len], 1).reshape(-1)
    starts = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    stream = np.empty(int(starts[-1]), np.uint8)
    for i in range(n_conn):
        a, b, c = starts[2 * i], starts[2 * i + 1], starts[2 * i + 2]
        stream[a:b] = rng.integers(TEXT_LO, TEXT_HI + 1, size=b - a, dtype=np.uint8)
        stream[b:c] = np.frombuffer(rng.bytes(int(c - b)), np.uint8)
    _plant(rng, stream, starts[:-1], lens, np.repeat(mss, 2), patterns, weights,
           float(capture.get("plant_every", 0)), float(capture.get("plant_straddle", 0.0)))

    flight, ack_every = int(capture["flight_segments"]), int(capture["ack_every"])
    conns = [
        _Conn(i, int(isn[i, 0]), int(isn[i, 1]), int(starts[2 * i]), int(req_len[i]),
              int(starts[2 * i + 1]), int(resp_len[i]), int(mss[i]), flight, ack_every)
        for i in range(n_conn)
    ]
    limit = int(capture["packets"]) if "packets" in capture else None
    out = _Frames()
    pool = conns[: int(capture["concurrent"])]
    nxt = len(pool)
    while pool and (limit is None or len(out.cols["conn"]) < limit):
        j = int(rng.integers(0, len(pool)))
        if pool[j].take(out):
            if nxt < n_conn:
                pool[j] = conns[nxt]
                nxt += 1
            else:
                pool[j] = pool[-1]
                pool.pop()
    f = out.arrays(limit)
    h, hlen, frame = _headers(f, with_ts, cli_ip, cli_port, srv_ip, srv_port, tsbase)

    # Records end to end: each header, its payload, the frame's padding.
    rec = REC_HLEN + frame
    at = np.zeros(len(rec) + 1, np.int64)
    np.cumsum(rec, out=at[1:])
    buf = np.zeros(int(at[-1]), np.uint8)
    cols = np.arange(HDR_MAX)
    keep = cols[None, :] < hlen[:, None]
    buf[(at[:-1, None] + cols[None, :])[keep]] = h[keep]
    body = at[:-1] + hlen
    for o, s, n in zip(body[f["plen"] > 0].tolist(), f["src"][f["plen"] > 0].tolist(),
                       f["plen"][f["plen"] > 0].tolist()):
        buf[o : o + n] = stream[s : s + n]
    with open(path, "wb") as fh:
        fh.write(classic_global_header())
        fh.write(buf.data)
    return int(f["plen"].sum())
