"""The ``tcp_wan`` capture generator: ``tcp_flows``' web connections as a
sensor on a WAN uplink sees them, with retransmissions, overlaps and
reordering among their data segments.

The connections, their bytes, plants and frames in capture order are
``tcp_flows``' (``gpubench/gen/tcp_flows.py``, the same ``capture`` keys, in
the same draws from the seed: with every share below at 0 the two write the
same file).  Disorder is then applied to the data frames, from a second
random stream of the same seed, before the headers are written:

- a share ``retransmit_share`` of data segments is sent again, after
  ``retransmit_steps`` (uniform, inclusive) more steps of its connection
  (at the end of that step's frames; the connection's last step where it
  has fewer); a share ``resegment_share`` of those is re-segmented: its
  bytes start inside the original segment, at a uniform offset past its
  first byte, and run on through the stream, into the next segment where
  there is one, up to the connection's MSS;
- a share ``reorder_share`` is delayed past ``reorder_depth`` (uniform,
  inclusive) later data segments of its own direction, or past as many as
  there are;
- a share ``conflict_share`` is sent again like an exact retransmission
  but carrying other bytes (uniform random): a reassembler that lets the
  first bytes win counts the original's.

The kinds are drawn once a data segment and exclude one another.  A
retransmission carries its original's sequence number (plus its offset),
acknowledgement and flags (PSH where it ends its direction's bytes); every
frame's capture time, IP id and TCP timestamps follow its place in the
capture, as in ``tcp_flows``.  ``packets``, where given, caps the frames
written, after the disorder.  ``write`` returns the payload bytes on the
wire, retransmissions included.  The same arguments write the same bytes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from gpubench.gen.synth import REC_HLEN, TEXT_HI, TEXT_LO, classic_global_header
from gpubench.gen.tcp_flows import (
    HDR_MAX,
    MTU,
    PSH,
    _Conn,
    _Frames,
    _headers,
    _plant,
    bounded_pareto,
)

ORIGINAL, RETRANSMIT, RESEGMENT, CONFLICT = 0, 1, 2, 3
DISORDER_SEED = 0x7CB   # the second random stream: (seed, DISORDER_SEED)


def _connections(capture: dict, patterns, weights, rng):
    """``tcp_flows.write``'s draws up to its frames, in its order: the
    connections, their stream bytes with the plants, and the frames in
    capture order with each step's last frame.  ``(frames, takes, stream,
    per-connection arrays)``; ``takes`` is ``(connection, frames written
    after the step)`` a step."""
    n_conn = int(capture["connections"])
    req, resp = capture["request_len"], capture["response_len"]
    with_ts = rng.random(n_conn) < float(capture["timestamps_share"])
    mss = np.where(with_ts, MTU - 40 - 12, MTU - 40)
    req_len = rng.integers(int(req["min"]), int(req["max"]) + 1, size=n_conn)
    resp_len = bounded_pareto(rng, n_conn, float(resp["alpha"]), float(resp["min"]),
                              float(resp["max"]))
    isn = rng.integers(0, 1 << 32, size=(n_conn, 2), dtype=np.int64)
    tsbase = rng.integers(0, 1 << 32, size=(n_conn, 2), dtype=np.int64)
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
    takes = []
    pool = conns[: int(capture["concurrent"])]
    nxt = len(pool)
    while pool and (limit is None or len(out.cols["conn"]) < limit):
        j = int(rng.integers(0, len(pool)))
        conn = pool[j]
        done = conn.take(out)
        takes.append((conn.i, len(out.cols["conn"])))
        if done:
            if nxt < n_conn:
                pool[j] = conns[nxt]
                nxt += 1
            else:
                pool[j] = pool[-1]
                pool.pop()
    ends = np.concatenate([starts[1::2], starts[2::2]])   # requests', then responses' ends
    conn_arrays = {"with_ts": with_ts, "mss": mss, "cli_ip": cli_ip, "cli_port": cli_port,
                   "srv_ip": srv_ip, "srv_port": srv_port, "tsbase": tsbase,
                   "dir_end": ends.reshape(2, n_conn).T}
    return out.arrays(limit), takes, stream, conn_arrays


def frames(capture: dict, patterns: List[bytes], weights: Optional[List[float]], seed: int):
    """``(frame columns in capture order, payload source bytes, connection
    arrays)``: ``tcp_flows``' columns (``conn``, ``side``, ``flags``, ``seq``,
    ``ack``, ``src``, ``plen``) with the disorder applied, and two more:
    ``kind`` (``ORIGINAL``, ``RETRANSMIT``, ``RESEGMENT``, ``CONFLICT``) and
    ``delayed`` (a data segment moved later)."""
    f, takes, stream, ca = _connections(capture, patterns, weights, np.random.default_rng(seed))
    rng = np.random.default_rng([int(seed), DISORDER_SEED])
    n = len(f["conn"])
    take_conn = np.array([c for c, _ in takes], np.int64)
    take_end = np.minimum(np.array([e for _, e in takes], np.int64), n)
    take_of = np.searchsorted(take_end, np.arange(n), side="right")
    steps = {}                                   # connection -> its steps, in order
    for t, c in enumerate(take_conn.tolist()):
        steps.setdefault(c, []).append(t)
    ordinal = np.zeros(len(takes), np.int64)
    for lst in steps.values():
        ordinal[lst] = np.arange(len(lst))

    data = np.flatnonzero(f["plen"] > 0)
    u = rng.random(len(data))
    r_share = float(capture.get("retransmit_share", 0.0))
    c_share = float(capture.get("conflict_share", 0.0))
    o_share = float(capture.get("reorder_share", 0.0))
    retx = data[u < r_share]
    conflict = data[(u >= r_share) & (u < r_share + c_share)]
    reorder = data[(u >= r_share + c_share) & (u < r_share + c_share + o_share)]

    cols = {k: list(v) for k, v in f.items()}
    cols["kind"] = [ORIGINAL] * n
    key = np.arange(n, dtype=np.float64).tolist()   # place in the capture
    tie = [0] * n
    extra = bytearray()
    steps_after = capture.get("retransmit_steps", {"min": 1, "max": 2})
    lo, hi = int(steps_after["min"]), int(steps_after["max"])

    def again(i, kind, src, seq_off, plen):
        """Frame ``i`` sent again at the end of a later step of its
        connection, from ``source[src:]``, ``seq_off`` bytes into it."""
        c, side = int(f["conn"][i]), int(f["side"][i])
        lst = steps[c]
        t = lst[min(int(ordinal[take_of[i]]) + int(rng.integers(lo, hi + 1)), len(lst) - 1)]
        flags = int(f["flags"][i])
        if kind == RESEGMENT:
            flags = (flags & ~PSH) | (PSH if src + plen == int(ca["dir_end"][c, side]) else 0)
        for name, v in (("conn", c), ("side", side), ("flags", flags),
                        ("seq", (int(f["seq"][i]) + seq_off) & 0xFFFFFFFF),
                        ("ack", int(f["ack"][i])), ("src", src), ("plen", plen),
                        ("kind", kind)):
            cols[name].append(v)
        key.append(float(take_end[t]) - 0.5)
        tie.append(len(tie))

    reseg = rng.random(len(retx)) < float(capture.get("resegment_share", 0.0))
    for i, rs in zip(retx.tolist(), reseg.tolist()):
        p, s = int(f["plen"][i]), int(f["src"][i])
        if rs and p > 1:
            d = int(rng.integers(1, p))
            c, side = int(f["conn"][i]), int(f["side"][i])
            n_new = min(int(ca["mss"][c]), int(ca["dir_end"][c, side]) - (s + d))
            again(i, RESEGMENT, s + d, d, n_new)
        else:
            again(i, RETRANSMIT, s, 0, p)
    for i in conflict.tolist():
        p = int(f["plen"][i])
        again(i, CONFLICT, len(stream) + len(extra), 0, p)
        extra += rng.bytes(p)

    # Delays: past the k-th later data segment of the frame's direction.
    delayed = np.zeros(len(key), bool)
    if len(reorder):
        d_of = f["conn"][data] * 2 + f["side"][data]
        by_dir = np.lexsort((data, d_of))            # data frames by direction, in order
        sd = data[by_dir]
        last = np.searchsorted(d_of[by_dir], d_of[by_dir], side="right") - 1
        at = np.empty(len(data), np.int64)
        at[by_dir] = np.arange(len(data))
        depth = capture.get("reorder_depth", {"min": 1, "max": 3})
        k = rng.integers(int(depth["min"]), int(depth["max"]) + 1, size=len(reorder))
        idx = at[np.searchsorted(data, reorder)]
        for i, j in zip(reorder.tolist(), sd[np.minimum(idx + k, last[idx])].tolist()):
            if j != i:
                key[i] = j + 0.5
                delayed[i] = True

    order = np.lexsort((np.array(tie), np.array(key)))
    limit = int(capture["packets"]) if "packets" in capture else None
    order = order[:limit]
    out = {k: np.array(v, np.int64)[order] for k, v in cols.items()}
    out["delayed"] = delayed[order]
    source = np.concatenate([stream, np.frombuffer(bytes(extra), np.uint8)])
    return out, source, ca


def write(path, capture: dict, patterns: List[bytes], weights: Optional[List[float]],
          seed: int) -> int:
    f, source, ca = frames(capture, patterns, weights, seed)
    h, hlen, frame = _headers(f, ca["with_ts"], ca["cli_ip"], ca["cli_port"], ca["srv_ip"],
                              ca["srv_port"], ca["tsbase"])
    rec = REC_HLEN + frame
    at = np.zeros(len(rec) + 1, np.int64)
    np.cumsum(rec, out=at[1:])
    buf = np.zeros(int(at[-1]), np.uint8)
    cols = np.arange(HDR_MAX)
    keep = cols[None, :] < hlen[:, None]
    buf[(at[:-1, None] + cols[None, :])[keep]] = h[keep]
    body = at[:-1] + hlen
    has = f["plen"] > 0
    for o, s, n in zip(body[has].tolist(), f["src"][has].tolist(), f["plen"][has].tolist()):
        buf[o : o + n] = source[s : s + n]
    with open(path, "wb") as fh:
        fh.write(classic_global_header())
        fh.write(buf.data)
    return int(f["plen"].sum())
