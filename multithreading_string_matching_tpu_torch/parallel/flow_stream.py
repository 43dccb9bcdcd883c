"""Flow-aware streaming: per-flow carried state across feeds.

Counterpart of ``multithreading_string_matching_tpu/parallel/flow_stream.py``.
A per-packet scan cannot see a signature split across two segments of one
connection.  :class:`FlowStreamMatcher` appends each flow's segments to a
pending buffer, and each scan round lays the active flows out as lanes.
Two engines carry a flow's state from round to round:

- ``engine="ac"`` (the JAX package's default): one Aho-Corasick DFA state
  per flow.  A round scans its ``[flows, width]`` chunks with the carried
  states (``ops/scan.ac_scan``, the states on the device from chunk to
  chunk), and each flow keeps its final state; a flow revived in a later
  round goes on from it.  The DFA step composes, so a match split across
  any boundary counts once.
- ``engine="window"``: lanes ``[H-byte tail | new bytes]``, ``H = max_len -
  1``.  A match counts in the round its last byte falls in (``min_end =
  H``), and never starts in the zeros in front of a young flow's tail
  (``min_start``).

Either way a match across any boundary (segment, feed, scan round) counts
once, equal to the concatenated-flow oracle.

Memory: pending bytes are bounded by ``scan_bytes`` (a round fires once a
feed leaves more, and at :meth:`flush`); between rounds a flow costs one
int (ac) or its ``H``-byte tail (window).  Eviction (``max_flows``,
``idle_rounds``, ``fin_evict``, :meth:`evict`) only forgets carried state:
pending bytes are scanned first.

On the card an ``ac`` round is one ``ac_scan`` launch per ``width``-byte
chunk.  A ``window`` round has one layout: ragged sub-lanes, each flow
taking only the ``ceil(bytes / width)`` rows its own bytes need, counted in
one launch (more only past ``ROUND_BUDGET_BYTES``) by the halo kernel
(``ops/cuda_window.window_count_halo``) on a ``pallas`` matcher, or by its
plain form on a ``window`` matcher.  Counts stay on the device as int32
across rounds and drain to host int64 before they can wrap.

``sharded=True`` splits the flow lanes over a mesh (``mesh=``, default:
every device of the matcher's type): ``ac`` chunks through
``parallel/mesh.count_chunk_sharded`` (each shard scans its lanes from
their states), a ``window`` round's ragged sub-lanes through
``parallel/mesh.count_flow_round_sharded``.

``collect_offsets=True`` adds a find pass before each round
(``Matcher.find_matches`` over ``[tail | new bytes]`` rows, the
``window_find`` kernel on the card) whose kept triples, drained by
:meth:`FlowStreamMatcher.drain_offsets`, bincount to exactly the round's
counts: ``(flow key, offset in the reassembled stream, unique pattern)``.

:meth:`FlowStreamMatcher.save` and :meth:`FlowStreamMatcher.load` write and
read the JAX package's checkpoint file (the flow table, the tails or DFA
states, the pending and reorder state), so a checkpoint of either package
resumes in the other; the AC states are numbered alike and are checked on
load.

:func:`count_pcap_flows_streamed` is the flow monitor's whole pass, what
``match --flows --stream`` runs: captures read in ``iter_pcap`` chunks,
fed, flushed and counted.  Under ``torch.profiler`` it opens the spans of
``utils.timing.span``: ``msm.stream`` (one call), ``msm.ingest`` (each read
of the chunk iterator), ``msm.flow.feed`` (each :meth:`feed_pcap_slice`,
rounds included), ``msm.flow.layout`` (a round: tails, sub-lanes or the
``ac`` engine's padded lanes, fold, the find pass with ``collect_offsets``),
inside it ``msm.flow.reorder`` (with ``reorder``: the round's held segments
put in sequence order and trimmed, :meth:`_materialize_reorder`),
``msm.flow.dispatch`` (a launch's or a chunk's copies and launch) and
``msm.drain`` (device counts or states fetched to the host).
:data:`FLOWS` counts the rounds' stream and tile bytes and the feeds'
payload segments, those the grouped feed moved among them; with
``reorder`` also the segments and raw bytes held with their seq
(``reorder_segments``, ``reorder_held_bytes``), the segments a round placed
ahead of an earlier capture (``reorder_moved``) and the bytes it dropped as
already given (``reorder_trimmed_bytes``).
"""

from __future__ import annotations

import bisect
import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.io.flows import (
    _flow_geom,
    flow_keys,
    tcp_flags,
    tcp_seqs,
)
from multithreading_string_matching_tpu_torch.ops.scan import check_states, count_matches_ac
from multithreading_string_matching_tpu_torch.ops.window import window_count_halo_plain
from multithreading_string_matching_tpu_torch.parallel.mesh import (
    _staged_window,
    count_chunk_sharded,
    count_flow_round_sharded,
    make_mesh,
)
from multithreading_string_matching_tpu_torch.utils.timing import span

# Since import: stream bytes the scan rounds took (``real_bytes``) and bytes
# of the tiles handed to the matcher's device (``tile_bytes``: halos,
# padding and padding lanes included); their ratio is the rounds' lane
# fill.  Payload segments fed (``feed_segments``) and those the grouped
# feed moved (``grouped_segments``); their ratio is the share it takes.
# With ``reorder`` only: payload segments held with their seq
# (``reorder_segments``) and their raw bytes (``reorder_held_bytes``);
# segments a round placed ahead of a segment of their flow captured before
# them (``reorder_moved``); bytes a round dropped as already given, in its
# own overlaps or behind an earlier round's edge (``reorder_trimmed_bytes``).
FLOWS: Dict[str, int] = {"real_bytes": 0, "tile_bytes": 0, "feed_segments": 0,
                         "grouped_segments": 0, "reorder_segments": 0, "reorder_moved": 0,
                         "reorder_held_bytes": 0, "reorder_trimmed_bytes": 0}


def _pow2(x: int, floor: int) -> int:
    return max(floor, 1 << max(0, (x - 1).bit_length()))


class FlowStreamMatcher:
    # One launch's host tile budget: a ragged round past it splits its rows
    # over several launches; an ``ac`` round falls back to bounded per-chunk
    # tiles.  Class-level so tests can lower it.
    ROUND_BUDGET_BYTES = 64 << 20
    # The fewest payload segments a feed moves as one grouped plan: below
    # it nearly every segment is a flow of its own, and a Python step a
    # segment costs less than the plan's fixed numpy calls.  Class-level so
    # tests can lower it.
    GROUP_MIN_SEGMENTS = 96

    def __init__(
        self,
        matcher,
        mode: str = "tcp",
        *,
        engine: str = "ac",
        scan_bytes: int = 1 << 20,
        width: int = 2048,
        min_lanes: int = 128,
        sharded: bool = False,
        mesh=None,
        reorder: bool = False,
        ipv6: bool = False,
        vlan: bool = False,
        max_flows: Optional[int] = None,
        idle_rounds: Optional[int] = None,
        fin_evict: bool = False,
        collect_offsets: bool = False,
    ):
        self.matcher = matcher
        if mode not in ("udp", "tcp"):
            raise ValueError(f"mode must be 'udp' or 'tcp', got {mode!r}")
        if reorder and mode != "tcp":
            raise ValueError("reorder=True applies to TCP flows only")
        if fin_evict and mode != "tcp":
            # The flags offset of a UDP datagram is a payload byte.
            raise ValueError("fin_evict=True applies to TCP flows only")
        if engine not in ("ac", "window"):
            raise ValueError(f"unknown flow-stream engine {engine!r}: expected ac or window")
        if collect_offsets and engine != "window":
            raise ValueError(
                "collect_offsets=True needs engine='window' (the find "
                "pass reads the per-flow byte tail)"
            )
        if mesh is not None and not sharded:
            raise ValueError("mesh= is only meaningful with sharded=True")
        if max_flows is not None and max_flows < 1:
            raise ValueError("max_flows must be >= 1")
        # reorder=True: pending segments carry their TCP seq, and each round
        # lays them out in sequence order with first-bytes-win trimming
        # (io.flows.reorder_plan's rule).  The reorder window is one round:
        # a segment whose bytes an earlier round scanned is trimmed to its
        # new bytes, never re-inserted.
        self.reorder = reorder
        self._flow_reorder: dict = {}  # key -> (seq_base, covered)
        # ipv6=True: 37-byte version-tagged keys (io.flows.flow_keys); evict()
        # takes keys of the same space.  vlan=True skips up to two tags.
        self.ipv6 = ipv6
        self.vlan = vlan
        self.engine = engine
        self.mode = mode
        self.scan_bytes = scan_bytes
        self.width = width
        self.min_lanes = min_lanes
        self.sharded = sharded
        if sharded:
            # Flow lanes shard over the mesh: ac chunks split by lane, each
            # shard scanning its lanes from their states; window sub-lanes
            # split by row (lane tails are host state).  One sum merges the
            # counts.  Lane counts round up to the device count so the
            # shards are even.
            self.mesh = mesh if mesh is not None else make_mesh(
                device_type=matcher.device.type)
            self._n_dev = int(self.mesh.devices.size)
            self.min_lanes = max(min_lanes, self._n_dev)
        else:
            self.mesh = None
            self._n_dev = 1
        self._states: dict = {}      # ac: key -> DFA state; window: key -> (tail, fill)
        self._pending: dict = {}     # key -> bytearray, or [(seq, bytes)] with reorder
        self._pending_bytes = 0
        self._counts = np.zeros(len(matcher.patterns), np.int64)
        # Device accumulator: round counts (unique order) stay on the device
        # across rounds and drain to host int64 before the int32 can wrap
        # (under 2^30 scanned positions between drains).
        self._dev_counts: Optional[torch.Tensor] = None
        self._dev_pos = 0
        self.packets_seen = 0        # valid flow segments fed
        self.bytes_seen = 0
        # Eviction runs after each round, on flows whose pending bytes were
        # just scanned, so it only forgets carried state.
        self.max_flows = max_flows
        self.idle_rounds = idle_rounds
        self.fin_evict = fin_evict
        self._round = 0              # scan rounds completed
        self._last_active: dict = {} # key -> round of the last fed bytes
        self._closing: set = set()   # keys with a FIN or RST seen
        self.flows_evicted = 0
        # The find pass is host-driven, so it composes with sharded rounds.
        self.collect_offsets = collect_offsets
        self._flow_base: dict = {}   # key -> stream bytes already scanned
        self._offsets: list = []     # undrained (key, offset, unique) hits

    @property
    def flows_seen(self) -> int:
        return len(self._states) + sum(1 for k in self._pending if k not in self._states)

    def feed_pcap_slice(self, pcap) -> None:
        """Append each valid segment's payload to its flow's pending buffer
        (capture order, as io.flows; with ``reorder`` the TCP seq rides
        along and ordering happens at scan time).

        A feed of at least ``GROUP_MIN_SEGMENTS`` payload segments without
        ``reorder`` moves its bytes as one flow-major plan
        (:meth:`_feed_grouped`); a smaller one a segment at a time.  Both
        leave the same pending bytes, key order and bookkeeping."""
        # One geometry pass (VLAN walk + IHL reads) shared by keys, seqs and flags.
        geom = _flow_geom(pcap, self.ipv6, self.vlan)
        valid, keys, off, ln = flow_keys(pcap, self.mode, ipv6=self.ipv6, vlan=self.vlan,
                                         _geom=geom)
        seqs = None
        if self.reorder:
            seqs = tcp_seqs(pcap, valid, ipv6=self.ipv6, vlan=self.vlan, _geom=geom)
        if self.fin_evict:
            flags = tcp_flags(pcap, ipv6=self.ipv6, vlan=self.vlan, _geom=geom)
            # FIN | RST, seen on empty segments too (a bare FIN/ACK); the
            # flow closes after its pending bytes are scanned.
            self._closing.update(k.tobytes() for k in keys[valid & (flags & 0x05 != 0)])
        self.packets_seen += int(np.count_nonzero(valid))
        segs = np.flatnonzero(valid & (ln > 0))
        nbytes = int(ln[segs].sum())
        FLOWS["feed_segments"] += segs.size
        if seqs is not None:
            FLOWS["reorder_segments"] += segs.size
            FLOWS["reorder_held_bytes"] += nbytes
        if seqs is None and segs.size and segs.size >= self.GROUP_MIN_SEGMENTS:
            self._feed_grouped(pcap.buf, keys[segs], pcap.offsets[segs] + off[segs], ln[segs])
            FLOWS["grouped_segments"] += segs.size
        else:
            buf = pcap.buf
            for pkt in segs:
                n = int(ln[pkt])
                k = keys[pkt].tobytes()
                s = int(pcap.offsets[pkt] + off[pkt])
                if seqs is not None:
                    self._pending.setdefault(k, []).append((int(seqs[pkt]),
                                                            bytes(buf[s : s + n])))
                else:
                    self._pending.setdefault(k, bytearray()).extend(buf[s : s + n])
                self._last_active[k] = self._round
        self._pending_bytes += nbytes
        self.bytes_seen += nbytes
        if self._pending_bytes >= self.scan_bytes:
            self._scan()

    def _feed_grouped(self, buf, keys, src, lens) -> None:
        """Append the payload segments ``(keys[s], buf[src[s] :][: lens[s]])``,
        given in capture order, to their flows' pending buffers as one
        plan: the segments grouped by key with one sort over the key bytes
        packed into ``uint64`` words, the flows in order of first
        appearance and each flow's segments in capture order (io.flows'
        own plan), all bytes copied into one flow-major block by one
        ``native.scatter_segments`` (a numpy loop without the native
        library), then one ``extend`` a flow."""
        from multithreading_string_matching_tpu_torch.io import native

        S, kw = keys.shape
        words = np.zeros((S, -(-kw // 8) * 8), np.uint8)
        words[:, :kw] = keys
        words = words.view(np.uint64)
        order = np.lexsort(words.T)  # stable: capture order within a key
        sw = words[order]
        new = np.ones(S, bool)
        new[1:] = (sw[1:] != sw[:-1]).any(axis=1)
        starts = np.flatnonzero(new)                 # groups, in key order
        gid = np.cumsum(new) - 1
        len_s = lens[order].astype(np.int64)
        glen = np.add.reduceat(len_s, starts)
        first = order[starts]                        # each group's first segment
        by_seen = np.argsort(first)                  # groups in first-seen order
        base = np.empty(len(starts), np.int64)
        base[by_seen] = np.cumsum(glen[by_seen]) - glen[by_seen]
        cum = np.cumsum(len_s) - len_s
        dst = base[gid] + cum - cum[starts][gid]
        src_s = src[order].astype(np.int64)
        block = np.empty((1, int(glen.sum())), np.uint8)
        if native.available():
            native.scatter_segments(buf, src_s, len_s, np.zeros(S, np.int64), dst, block)
        else:
            flat = block[0]
            for s, d, n in zip(src_s.tolist(), dst.tolist(), len_s.tolist()):
                flat[d : d + n] = buf[s : s + n]
        mv = memoryview(block[0])
        raw = keys[first[by_seen]].tobytes()
        for i, (a, n) in enumerate(zip(base[by_seen].tolist(), glen[by_seen].tolist())):
            k = raw[i * kw : (i + 1) * kw]
            self._pending.setdefault(k, bytearray()).extend(mv[a : a + n])
            self._last_active[k] = self._round

    def _materialize_reorder(self) -> None:
        """Turn each flow's pending (seq, bytes) segments into the flat bytes
        a round scans: sequence order, first bytes win against the flow's
        carried coverage (io.flows.reorder_plan within the round).  Counts
        into ``FLOWS`` the segments placed ahead of one captured before
        them and the bytes dropped as already given."""
        moved = trimmed = 0
        for k, segs in list(self._pending.items()):
            if not isinstance(segs, list):
                continue
            raw = sum(len(b) for _, b in segs)
            st = self._flow_reorder.get(k)
            if st is None:
                s0 = segs[0][0]
                rels = [((sq - s0 + 2**31) % 2**32 - 2**31) for sq, _ in segs]
                base, covered = s0 + min(rels), 0
            else:
                base, covered = st
            rels = [((sq - base + 2**31) % 2**32 - 2**31) for sq, _ in segs]
            order = sorted(range(len(segs)), key=lambda i: (rels[i], i))
            if order != list(range(len(segs))):
                low = len(segs)  # the earliest capture placed after this one
                for i in reversed(order):
                    moved += i > low
                    low = min(low, i)
            out = bytearray()
            for i in order:
                r, b = rels[i], segs[i][1]
                end = r + len(b)  # before trimming: coverage moves to the true end
                if end <= covered:
                    continue  # pure retransmission of scanned bytes
                if r < covered:
                    b = b[covered - r :]  # overlap: first bytes won
                out += b
                covered = max(covered, end)
            # Re-base to the new edge, so rel values stay near 0 however long
            # the flow lives (a fixed base would leave the signed 2^31 window
            # after 2 GiB); a segment older than the edge lands at negative
            # rel and is dropped as before.
            self._flow_reorder[k] = ((base + covered) % 2**32, 0)
            self._pending_bytes += len(out) - raw
            self._pending[k] = out
            trimmed += raw - len(out)
        FLOWS["reorder_moved"] += moved
        FLOWS["reorder_trimmed_bytes"] += trimmed

    def _scan(self) -> None:
        had_bytes = self._pending_bytes > 0
        with span("msm.flow.layout"):
            self._scan_impl()
        if had_bytes:
            self._round += 1
            self._apply_eviction()

    def _apply_eviction(self) -> None:
        """After a round: FIN/RST closes, idle expiry, the max-flows cap."""
        def drop(doomed):
            # Count only flows whose state really goes (a bare FIN on a flow
            # that never carried payload holds none).
            self.flows_evicted += sum(1 for k in doomed if k in self._states)
            self.evict(doomed)

        if self._closing:
            doomed = [k for k in self._closing if k not in self._pending]
            drop(doomed)
            self._closing.difference_update(doomed)
        if self.idle_rounds is not None:
            # Strictly more than idle_rounds idle rounds: a flow fed in the
            # round just scanned has age 1 after the increment.
            doomed = [k for k, r in self._last_active.items()
                      if self._round - r > self.idle_rounds and k not in self._pending]
            drop(doomed)
        if self.max_flows is not None and len(self._states) > self.max_flows:
            by_age = sorted(self._states, key=lambda k: self._last_active.get(k, -1))
            drop(by_age[: len(self._states) - self.max_flows])

    # Find-pass column stride (new bytes per slice): bounds the find pass's
    # tile for skewed rounds; H context columns overlap between slices.
    # Class-level so tests can lower it.
    OFFSET_CHUNK = 1 << 20

    def _collect_round_offsets(self, flows) -> None:
        """One find pass over ``[tail | new bytes]`` rows, keeping matches
        whose end falls in the new bytes and whose start is at or past the
        fabricated zeros: the halo count's own (min_start, min_end) rule,
        so the kept triples bincount to exactly this round's counts.
        Offsets are positions in the flow's reassembled stream (``base +
        row_start - H``)."""
        if not flows:
            return
        wp = self.matcher.window
        H = max(int(wp.max_len) - 1, 1)
        # The stride covers the halo: past the first slice min_start is 0,
        # which holds while every slice's context lies past the zeros.
        S = max(self.OFFSET_CHUNK, H)
        ulens = np.array([len(p) for p in wp.unique_patterns], np.int64)
        rows_src = []
        fills = np.zeros(len(flows), np.int64)
        for i, k in enumerate(flows):
            tail, fl = self._states.get(k, (b"", 0))
            # Stored tails hold exactly ``fl`` real bytes; zeros pad the
            # context to H columns (min_start drops starts inside them).
            rows_src.append(b"\x00" * (H - fl) + bytes(tail) + bytes(self._pending[k]))
            fills[i] = fl
        longest_new = max(len(r) - H for r in rows_src)
        for c in range(0, longest_new, S):
            sl = [r[c : c + H + S] for r in rows_src]
            lens = np.array([len(x) for x in sl], np.int32)
            mat = np.zeros((len(sl), int(lens.max())), np.uint8)
            for i, x in enumerate(sl):
                mat[i, : len(x)] = np.frombuffer(x, np.uint8)
            rows = self.matcher.find_matches(mat, lens)
            for fi, st, u in rows.tolist():
                min_start = (H - int(fills[fi])) if c == 0 else 0
                if st < min_start or st + int(ulens[u]) <= H:
                    continue
                base = self._flow_base.get(flows[fi], 0)
                self._offsets.append((flows[fi], base + c + st - H, u))
        for k in flows:
            self._flow_base[k] = self._flow_base.get(k, 0) + len(self._pending[k])

    def drain_offsets(self):
        """Return (and clear) the accumulated ``(key_bytes, stream_offset,
        unique_pattern_idx)`` triples of ``collect_offsets=True``.  Offsets
        index the flow's reassembled stream; render keys with
        :func:`io.flows.key_tuple_bytes`; the pattern bytes are
        ``matcher.window.unique_patterns``."""
        out = self._offsets
        self._offsets = []
        return out

    def _use_halo_kernel(self) -> bool:
        """A ``window`` round's ragged rows take the halo kernel when the
        matcher's engine resolves to ``pallas`` (its plain version on a CPU
        matcher); a ``window`` matcher, and an ``ac``/``kmp`` one, take the
        kernel's plain form over the same rows."""
        if self.matcher.engine in ("ac", "kmp"):
            return False
        return self.matcher._resolve_engine(None) == "pallas"

    def _device_tile(self, a: np.ndarray) -> torch.Tensor:
        # A copy from pageable host memory: the host buffer may be reused as
        # soon as this returns, even though the kernel runs later.
        return torch.tensor(np.ascontiguousarray(a), device=self.matcher.device)

    def _scan_impl(self) -> None:
        if not self._pending_bytes:
            self._pending.clear()
            return
        if self.reorder:
            with span("msm.flow.reorder"):
                self._materialize_reorder()
            if not self._pending_bytes:  # everything was retransmission
                self._pending.clear()
                return
        flows = [k for k, b in self._pending.items() if b]
        if self.collect_offsets:
            # Before any tail or pending change: the find pass reads the
            # tails from before the round next to the pending bytes.
            self._collect_round_offsets(flows)
        lens = np.array([len(self._pending[k]) for k in flows], np.int64)
        FLOWS["real_bytes"] += int(lens.sum())
        if self.engine == "ac":
            self._ac_round(flows, lens)
            return
        H = max(int(self.matcher.window.max_len) - 1, 1)
        self._ragged_round(flows, lens, H)
        self._store_tails(flows, H)

    def _lanes(self, lens):
        """The padded lane geometry of an ``ac`` round, the only one that
        takes the chunk loop: ``(F, rel_all, longest, long_q)``, ``F`` a
        power of two of at least ``min_lanes`` and a multiple of the device
        count (sharded lanes split evenly)."""
        F = _pow2(len(lens), self.min_lanes)
        F = -(-F // self._n_dev) * self._n_dev
        rel_all = np.zeros(F, np.int64)
        rel_all[: len(lens)] = lens
        longest = int(lens.max())
        return F, rel_all, longest, -(-longest // self.width) * self.width

    def _halos(self, flows, H: int):
        """``(uint8[F, H] halos, int32[F] fills)`` of the ``F`` flows: each
        flow's stored tail right-aligned, so the fabricated zeros are the
        first ``H - fill`` columns."""
        halo_b = np.zeros((len(flows), H), np.uint8)
        fill_v = np.zeros(len(flows), np.int32)
        for i, k in enumerate(flows):
            tail, fl = self._states.get(k, (b"", 0))
            if fl:
                halo_b[i, H - fl :] = np.frombuffer(tail, np.uint8)
                fill_v[i] = fl
        return halo_b, fill_v

    def _chunk_loop(self, flows, F: int, longest: int, long_q: int, step) -> None:
        """Scan an ``ac`` round in ``width``-column chunks, ``step(tile, c)``
        giving each chunk's expanded counts: one padded round buffer sliced
        by columns, or, past the budget (one huge flow padding every lane), a
        fresh tile per chunk with bounded memory."""
        padded = None
        if F * long_q <= max(self.ROUND_BUDGET_BYTES, F * self.width):
            padded = np.zeros((F, long_q), np.uint8)
            for i, k in enumerate(flows):
                b = self._pending[k]
                padded[i, : len(b)] = np.frombuffer(b, np.uint8)
        # Sum on the device and fetch once per round while the round's
        # positions fit int32; else fetch per chunk into host int64.
        device_acc = padded is not None and F * long_q < 2**31
        round_counts = None
        for c in range(0, longest, self.width):
            if padded is not None:
                tile = padded[:, c : c + self.width]
            else:
                tile = np.zeros((F, self.width), np.uint8)
                for i, k in enumerate(flows):
                    seg = self._pending[k][c : c + self.width]
                    tile[i, : len(seg)] = np.frombuffer(seg, np.uint8)
            FLOWS["tile_bytes"] += tile.nbytes
            with span("msm.flow.dispatch"):
                counts = step(tile, c)
            if device_acc:
                round_counts = counts if round_counts is None else round_counts + counts
            else:
                with span("msm.drain"):
                    self._counts += counts.cpu().numpy().astype(np.int64)
        if round_counts is not None:
            with span("msm.drain"):
                self._counts += round_counts.cpu().numpy().astype(np.int64)

    def _ac_round(self, flows, lens) -> None:
        """One ``ac`` round: the chunk loop with each lane's DFA state carried
        on the device from chunk to chunk (a lane past its bytes holds its
        state), then each flow's final state stored for the next round."""
        F, rel_all, longest, long_q = self._lanes(lens)
        states = np.zeros(F, np.int32)
        for i, k in enumerate(flows):
            states[i] = self._states.get(k, 0)
        cac, dup = self.matcher.cac, self.matcher.ac.dup_map
        # Checked once here, on the host: from here on the states are the
        # kernel's own, and a check a chunk would wait for the card.
        check_states(states, cac.dead)
        states_v = torch.from_numpy(states).to(self.matcher.device)
        fold = self.matcher._maybe_fold

        def step(tile, c):
            nonlocal states_v
            rel = np.clip(rel_all - c, 0, self.width).astype(np.int32)
            if self.sharded:
                counts, states_v = count_chunk_sharded(cac, fold(tile), rel, states_v,
                                                       self.mesh, dup_map=dup, check=False)
            else:
                counts, states_v = count_matches_ac(cac, fold(tile), rel,
                                                    initial_states=states_v, dup_map=dup,
                                                    return_states=True, check=False)
            return counts

        self._chunk_loop(flows, F, longest, long_q, step)
        with span("msm.drain"):
            final = states_v.cpu().numpy()
        for i, k in enumerate(flows):
            self._states[k] = int(final[i])
        self._pending.clear()
        self._pending_bytes = 0

    def _store_tails(self, flows, H: int) -> None:
        """Each scanned flow's tail from the host bytes, never the device
        carry: a lane that ended mid-chunk carries zero padding there, which
        would break the flow if it came back.  Then clear the round."""
        for k in flows:
            prev_tail, prev_fill = self._states.get(k, (b"", 0))
            new = self._pending[k]
            tail = bytes(new[-H:]) if len(new) >= H else (prev_tail + bytes(new))[-H:]
            self._states[k] = (tail, min(H, prev_fill + len(new)))
        self._pending.clear()
        self._pending_bytes = 0

    def _ragged_tiles(self, flows, lens, H: int) -> Iterator:
        """The round as ragged sub-lanes, one ``(x uint8[r, H + width], eff
        int32[r], min_start int32[r])`` slice a launch, each built when it
        is asked for.

        Flow i's ``[H-byte halo | n_i pending bytes]`` string, the halo its
        stored tail, is cut into ``ceil(n_i / width)`` rows: row j holds the
        string from column ``j * width``, its first H bytes the bytes before
        its body.  A match counts in the row its end falls in (``min_end =
        H``) and never starts in the halo's fabricated zeros (``min_start``),
        so the rows' total is that of the flows' whole strings.  Bytes past a
        row's ``eff`` are zeros.  Rows are independent, so slices of at most
        ``ROUND_BUDGET_BYTES`` (and 2^30 positions, under the drain guard)
        are exact."""
        W = self.width
        L = H + W
        rows = -(-lens // W)
        first = np.zeros(len(flows) + 1, np.int64)
        np.cumsum(rows, out=first[1:])
        flow_of = np.repeat(np.arange(len(flows)), rows)
        j = np.arange(int(first[-1])) - first[flow_of]
        halo_b, fill_v = self._halos(flows, H)
        eff = np.clip(lens[flow_of] + H - j * W, 0, L).astype(np.int32)
        ms = np.maximum(H - fill_v[flow_of] - j * W, 0).astype(np.int32)
        # Rows whose halo reaches back past their flow's first row in the
        # slice: one when width >= H, ceil(H / width) when narrower.
        n_fix = -(-H // W)
        fold = self.matcher._maybe_fold
        step = max(1, min(self.ROUND_BUDGET_BYTES, 2**30) // L)
        R = int(first[-1])
        first, lens = first.tolist(), lens.tolist()
        for r0 in range(0, R, step):
            r1 = min(r0 + step, R)
            # The slice's bodies back to back, H zeros in front: row r's
            # H + width bytes start at (r - r0) * width.
            ext = np.zeros(H + (r1 - r0) * W, np.uint8)
            placed = []
            for i in range(bisect.bisect_right(first, r0) - 1, bisect.bisect_left(first, r1)):
                pend, f0 = self._pending[flows[i]], first[i]
                a, b = max(f0, r0), min(first[i + 1], r1)
                src = (a - f0) * W
                n = min(lens[i], (b - f0) * W) - src
                dst = H + (a - r0) * W
                ext[dst : dst + n] = np.frombuffer(pend, np.uint8, n, src)
                placed.append((i, pend, a - r0, min(b, a + n_fix) - r0, src))
            x = np.lib.stride_tricks.as_strided(ext, (r1 - r0, L), (W, 1)).copy()
            for i, pend, ra, rb, jw in placed:
                for r in range(ra, rb):
                    if jw >= H:
                        x[r, :H] = np.frombuffer(pend, np.uint8, H, jw - H)
                    else:  # the stored tail's part, then the flow's first bytes
                        x[r, : H - jw] = halo_b[i, jw:]
                        x[r, H - jw : H] = np.frombuffer(pend, np.uint8, jw)
                    jw += W
            yield fold(x), eff[r0:r1], ms[r0:r1]

    def _ragged_round(self, flows, lens, H: int) -> None:
        """A ``window`` round: one launch a slice of ``_ragged_tiles``, the
        counts summed on the device.  The counter follows what the round
        can observe: with ``sharded`` the slice's rows split over the mesh
        (``count_flow_round_sharded``); else the halo kernel when the matcher
        resolves to ``pallas`` (its plain version on a CPU matcher), or the
        kernel's plain form with the matcher's window tables on its device."""
        use_halo = self._use_halo_kernel()
        for x, eff, ms in self._ragged_tiles(flows, lens, H):
            FLOWS["tile_bytes"] += x.nbytes
            with span("msm.flow.dispatch"):
                if self.sharded:
                    counts = count_flow_round_sharded(self.matcher, x, eff, ms, self.mesh,
                                                      engine="pallas" if use_halo else "window")
                elif use_halo:
                    counts = self.matcher.halo_kernels.count_tile_halo(
                        self._device_tile(x), self._device_tile(eff), self._device_tile(ms))
                else:
                    counts = window_count_halo_plain(
                        self._device_tile(x), self._device_tile(eff), self._device_tile(ms), H,
                        _staged_window(self.matcher, self.matcher.device))
            self._acc_device(counts, positions=x.size)

    def _acc_device(self, counts: torch.Tensor, *, positions: int) -> None:
        self._dev_counts = counts if self._dev_counts is None else self._dev_counts + counts
        self._dev_pos += positions
        if self._dev_pos >= 2**30:
            self._drain_device()  # no int32 wrap between drains

    def _drain_device(self) -> None:
        if self._dev_counts is None:
            return
        with span("msm.drain"):
            c = self._dev_counts.cpu().numpy().astype(np.int64)
        self._counts += c[self.matcher.window.dup_map]
        self._dev_counts = None
        self._dev_pos = 0

    def flush(self) -> None:
        """Scan whatever is pending (end of capture, timer tick)."""
        self._scan()

    def counts(self) -> np.ndarray:
        """int64 totals over the original pattern list, not including
        unflushed pending bytes."""
        self._drain_device()
        return self._counts.copy()

    def _key_width(self) -> int:
        from multithreading_string_matching_tpu_torch.io.flows import (
            V4_KEY_BYTES,
            V6_KEY_BYTES,
        )

        return V6_KEY_BYTES if self.ipv6 else V4_KEY_BYTES

    def save(self, path) -> str:
        """Checkpoint EVERYTHING the stream carries — counts, per-flow
        engine state (DFA ints / window tails), pending bytes (reorder
        segment lists included), reorder coverage, eviction bookkeeping —
        so a killed process resumes to counts identical to the
        uninterrupted run (full-rollback semantics, the flow flavor of
        StreamMatcher.save).  allow_pickle=False-safe layout: keys as
        fixed-width uint8 rows, variable-length byte payloads as one blob
        plus offset/length columns."""
        self._drain_device()
        kw = self._key_width()

        def key_rows(ks):
            out = np.zeros((len(ks), kw), np.uint8)
            for i, k in enumerate(ks):
                out[i] = np.frombuffer(k, np.uint8)
            return out

        from multithreading_string_matching_tpu_torch.parallel.stream import (
            patterns_npz_fields,
        )

        state_keys = list(self._states)
        data = {
            **patterns_npz_fields(self.matcher.patterns),
            "engine": np.array(self.engine),
            "mode": np.array(self.mode),
            "flags": np.array(
                [int(self.reorder), int(self.ipv6), int(self.vlan),
                 int(self.collect_offsets)],
                np.int64,
            ),
            "counts": self._counts,
            "counters": np.array(
                [self.packets_seen, self.bytes_seen, self._round,
                 self.flows_evicted, self._pending_bytes], np.int64
            ),
            "state_keys": key_rows(state_keys),
        }
        if self.engine == "ac":
            data["state_vals"] = np.array(
                [self._states[k] for k in state_keys], np.int32
            )
        else:
            H = max(int(self.matcher.window.max_len) - 1, 1)
            tails = np.zeros((len(state_keys), H), np.uint8)
            fills = np.zeros(len(state_keys), np.int32)
            for i, k in enumerate(state_keys):
                tail, fl = self._states[k]
                if tail:
                    tails[i, : len(tail)] = np.frombuffer(tail, np.uint8)
                fills[i] = fl
                # invariant: len(tail) == fill (both min(H, total streamed))
            data["state_tails"] = tails
            data["state_fills"] = fills
        # Pending bytes as segments: flat flows contribute ONE segment with
        # seq 0; reorder flows one per held segment with its real seq.
        pend_keys = list(self._pending)
        blob = bytearray()
        seg_flow, seg_seq, seg_off, seg_len = [], [], [], []
        for i, k in enumerate(pend_keys):
            v = self._pending[k]
            segs = v if isinstance(v, list) else [(0, bytes(v))]
            for sq, b in segs:
                seg_flow.append(i)
                seg_seq.append(sq)
                seg_off.append(len(blob))
                seg_len.append(len(b))
                blob += b
        data["pend_keys"] = key_rows(pend_keys)
        data["pend_blob"] = np.frombuffer(bytes(blob), np.uint8)
        data["seg_flow"] = np.array(seg_flow, np.int64)
        data["seg_seq"] = np.array(seg_seq, np.int64)
        data["seg_off"] = np.array(seg_off, np.int64)
        data["seg_len"] = np.array(seg_len, np.int64)
        rkeys = list(self._flow_reorder)
        data["reorder_keys"] = key_rows(rkeys)
        data["reorder_vals"] = np.array(
            [self._flow_reorder[k] for k in rkeys], np.int64
        ).reshape(-1, 2)
        la = list(self._last_active.items())
        data["active_keys"] = key_rows([k for k, _ in la])
        data["active_rounds"] = np.array([r for _, r in la], np.int64)
        data["closing_keys"] = key_rows(sorted(self._closing))
        if self.collect_offsets:
            bk = list(self._flow_base)
            data["base_keys"] = key_rows(bk)
            data["base_vals"] = np.array(
                [self._flow_base[k] for k in bk], np.int64
            )
            data["off_keys"] = key_rows([k for k, _, _ in self._offsets])
            data["off_vals"] = np.array(
                [(o, u) for _, o, u in self._offsets], np.int64
            ).reshape(-1, 2)
        np.savez(path, **data)
        path = str(path)
        return path if path.endswith(".npz") else path + ".npz"

    def load(self, path) -> None:
        """Full rollback to a checkpoint: every accumulator and per-flow
        state REPLACED (resuming onto a used instance must not
        double-count).  The checkpoint must match this instance's
        patterns, engine, mode, and reorder/ipv6 configuration; AC states
        outside ``[0, dead]`` are refused with ``ValueError`` and leave the
        stream as it was."""
        from multithreading_string_matching_tpu_torch.parallel.stream import (
            checkpoint_path,
            patterns_from_npz,
        )

        data = np.load(checkpoint_path(path), allow_pickle=False)
        if patterns_from_npz(data) != self.matcher.patterns:
            raise ValueError("checkpoint pattern list does not match matcher")
        if str(data["engine"]) != self.engine or str(data["mode"]) != self.mode:
            raise ValueError(
                "checkpoint engine/mode does not match this stream "
                f"({data['engine']}/{data['mode']} vs "
                f"{self.engine}/{self.mode})"
            )
        fl = data["flags"].tolist()
        while len(fl) < 4:  # pre-vlan / pre-offsets checkpoints = off
            fl.append(0)
        if fl != [int(self.reorder), int(self.ipv6), int(self.vlan),
                  int(self.collect_offsets)]:
            raise ValueError(
                "checkpoint reorder/ipv6/vlan/offsets configuration does "
                "not match"
            )
        if self.engine == "ac":
            # The states restart scans: the start-state check of ops/scan,
            # before anything of this stream changes.
            check_states(np.asarray(data["state_vals"], np.int64), self.matcher.cac.dead)
        self._dev_counts = None
        self._dev_pos = 0
        self._counts = np.asarray(data["counts"]).astype(np.int64)
        (self.packets_seen, self.bytes_seen, self._round,
         self.flows_evicted, self._pending_bytes) = (
            int(x) for x in data["counters"]
        )
        skeys = [bytes(r) for r in data["state_keys"]]
        if self.engine == "ac":
            self._states = {
                k: int(v) for k, v in zip(skeys, data["state_vals"])
            }
        else:
            self._states = {
                k: (bytes(t[: int(f)]), int(f))
                for k, t, f in zip(
                    skeys, data["state_tails"], data["state_fills"]
                )
            }
        blob = data["pend_blob"].tobytes()
        pkeys = [bytes(r) for r in data["pend_keys"]]
        self._pending = {}
        for fi, sq, off, ln in zip(
            data["seg_flow"], data["seg_seq"], data["seg_off"],
            data["seg_len"],
        ):
            k = pkeys[int(fi)]
            b = blob[int(off) : int(off) + int(ln)]
            if self.reorder:
                self._pending.setdefault(k, []).append((int(sq), b))
            else:
                self._pending.setdefault(k, bytearray()).extend(b)
        self._flow_reorder = {
            bytes(r): (int(v[0]), int(v[1]))
            for r, v in zip(data["reorder_keys"], data["reorder_vals"])
        }
        self._last_active = {
            bytes(r): int(v)
            for r, v in zip(data["active_keys"], data["active_rounds"])
        }
        self._closing = {bytes(r) for r in data["closing_keys"]}
        self._flow_base = {}
        self._offsets = []
        if self.collect_offsets:
            self._flow_base = {
                bytes(r): int(v)
                for r, v in zip(data["base_keys"], data["base_vals"])
            }
            self._offsets = [
                (bytes(r), int(o), int(u))
                for r, (o, u) in zip(data["off_keys"], data["off_vals"])
            ]

    def reload(self, matcher) -> np.ndarray:
        """Swap the pattern set mid-stream (the flow monitor's rule update).

        Scans everything pending under the current rules, returns their
        final counts, and re-arms for ``matcher``: counts reset; tracked
        flows, eviction bookkeeping, reorder coverage and stream bases
        persist.  A window flow's tail is trimmed to the new ``max_len -
        1``, so a match across the swap is found when it fits the shorter of
        the two halos; an ac flow's DFA state cannot map between automata
        and restarts at the root (a match in progress at the swap is
        missed).  With ``collect_offsets``, undrained triples index the
        old pattern set: reload raises after its flush until they are
        drained (the stream stays usable)."""
        self.flush()
        if self.collect_offsets and self._offsets:
            raise ValueError(
                "undrained offsets from the old rule set: call "
                "drain_offsets() before reload()"
            )
        final = self.counts()
        self.matcher = matcher
        self._counts = np.zeros(len(matcher.patterns), np.int64)
        if self.engine == "window":
            H = max(int(matcher.window.max_len) - 1, 1)
            self._states = {k: (tail[-H:], min(fl, H)) for k, (tail, fl) in self._states.items()}
        else:
            self._states = {k: 0 for k in self._states}
        return final

    def evict(self, keys) -> None:
        """Drop carried state and pending bytes of the given flow keys (the
        hook for idle or FIN eviction); a flow that comes back starts anew."""
        for k in keys:
            self._states.pop(k, None)
            self._flow_reorder.pop(k, None)
            self._last_active.pop(k, None)
            # A flow that comes back restarts at stream offset 0.
            self._flow_base.pop(k, None)
            b = self._pending.pop(k, None)
            if b:
                self._pending_bytes -= (
                    sum(len(s) for _, s in b) if isinstance(b, list) else len(b)
                )


def flow_stream_engine(matcher) -> str:
    """The engine ``match --flows --stream`` gives the flow monitor (the JAX
    CLI's choice): an explicit ``window`` matcher anywhere, a ``pallas`` or
    ``auto`` one that resolves to the window family on the card take the
    ``window`` rounds; the rest the AC scan (the CPU's default)."""
    if matcher.engine == "window":
        return "window"
    if (matcher.engine in ("pallas", "auto") and matcher.device.type == "cuda"
            and matcher._resolve_engine(None) in ("pallas", "window")):
        return "window"
    return "ac"


def _capture_chunks(paths, batch_packets: int, host_workers: int = 0) -> Iterator:
    """``iter_pcap`` chunks of every path in turn; with ``host_workers`` the
    next chunk parses on a background thread (in order: reassembly needs
    capture order)."""
    # Looked up at each call, so that a caller's replacement of
    # ``io.pcap.iter_pcap`` (a pipe's reader in tests) is the one used.
    from multithreading_string_matching_tpu_torch.io.pcap import iter_pcap

    for path in paths:
        chunks = iter_pcap(path, batch_packets=batch_packets)
        if host_workers:
            from multithreading_string_matching_tpu_torch.parallel.host import prefetch_iter

            chunks = prefetch_iter(chunks, depth=max(2, host_workers))
        yield from chunks


def count_pcap_flows_streamed(
    fs: FlowStreamMatcher,
    paths,
    *,
    batch_packets: int = 8192,
    host_workers: int = 0,
    before_chunk: Optional[Callable[[FlowStreamMatcher], None]] = None,
    after_feed: Optional[Callable[[FlowStreamMatcher], None]] = None,
) -> np.ndarray:
    """The flow monitor ``fs`` over whole captures: int64 counts over the
    original pattern list of every flow's reassembled stream.

    ``paths`` (one path or a list, ``-`` for standard input) stream in
    ``iter_pcap`` chunks of ``batch_packets`` into ``fs``; after the last
    chunk the pending bytes are flushed.  ``before_chunk(fs)`` runs before
    each chunk's feed (a rules reload), ``after_feed(fs)`` after each feed
    and after the flush (offsets drained as their rounds finish)."""
    with span("msm.stream"):
        if isinstance(paths, (str, bytes, os.PathLike)):
            paths = [paths]
        chunks = _capture_chunks(paths, batch_packets, host_workers)
        while True:
            with span("msm.ingest"):
                chunk = next(chunks, None)
            if chunk is None:
                break
            if before_chunk is not None:
                before_chunk(fs)
            with span("msm.flow.feed"):
                fs.feed_pcap_slice(chunk)
            if after_feed is not None:
                after_feed(fs)
        fs.flush()
        if after_feed is not None:
            after_feed(fs)
        return fs.counts()
