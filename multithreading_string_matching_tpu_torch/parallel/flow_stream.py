"""Flow-aware streaming: per-flow carried byte halos across feeds.

Counterpart of ``multithreading_string_matching_tpu/parallel/flow_stream.py``
with its ``window`` engine.  A per-packet scan cannot see a signature split
across two segments of one connection.  :class:`FlowStreamMatcher` appends
each flow's segments to a pending buffer, and each scan round lays the
active flows out as lanes ``[H-byte tail | new bytes]``, ``H = max_len - 1``.
A match counts in the round its last byte falls in (``min_end = H``), and
never starts in the zeros in front of a young flow's tail (``min_start``),
so a match across any boundary (segment, feed, scan round) counts once,
equal to the concatenated-flow oracle.

Memory: pending bytes are bounded by ``scan_bytes`` (a round fires once a
feed leaves more, and at :meth:`flush`); between rounds a flow costs its
``H``-byte tail.  Eviction (``max_flows``, ``idle_rounds``, ``fin_evict``,
:meth:`evict`) only forgets carried state: pending bytes are scanned first.

On the card a round is one launch of the halo kernel
(``ops/cuda_window.window_count_halo``) over the round re-laid as
fixed-width sub-lanes; the matcher's ``window`` engine takes the plain
version on its device.  Counts stay on the device as int32 across rounds
and drain to host int64 before they can wrap.

``sharded=True`` splits each single-dispatch round's sub-lanes over a mesh
(``mesh=``, default: every device of the matcher's type) through
``parallel/mesh.count_flow_round_sharded``; the chunk loop stays on the
matcher's device, as in the JAX package.

Not yet ported (ROADMAP): ``engine="ac"`` (``ops/scan.py``), sharded or
not, ``collect_offsets=True`` (``find_matches``) and ``save``/``load``
(``parallel/stream.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.io.flows import (
    _flow_geom,
    flow_keys,
    tcp_flags,
    tcp_seqs,
)
from multithreading_string_matching_tpu_torch.ops.window import StreamHalo, window_stream_chunk


def _pow2(x: int, floor: int) -> int:
    return max(floor, 1 << max(0, (x - 1).bit_length()))


class FlowStreamMatcher:
    # One round's padded host buffer budget; past it the round falls back
    # to bounded per-chunk tiles (one huge flow padding every lane).
    # Class-level so tests can lower it.
    ROUND_BUDGET_BYTES = 64 << 20

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
        if engine == "ac":
            raise NotImplementedError(
                "flow-stream engine 'ac' is not yet ported to the torch package "
                "(ROADMAP Queue 1 item 6: ops/scan.py); use engine='window'"
            )
        if mesh is not None and not sharded:
            raise ValueError("mesh= is only meaningful with sharded=True")
        if collect_offsets:
            raise NotImplementedError(
                "collect_offsets is not yet ported to the torch package "
                "(ROADMAP next modules: find_matches)"
            )
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
            # Flow lanes shard over the mesh: each round's sub-lanes split by
            # row, one sum merges the counts; lane tails are host state, so
            # no state crosses rounds on a device.  Lane counts round up to
            # the device count so the shards are even.
            from multithreading_string_matching_tpu_torch.parallel.mesh import make_mesh

            self.mesh = mesh if mesh is not None else make_mesh(
                device_type=matcher.device.type)
            self._n_dev = int(self.mesh.devices.size)
            self.min_lanes = max(min_lanes, self._n_dev)
        else:
            self.mesh = None
            self._n_dev = 1
        self._states: dict = {}      # key -> (tail bytes, real fill)
        self._pending: dict = {}     # key -> bytearray, or [(seq, bytes)] with reorder
        self._pending_bytes = 0
        self._counts = np.zeros(len(matcher.patterns), np.int64)
        # Device accumulator: round counts (unique order) stay on the device
        # across rounds and drain to host int64 before the int32 can wrap
        # (under 2^30 scanned positions between drains).
        self._dev_counts: Optional[torch.Tensor] = None
        self._dev_pos = 0
        self._round_positions = 0
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

    @property
    def flows_seen(self) -> int:
        return len(self._states) + sum(1 for k in self._pending if k not in self._states)

    def feed_pcap_slice(self, pcap) -> None:
        """Append each valid segment's payload to its flow's pending buffer
        (capture order, as io.flows; with ``reorder`` the TCP seq rides
        along and ordering happens at scan time)."""
        # One geometry pass (VLAN walk + IHL reads) shared by keys, seqs and flags.
        geom = _flow_geom(pcap, self.ipv6, self.vlan)
        valid, keys, off, ln = flow_keys(pcap, self.mode, ipv6=self.ipv6, vlan=self.vlan,
                                         _geom=geom)
        seqs = flags = None
        if self.reorder:
            seqs = tcp_seqs(pcap, valid, ipv6=self.ipv6, vlan=self.vlan, _geom=geom)
        if self.fin_evict:
            flags = tcp_flags(pcap, ipv6=self.ipv6, vlan=self.vlan, _geom=geom)
        buf = pcap.buf
        for pkt in np.flatnonzero(valid):
            n = int(ln[pkt])
            self.packets_seen += 1
            k = None
            if flags is not None and flags[pkt] & 0x05:  # FIN | RST
                # Seen on empty segments too (a bare FIN/ACK); the flow
                # closes after its pending bytes are scanned.
                k = keys[pkt].tobytes()
                self._closing.add(k)
            if not n:
                continue
            if k is None:
                k = keys[pkt].tobytes()
            s = int(pcap.offsets[pkt] + off[pkt])
            if seqs is not None:
                self._pending.setdefault(k, []).append((int(seqs[pkt]), bytes(buf[s : s + n])))
            else:
                self._pending.setdefault(k, bytearray()).extend(buf[s : s + n])
            self._pending_bytes += n
            self.bytes_seen += n
            self._last_active[k] = self._round
        if self._pending_bytes >= self.scan_bytes:
            self._scan()

    def _materialize_reorder(self) -> None:
        """Turn each flow's pending (seq, bytes) segments into the flat bytes
        a round scans: sequence order, first bytes win against the flow's
        carried coverage (io.flows.reorder_plan within the round)."""
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

    def _scan(self) -> None:
        had_bytes = self._pending_bytes > 0
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

    def _use_halo_kernel(self) -> bool:
        """Rounds take the halo kernel when the matcher's engine resolves to
        ``pallas`` (its plain version on a CPU matcher); the ``window``
        engine, and the unported ``ac``/``kmp`` matchers, take the plain
        window form, as the JAX package's XLA form does."""
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
            self._materialize_reorder()
            if not self._pending_bytes:  # everything was retransmission
                self._pending.clear()
                return
        flows = [k for k, b in self._pending.items() if b]
        F = _pow2(len(flows), self.min_lanes)
        # Sharded rounds split the lanes over the mesh: a device-count
        # multiple (a non-pow2 min_lanes or device count would not divide).
        F = -(-F // self._n_dev) * self._n_dev
        H = max(int(self.matcher.window.max_len) - 1, 1)
        halo_b = np.zeros((F, H), np.uint8)
        fill_v = np.zeros(F, np.int32)
        for i, k in enumerate(flows):
            tail, fl = self._states.get(k, (b"", 0))
            if fl:
                # Real tail bytes sit right-aligned: the fabricated zeros
                # are the first H - fill columns.
                halo_b[i, H - fl :] = np.frombuffer(tail, np.uint8)
                fill_v[i] = fl
        lens_arr = np.array([len(self._pending[k]) for k in flows], np.int64)
        longest = int(lens_arr.max())
        long_q = -(-longest // self.width) * self.width
        rel_all = np.zeros(F, np.int64)
        rel_all[: len(flows)] = lens_arr
        # The whole round in one dispatch when its padded buffer fits the
        # budget; widths round up to powers of two.
        round_q = max(self.width, 1 << max(0, (longest - 1).bit_length()))
        # Per-launch int32 bound: the sub-lane tile scans about
        # F * nch * (H + width) positions in one kernel, and a position
        # starts at most one match per pattern.  Past 2^31 the round takes
        # the chunk loop.
        nch_p = _pow2(max(1, -(-round_q // self.width)), 1)
        proj_positions = (F + 512) * nch_p * (H + self.width)
        if (F * round_q <= max(self.ROUND_BUDGET_BYTES, F * self.width)
                and proj_positions < 2**31):
            buf = np.zeros((F, round_q), np.uint8)
            for i, k in enumerate(flows):
                b = self._pending[k]
                buf[i, : len(b)] = np.frombuffer(bytes(b), np.uint8)
            counts_u = self._window_round(buf, rel_all.astype(np.int32), halo_b, fill_v)
            self._acc_device(counts_u, positions=self._round_positions)
            self._store_tails(flows, H)
            return
        # The chunk loop: one padded round buffer sliced by columns, or,
        # past the budget (one huge flow padding every lane), a fresh tile
        # per chunk with bounded memory.
        padded = None
        if F * long_q <= max(self.ROUND_BUDGET_BYTES, F * self.width):
            padded = np.zeros((F, long_q), np.uint8)
            for i, k in enumerate(flows):
                b = self._pending[k]
                padded[i, : len(b)] = np.frombuffer(bytes(b), np.uint8)
        # Sum on the device and fetch once per round while the round's
        # positions fit int32; else fetch per chunk into host int64.
        device_acc = padded is not None and F * long_q < 2**31
        round_counts = None
        # Stored tails are raw capture bytes: fold them like the chunks
        # (folding is idempotent).
        fold = self.matcher._maybe_fold
        halo = StreamHalo(self._device_tile(fold(halo_b)), self._device_tile(fill_v))
        halo_count = self.matcher.halo_kernels.count_tile_halo if self._use_halo_kernel() else None
        for c in range(0, longest, self.width):
            if padded is not None:
                tile = padded[:, c : c + self.width]
            else:
                tile = np.zeros((F, self.width), np.uint8)
                for i, k in enumerate(flows):
                    seg = self._pending[k][c : c + self.width]
                    tile[i, : len(seg)] = np.frombuffer(bytes(seg), np.uint8)
            counts, halo = window_stream_chunk(
                self.matcher.window, self._device_tile(fold(tile)),
                (rel_all - c).astype(np.int32), halo, halo_count=halo_count,
            )
            if device_acc:
                round_counts = counts if round_counts is None else round_counts + counts
            else:
                self._counts += counts.cpu().numpy().astype(np.int64)
        if round_counts is not None:
            self._counts += round_counts.cpu().numpy().astype(np.int64)
        self._store_tails(flows, H)

    def _store_tails(self, flows, H: int) -> None:
        """Each scanned flow's tail from the host bytes, never the device
        carry: a lane that ended mid-chunk carries zero padding there, which
        would break the flow if it came back.  Then clear the round."""
        for k in flows:
            prev_tail, prev_fill = self._states.get(k, (b"", 0))
            new = bytes(self._pending[k])
            self._states[k] = ((prev_tail + new)[-H:], min(H, prev_fill + len(new)))
        self._pending.clear()
        self._pending_bytes = 0

    def _expand_round_lanes(self, buf, rel, halo_b, fill_v, CW: int):
        """Re-lay a ``[F, W]`` round as sub-lanes of fixed width: ``([R, H +
        CW] tile, eff int32[R], ms int32[R])``, flow i's chunk j in row
        i*nch + j with the H bytes before its body as halo (overlapping
        views, one strided copy).  A match counts in the sub-lane its end
        falls in (min_end = H), so the tile's total equals the flat round's,
        and the kernel sees one narrow width with every row in parallel."""
        F, W = buf.shape
        H = max(int(self.matcher.window.max_len) - 1, 1)
        # pow2 sub-lane count; padding sub-lanes are zero with eff 0.
        nch = _pow2(max(1, -(-W // CW)), 1)
        x = np.zeros((F, H + nch * CW), np.uint8)
        x[:, :H] = halo_b
        x[:, H : H + W] = buf
        s0, s1 = x.strides
        sub = np.lib.stride_tricks.as_strided(x, shape=(F, nch, H + CW),
                                              strides=(s0, CW * s1, s1))
        x2 = np.ascontiguousarray(sub).reshape(F * nch, H + CW)
        i = np.repeat(np.arange(F), nch)
        j = np.tile(np.arange(nch), F)
        eff_abs = np.minimum(np.clip(rel, 0, None).astype(np.int64) + H, H + W)
        eff2 = np.clip(eff_abs[i] - j * CW, 0, H + CW).astype(np.int32)
        ms_abs = (H - fill_v).astype(np.int64)
        ms2 = np.clip(ms_abs[i] - j * CW, 0, None).astype(np.int32)
        return x2, eff2, ms2

    def _window_round(self, buf, rel, halo_b, fill_v) -> torch.Tensor:
        """One round in one dispatch: device int32[U] counts in build order
        (expanded at drain).  The halo kernel over the round re-laid as
        sub-lanes (``_expand_round_lanes``) when the matcher's engine is
        ``pallas``; else the plain window form over the flat round.  With
        ``sharded`` the sub-lanes split over the mesh, each shard running
        either form on its device."""
        fold = self.matcher._maybe_fold
        self._round_positions = buf.shape[0] * (buf.shape[1] + halo_b.shape[1])
        use_halo = self._use_halo_kernel()
        if use_halo or self.sharded:
            x2, eff2, ms2 = self._expand_round_lanes(fold(buf), rel, fold(halo_b), fill_v,
                                                     self.width)
            # The drain guard bounds the positions really scanned: the
            # sub-lane tile (pow2 nch, repeated halos) can be over twice
            # the flat round.
            self._round_positions = x2.shape[0] * x2.shape[1]
        if self.sharded:
            from multithreading_string_matching_tpu_torch.parallel.mesh import (
                count_flow_round_sharded,
            )

            return count_flow_round_sharded(self.matcher, x2, eff2, ms2, self.mesh,
                                            engine="pallas" if use_halo else "window")
        if use_halo:
            return self.matcher.halo_kernels.count_tile_halo(
                self._device_tile(x2), self._device_tile(eff2), self._device_tile(ms2))
        counts, _ = window_stream_chunk(
            self.matcher.window, self._device_tile(fold(buf)), rel,
            StreamHalo(self._device_tile(fold(halo_b)), self._device_tile(fill_v)),
            expand_duplicates=False,
        )
        return counts

    def _acc_device(self, counts: torch.Tensor, *, positions: int) -> None:
        self._dev_counts = counts if self._dev_counts is None else self._dev_counts + counts
        self._dev_pos += positions
        if self._dev_pos >= 2**30:
            self._drain_device()  # no int32 wrap between drains

    def _drain_device(self) -> None:
        if self._dev_counts is None:
            return
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

    def save(self, path) -> str:
        raise NotImplementedError(
            "flow-stream checkpoints are not yet ported to the torch package "
            "(ROADMAP Queue 1 item 9: parallel/stream.py)"
        )

    def load(self, path) -> None:
        raise NotImplementedError(
            "flow-stream checkpoints are not yet ported to the torch package "
            "(ROADMAP Queue 1 item 9: parallel/stream.py)"
        )

    def reload(self, matcher) -> np.ndarray:
        """Swap the pattern set mid-stream (the flow monitor's rule update).

        Scans everything pending under the current rules, returns their
        final counts, and re-arms for ``matcher``: counts reset; tracked
        flows, eviction bookkeeping and reorder coverage persist.  Each
        flow's tail is trimmed to the new ``max_len - 1``, so a match across
        the swap is found when it fits the shorter of the two halos."""
        self.flush()
        final = self.counts()
        self.matcher = matcher
        self._counts = np.zeros(len(matcher.patterns), np.int64)
        H = max(int(matcher.window.max_len) - 1, 1)
        self._states = {k: (tail[-H:], min(fl, H)) for k, (tail, fl) in self._states.items()}
        return final

    def evict(self, keys) -> None:
        """Drop carried state and pending bytes of the given flow keys (the
        hook for idle or FIN eviction); a flow that comes back starts anew."""
        for k in keys:
            self._states.pop(k, None)
            self._flow_reorder.pop(k, None)
            self._last_active.pop(k, None)
            b = self._pending.pop(k, None)
            if b:
                self._pending_bytes -= (
                    sum(len(s) for _, s in b) if isinstance(b, list) else len(b)
                )
