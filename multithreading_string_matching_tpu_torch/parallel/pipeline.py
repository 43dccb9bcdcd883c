"""Streamed packet counting: the batched task pipeline and the packed-tile
serving path.

Counterpart of ``multithreading_string_matching_tpu/parallel/pipeline.py``:
the counting paths and the attribution half (``scan_pcap_streamed``'s
``dump_path``/``offsets`` and ``dump_matches_streamed``).  Names,
signatures, defaults, error messages and ``stats`` keys are the JAX
package's.

The host is the producer (streamed ingest, decode, packing), the device the
consumer.  JAX overlaps them through asynchronous dispatch and a fresh
numpy buffer per tile.  Here every tile goes to the device through a
:class:`~multithreading_string_matching_tpu_torch.parallel.stager.TileStager`:
pinned host slots, copies on a copy stream, kernels on the current stream,
so the host packs tile k+1 while the card copies and scans tile k.  Counts
accumulate in int32 on the device and drain to host int64 before they can
wrap (``DRAIN_POSITIONS``); the drains and the final ``totals()`` are the
only host syncs of a pass.  With ``host_workers`` the ingest and decode
stages run on threads (parallel/host.py); every CUDA call stays on the
caller's thread.

Under ``torch.profiler`` the serving path's stages are spans
(``utils.timing.span``), one a batch or a tile, nested in time on the
caller's thread: ``msm.stream`` (one :func:`count_pcap_streamed` call),
``msm.ingest`` and ``msm.decode`` (each batch's read and record walk, its
header decode and payload gather; sequential ingest only: a profiler does
not record ``host_workers`` threads), ``msm.pack`` (:meth:`PackedTileCounter.add`)
and ``msm.drain`` (the accumulator's fetch), around the stager's
``msm.stage.*`` spans and the kernels' launch ranges.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
from multithreading_string_matching_tpu_torch.io.pcap import (
    PcapFile,
    PcapWriter,
    iter_pcap,
    slice_pcap,
)
from multithreading_string_matching_tpu_torch.ops.bucketing import pack_rows
from multithreading_string_matching_tpu_torch.ops.window import window_count
from multithreading_string_matching_tpu_torch.parallel.stager import TileStager
from multithreading_string_matching_tpu_torch.utils.timing import span

DEFAULT_BATCH = 100  # openmp_task.c:113

# Drain device-side int32 accumulators to host int64 after this many scanned
# positions: one position contributes at most one match per pattern, so the
# int32 can never wrap between drains (2x margin).  Module-level so overflow
# tests can lower it without scanning 2 GiB.
DRAIN_POSITIONS = 2**30


def _iter_pcap_paths(pcap_path, batch_packets):
    """Stream chunks from one source or a sequence of them (rotated captures).

    A source is a path, ``"-"``, or an open binary file object (the
    ``tcpdump -w - |`` pipe shape): anything with ``read`` is ONE source,
    not a sequence (iterating a file object would read it as lines)."""
    paths = (
        [pcap_path]
        if isinstance(pcap_path, (str, bytes, os.PathLike))
        or hasattr(pcap_path, "read")
        else list(pcap_path)
    )
    for p in paths:
        yield from iter_pcap(p, batch_packets=batch_packets)


def _next_pow2(x: int) -> int:
    return 1 << max(3, (x - 1).bit_length())


def _window_tile_fn(matcher, device):
    """``fn(payload, fill)``: a staged tile's int32 totals in pattern-file
    order through the plain window count (the ``window`` engine)."""
    from multithreading_string_matching_tpu_torch.parallel.mesh import _staged_window

    dup = torch.from_numpy(matcher.window.dup_map).to(device, torch.long)
    return lambda p, l: window_count(*_staged_window(matcher, p.device), p, l)[dup]


def _iter_extracted(
    pcap_path, mode, batch_packets, strict, vlan, ipv6, host_workers
):
    """Yield (chunk, extracted_batch) pairs in capture order.

    ``host_workers >= 1`` runs ingest in a prefetch thread and extraction on
    an ordered worker pool (parallel/host.py): the reference's
    producer/worker thread split (openmp_task.c:126-186) applied to the HOST
    stages, which release the GIL in their hot paths (file reads, the
    native record walk, the native decode/fill).  Order is preserved.
    0 = sequential (identical results either way).  Sequential ingest opens
    an ``msm.ingest`` span around each read of the chunk iterator (the read
    that finds the end included) and an ``msm.decode`` span around each
    extraction, both closed before the pair is yielded."""
    chunks = _iter_pcap_paths(pcap_path, batch_packets)
    if host_workers:
        from multithreading_string_matching_tpu_torch.parallel.host import (
            map_prefetch,
            prefetch_iter,
        )

        def ex(chunk):
            return chunk, extract_payloads(
                chunk, mode, strict=strict, vlan=vlan, ipv6=ipv6
            )

        yield from map_prefetch(
            ex, prefetch_iter(chunks, depth=max(2, host_workers)),
            workers=host_workers,
        )
        return
    while True:
        with span("msm.ingest"):
            chunk = next(chunks, None)
        if chunk is None:
            return
        with span("msm.decode"):
            batch = extract_payloads(chunk, mode, strict=strict, vlan=vlan, ipv6=ipv6)
        yield chunk, batch


def iter_batches(
    pcap: PcapFile,
    mode: str,
    batch_size: int,
    *,
    strict: bool = False,
    vlan: bool = False,
    ipv6: bool = False,
    fixed_len: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield fixed-shape (payloads[B, Lfix], lengths[B]) batches.

    ``fixed_len=None`` buckets each batch's byte axis to the next power of
    two (few distinct shapes); pass e.g. the snaplen for exactly one.
    """
    for start in range(0, pcap.num_packets, batch_size):
        part = slice_pcap(pcap, start, start + batch_size, copy=False)
        batch = extract_payloads(
            part, mode, strict=strict, vlan=vlan, ipv6=ipv6,
            keep_invalid=True, pad_n_to=batch_size,
        )
        payloads, lengths = batch.payloads, batch.lengths
        want = fixed_len or _next_pow2(payloads.shape[1])
        if payloads.shape[1] < want:
            payloads = np.pad(payloads, ((0, 0), (0, want - payloads.shape[1])))
        elif payloads.shape[1] > want:  # only when fixed_len undersized
            raise ValueError(
                f"payload length {payloads.shape[1]} exceeds fixed_len {want}"
            )
        yield payloads, lengths


def count_pcap_streamed(
    matcher,
    pcap_path,
    mode: str = "udp",
    *,
    batch_packets: int = 8192,
    tile_rows: int = 4096,
    pack_width: int = 2048,
    strict: bool = False,
    vlan: bool = False,
    ipv6: bool = False,
    engine: Optional[str] = None,
    stats: Optional[dict] = None,
    sharded: bool = False,
    mesh=None,
    shard_axis: str = "packets",
    sync_dispatch: bool = False,
    host_workers: int = 0,
) -> np.ndarray:
    """Production-rate streaming scan: bounded-memory ingest feeding the
    kernels through ONE fixed tile shape.

    The capture streams in (``iter_pcap``, ``batch_packets`` at a time),
    payloads sequence-pack into ``[tile_rows, pack_width]`` rows
    (0x00-separated: exact for NUL-free pattern sets, see
    ops/bucketing.pack_rows), and every full tile is staged and counted
    without waiting (:class:`PackedTileCounter`); one fetch at the end.
    Peak host memory is one ingest batch + the stager's slots, whatever the
    capture's size.  ``host_workers >= 1`` threads the host stages
    (:func:`_iter_extracted`); counts are identical.

    ``engine`` defaults to the matcher's engine: ``pallas`` (the kernels:
    on ``device="cpu"`` their plain versions), ``window`` (the plain window
    count), ``ac`` or ``kmp`` (the DFA scan kernels, ops/scan.py; sharded,
    ``kmp`` runs as ``ac``, as in the JAX package).  Pass a dict as
    ``stats`` to receive the engine that ran and the packet /
    valid-payload / byte totals.

    Payloads wider than ``pack_width`` go through ``matcher.count``;
    NUL-containing pattern sets (packing inexact) fall back to
    :func:`scan_pcap_streamed` entirely.  Counts equal the one-shot scan.

    ``sharded=True`` splits each tile over a mesh (parallel/mesh.py;
    default: every device of the matcher's type): ``shard_axis='packets'``
    its rows, ``'patterns'`` the rule set (each shard scans every tile with
    1/N of it, parallel/pattern_shard.py), ``'both'`` a 2-D mesh.
    """
    with span("msm.stream"):
        if mesh is not None and not sharded:
            raise ValueError("mesh= is only meaningful with sharded=True")
        if shard_axis not in ("packets", "patterns", "both"):
            raise ValueError(f"unknown shard_axis {shard_axis!r}")
        if any(0 in p for p in matcher.window.unique_patterns):
            if sync_dispatch:
                # The blocking-schedule measurement mode only exists on the
                # packed-tile path; silently timing the per-row fallback would
                # report a fictitious "overlap gain".
                raise ValueError(
                    "sync_dispatch requires the packed-tile path (NUL-free "
                    "patterns); this set falls back to the per-row scanner"
                )
            # Packing is inexact for NUL-containing patterns; the per-row
            # streamed scanner is still bounded-memory and fills the stats.
            return scan_pcap_streamed(
                matcher, pcap_path, mode,
                batch_packets=batch_packets,
                strict=strict, vlan=vlan, ipv6=ipv6, stats=stats,
                sharded=sharded, mesh=mesh, shard_axis=shard_axis,
                host_workers=host_workers,
            )
        counter = PackedTileCounter(
            matcher, engine=engine, tile_rows=tile_rows, pack_width=pack_width,
            sharded=sharded, mesh=mesh, shard_axis=shard_axis,
            sync_dispatch=sync_dispatch,
        )
        if stats is not None:
            # The engine the counter ACTUALLY resolved, so CLI blobs echo it.
            stats["engine_resolved"] = counter.engine
            if host_workers:
                stats["host_workers"] = host_workers
        n_packets = n_valid = n_bytes = 0
        for _chunk, batch in _iter_extracted(
            pcap_path, mode, batch_packets, strict, vlan, ipv6, host_workers
        ):
            n_packets += batch.num_packets
            n_valid += int(batch.valid.sum())
            n_bytes += batch.total_payload_bytes
            counter.add(batch.payloads, batch.lengths)
        if stats is not None:
            stats.update(
                packets=n_packets, valid_payloads=n_valid, payload_bytes=n_bytes
            )
        counts = counter.totals()
        if counts.size and counts.max() > np.iinfo(np.int32).max:
            return counts  # beyond int32: return the exact int64 totals
        return counts.astype(np.int32)


class PackedTileCounter:
    """Fixed-shape packed-tile scan accumulator: the serving engine behind
    :func:`count_pcap_streamed`.

    Feed ``(payloads, lengths)`` groups of any size through :meth:`add`;
    rows sequence-pack (ops/bucketing.pack_rows, 0x00-separated) straight
    into a pinned slot of :attr:`stager`, and every FULL tile is copied and
    counted without waiting for it, so the per-launch cost amortizes over
    the tile however small the feeds are.  Payloads wider than
    ``pack_width`` route through ``matcher.count``; device int32
    accumulators drain to host int64 before they can wrap
    (``DRAIN_POSITIONS``).

    Count-exactness requires NUL-free patterns (callers guard).
    :meth:`totals` is safe to call repeatedly mid-stream: it flushes the
    partial tile, drains, and returns exact int64 counts over the original
    pattern list.
    """

    def __init__(
        self,
        matcher,
        *,
        engine: Optional[str] = None,
        tile_rows: int = 4096,
        pack_width: int = 2048,
        sharded: bool = False,
        mesh=None,
        shard_axis: str = "packets",
        sync_dispatch: bool = False,
    ):
        # sync_dispatch=True waits for every tile's counts before packing
        # the next: it DISABLES the overlap of host packing with the
        # device's copy and scan.  It exists so benches can MEASURE that
        # overlap: the async/sync end-to-end ratio is the pipelining gain.
        self._sync_dispatch = sync_dispatch
        self.matcher = matcher
        engine = matcher._requested_engine(engine)
        self.sharded = sharded
        self.pack_width = pack_width
        self._pattern_plan = None
        self._row_quantum = 1       # a dispatched tile's rows divide into it
        device = matcher.device
        dev_type = matcher.device.type
        if sharded and (
            shard_axis in ("patterns", "both")
            or (mesh is not None and "patterns" in mesh.axis_names)
        ):
            # PATTERN-axis sharding (parallel/pattern_shard.py): every shard
            # scans the full tile with 1/N of the rule set; the device
            # accumulator stays in the [n_sh*S] layout and the drain's
            # gather maps it back to build-order uniques.  ac/kmp remap to
            # the window family there, as in the JAX package.
            from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
                make_tile_counter,
                resolve_shard_mesh,
            )

            mesh = mesh if mesh is not None else resolve_shard_mesh(
                shard_axis, device_type=dev_type)
            if "packets" in mesh.axis_names:
                self._row_quantum = mesh.shape["packets"]
                tile_rows = -(-tile_rows // self._row_quantum) * self._row_quantum
            self._tile_fn, self._pattern_plan, engine = make_tile_counter(
                matcher, mesh, engine)
            device = mesh.devices.flat[0]
        else:
            engine = matcher._resolve_engine(engine)
            if sharded and engine == "kmp":
                engine = "ac"  # per-pattern DFAs have no sharded path; AC is exact
            if sharded:
                # Every tile's rows split over the mesh; UNIQUE-pattern
                # counts accumulate on the first device (dup expansion
                # after the final drain).
                from multithreading_string_matching_tpu_torch.parallel.mesh import (
                    count_tile_sharded,
                    make_mesh,
                )

                mesh = mesh or make_mesh(device_type=dev_type)
                self._row_quantum = mesh.devices.size
                tile_rows = -(-tile_rows // self._row_quantum) * self._row_quantum

                def tile_fn(p, l):
                    return count_tile_sharded(matcher, p, l, mesh, engine=engine)

                self._tile_fn = tile_fn
                device = mesh.devices.flat[0]
            elif engine == "pallas":
                self._tile_fn = lambda p, l: self.matcher.kernels.count_tiles([(p, l)])
            elif engine == "window":
                self._tile_fn = _window_tile_fn(matcher, device)
            else:
                fn = matcher._engine_fn(engine)
                self._tile_fn = lambda p, l: fn(p, l, per_packet=False)
        self.engine = engine
        self.tile_rows = tile_rows
        self.stager = TileStager(device, tile_rows, pack_width)
        # One tile can contribute at most tile_rows*pack_width matches per
        # pattern; drain the device int32 accumulator to host int64 before
        # it can wrap (with margin).
        self._drain_every = max(
            1, DRAIN_POSITIONS // max(1, tile_rows * pack_width)
        )
        self.reset()

    def reset(self):
        """Discard ALL accumulated state (counts, partial tile, oversized-
        row totals, dispatch count)."""
        self._slot = None           # the stager slot being packed
        self._r = 0
        self._total = None          # device-resident counts (int32)
        self._host_total = None     # int64 accumulator drained periodically
        self._tiles_since_drain = 0
        self._over_total = None     # host-side counts for oversized payloads
        self.tiles_dispatched = 0   # observability: dispatches, not feeds

    def _drain(self):
        if self._total is None:
            return
        with span("msm.drain"):
            t = self._total.cpu().numpy().astype(np.int64)
        self._host_total = t if self._host_total is None else self._host_total + t
        self._total = None
        self._tiles_since_drain = 0

    def _dispatch(self):
        buf, fill = self._slot
        # A partial tile is copied and counted up to its last row, rounded
        # up to whole shards; a reused slot holds an older tile there, and
        # those rows must count nothing.
        rows = -(-self._r // self._row_quantum) * self._row_quantum
        buf[self._r:rows] = 0
        fill[self._r:rows] = 0
        out = self.stager.dispatch(self._tile_fn, rows=rows)
        self._total = out if self._total is None else self._total + out
        self.tiles_dispatched += 1
        self._tiles_since_drain += 1
        if self._sync_dispatch:
            self._drain()  # waits for this tile's counts
        if self._tiles_since_drain >= self._drain_every:
            self._drain()  # one fetch per ~2^30 scanned positions
        self._slot = None
        self._r = 0

    def add(self, payloads, lengths):
        """Pack one feed's rows into the current tile, dispatching every
        tile that fills.  Any row count and byte width accepted."""
        with span("msm.pack"):
            # Case-insensitive matchers fold bytes before packing (idempotent,
            # so the oversized-payload detour through matcher.count is safe).
            payloads_m = self.matcher._maybe_fold(
                np.asarray(payloads, dtype=np.uint8)
            )
            lens = np.asarray(lengths).astype(np.int64)
            big = lens > self.pack_width
            if big.any():
                # Host int64 from the first add: int32 accumulation across many
                # oversized feeds could wrap long before totals() casts.
                over = np.asarray(self.matcher.count(
                    payloads_m[big], lens[big], engine=self.engine
                )).astype(np.int64)
                self._over_total = (
                    over if self._over_total is None else self._over_total + over
                )
                lens = np.where(big, 0, lens)
            rows_c, fill_c = pack_rows(payloads_m, lens, width=self.pack_width)
            if not fill_c.any():
                return
            w = rows_c.shape[1]
            i = 0
            while i < rows_c.shape[0]:
                if self._slot is None:
                    self._slot = self.stager.host(self.tile_rows, self.pack_width)
                buf, fill = self._slot
                take = min(self.tile_rows - self._r, rows_c.shape[0] - i)
                rs = slice(self._r, self._r + take)
                # Every byte of a row is written: a reused slot's stale bytes
                # never reach a kernel.
                buf[rs, :w] = rows_c[i : i + take]
                if w < self.pack_width:
                    buf[rs, w:] = 0
                fill[rs] = fill_c[i : i + take]
                self._r += take
                i += take
                if self._r == self.tile_rows:
                    self._dispatch()

    def flush(self):
        """Dispatch the partial tile (drain point: SIGINT, checkpoint)."""
        if self._r:
            self._dispatch()

    def totals(self) -> np.ndarray:
        """Exact int64 counts over the original pattern list, so far."""
        self.flush()
        self._drain()
        counts = (
            self._host_total
            if self._host_total is not None
            else np.zeros(len(self.matcher.patterns), dtype=np.int64)
        )
        if self.sharded and self._host_total is not None:
            if self._pattern_plan is not None:
                # Pattern-sharded accumulators live in the [n_sh*S] shard
                # layout; gather to build-order uniques, then dup-expand.
                counts = self._pattern_plan.gather(counts)[
                    self.matcher.window.dup_map
                ]
            else:
                # The sharded per-tile reducers return UNIQUE-pattern counts.
                counts = counts[self.matcher.window.dup_map]
        if self._over_total is not None:
            counts = counts + self._over_total
        return counts


def scan_pcap_streamed(
    matcher,
    pcap_path,
    mode: str = "udp",
    *,
    dump_path=None,
    offsets: bool = False,
    batch_packets: int = 8192,
    strict: bool = False,
    vlan: bool = False,
    ipv6: bool = False,
    stats: Optional[dict] = None,
    sharded: bool = False,
    mesh=None,
    shard_axis: str = "packets",
    host_workers: int = 0,
):
    """Bounded-memory per-row scan with per-packet attribution: counts,
    and optionally a dump of the matching packets and/or the exact match
    offsets.  Also the NUL-set path of :func:`count_pcap_streamed`
    (packing is inexact for such sets).

    Each ingest chunk goes through the per-row kernels (``rows`` form,
    exact fit masks) and is reduced on the device to unique totals and
    per-row hit flags.  The unsharded chunk is padded to pow2 rows x pow2
    width (a handful of shapes), staged through a :class:`TileStager` and
    counted in slices of fewer than ``mesh.SUMMARY_MAX_POSITIONS``
    positions; its totals accumulate in int64 on the device, fetched once
    at the end, and its hit flags come back only when a dump or offsets
    need them.  ``sharded=True`` shards each chunk's rows over the mesh
    (``mesh.count_rows_summary``), or the rule set on the pattern axis
    (``pattern_shard.count_rows_summary_pattern_sharded``); ac/kmp remap
    to the window family there, as in the JAX package.

    ``dump_path`` appends the chunk's hit packets to a classic pcap
    (:class:`~..io.pcap.PcapWriter`, header locked to the capture even when
    nothing matches).  ``offsets=True`` collects ``(packet, start,
    unique_pattern)`` triples with the original capture's packet numbers,
    global across chunks and files, from the flagged rows only
    (``Matcher.find_matches``).  A ``window`` matcher runs one
    ``find_matches`` pass per chunk for offsets (the triples are the
    counts), else ``count_batch(per_packet=True)``.

    Returns ``counts`` or ``(counts, offsets)`` with ``offsets=True``;
    ``stats`` (if given) receives the engine, packet/byte totals and, when
    dumping, ``dumped_packets``.
    """
    if mesh is not None and not sharded:
        raise ValueError("mesh= is only meaningful with sharded=True")
    from multithreading_string_matching_tpu_torch.parallel.mesh import (
        count_rows_summary,
        make_mesh,
    )
    from multithreading_string_matching_tpu_torch.parallel import mesh as mesh_mod

    row_fn = None
    row_engine = None
    pattern_sharded = sharded and (
        shard_axis in ("patterns", "both")
        or (mesh is not None and "patterns" in mesh.axis_names)
    )
    dev_type = matcher.device.type
    if sharded:
        if pattern_sharded:
            from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
                resolve_shard_mesh,
            )

            mesh = mesh if mesh is not None else resolve_shard_mesh(
                shard_axis, device_type=dev_type)
        else:
            mesh = mesh or make_mesh(device_type=dev_type)
        # ac/kmp remap to the window family here, as in the JAX package.
        row_engine = (
            "pallas" if matcher._requested_engine(None) == "pallas" else "window"
        )
    elif matcher._resolve_engine(None) == "pallas":
        row_engine = "pallas"
    num_unique = len(matcher.window.unique_patterns)
    if row_engine is not None:
        if not sharded:
            n_dev = 1
        elif pattern_sharded:
            # Rows only need padding to the PACKET axis of the mesh.
            n_dev = (
                mesh.shape["packets"] if "packets" in mesh.axis_names else 1
            )
        else:
            n_dev = mesh.devices.size
        if stats is not None:
            stats["engine_resolved"] = row_engine
        stager = None if sharded else TileStager(matcher.device, 1, 1)

        def row_fn(payloads, lengths):
            # ONE quantization rule for both flavors: pow2 rows x pow2
            # width (padding rows are length-0, zero bytes), so a long
            # stream reuses a handful of shapes.  The per-row counts reduce
            # on the device (count_*_summary): only unique totals and the
            # per-row hit flags leave it.  Returns (totals, hits[nq]).
            n, L = payloads.shape
            lq = max(128, _next_pow2(L))
            nq = -(-max(n_dev, _next_pow2(n)) // n_dev) * n_dev
            if sharded:
                payloads = np.pad(payloads, ((0, nq - n), (0, lq - L)))
                lengths = np.pad(lengths, (0, nq - n))
                if pattern_sharded:
                    from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
                        count_rows_summary_pattern_sharded,
                    )

                    return count_rows_summary_pattern_sharded(
                        matcher, payloads, lengths, mesh, engine=row_engine
                    )
                # count_rows_summary slices internally for the int32 bound.
                return count_rows_summary(
                    matcher, payloads, lengths, mesh, engine=row_engine
                )
            hb, hf = stager.host(nq, lq)
            hb[:n, :L] = matcher._maybe_fold(payloads)
            hb[:n, L:] = 0
            hb[n:] = 0
            hf[:n] = lengths
            hf[n:] = 0

            def summary(p, l):
                # Slice the chunk so one launch never scans enough positions
                # to wrap the device int32 totals (at default shapes one
                # slice).
                step = nq
                while step > 1 and step * lq >= mesh_mod.SUMMARY_MAX_POSITIONS:
                    step //= 2
                tot = torch.zeros(num_unique, dtype=torch.int64, device=p.device)
                hits = []
                for s in range(0, nq, step):
                    t, h = matcher.kernels.count_tile_summary(p[s : s + step], l[s : s + step])
                    tot += t
                    hits.append(h)
                return tot, torch.cat(hits)

            return stager.dispatch(summary)

    if stats is not None and row_fn is None:
        # Only the offsets branch is window-native (find_matches); the rest
        # runs count_batch with the matcher's resolved engine.
        stats["engine_resolved"] = (
            "window" if offsets else matcher._resolve_engine(None)
        )
    if stats is not None and host_workers:
        stats["host_workers"] = host_workers
    total = None
    n_packets = n_valid = n_bytes = 0
    found = [] if offsets else None
    w = PcapWriter(dump_path) if dump_path is not None else None
    try:
        for chunk, batch in _iter_extracted(
            pcap_path, mode, batch_packets, strict, vlan, ipv6, host_workers
        ):
            packet_base = n_packets
            n_packets += batch.num_packets
            n_valid += int(batch.valid.sum())
            n_bytes += batch.total_payload_bytes
            valid_idx = np.flatnonzero(batch.valid)
            if valid_idx.size == 0:
                if w is not None:
                    # Lock the dump's header to this capture's metadata.
                    w.write(chunk, valid_idx)
                continue
            if row_fn is not None:
                # Unique totals (host int64 sharded, device int64 local),
                # expanded through dup_map once at the end; attribution from
                # the hit flags, positions from the hit rows only.
                uniq_tot, hits = row_fn(batch.payloads, batch.lengths)
                total = uniq_tot if total is None else total + uniq_tot
                if w is None and found is None:
                    continue
                hits = hits.cpu().numpy() if torch.is_tensor(hits) else np.asarray(hits)
                row_hits = hits[: valid_idx.size]
                if w is not None:
                    w.write(chunk, valid_idx[row_hits])
                if found is not None and row_hits.any():
                    hit = np.flatnonzero(row_hits)
                    rows = matcher.find_matches(batch.payloads[hit], batch.lengths[hit])
                    if rows.size:
                        rows[:, 0] = packet_base + valid_idx[hit[rows[:, 0]]]
                        found.append(rows)
                continue
            if found is not None:
                # One scan serves all three outputs: the triples ARE the
                # counts and the dump selection (rows with any hit).
                rows = matcher.find_matches(batch.payloads, batch.lengths)
                total = matcher.counts_from_match_rows(rows) + (0 if total is None else total)
                if w is not None:
                    hit_rows = (
                        np.unique(rows[:, 0]) if rows.size
                        else np.zeros(0, np.int64)
                    )
                    hit_rows = hit_rows[hit_rows < valid_idx.size]
                    w.write(chunk, valid_idx[hit_rows])
                if rows.size:
                    # Original capture packet numbers, global across chunks.
                    rows[:, 0] = packet_base + valid_idx[rows[:, 0]]
                    found.append(rows)
            else:
                per_row = np.asarray(matcher.count_batch(batch, per_packet=True))
                total = per_row.sum(axis=0, dtype=np.int64) + (
                    0 if total is None else total
                )
                if w is not None:
                    row_hits = per_row[: valid_idx.size].sum(axis=1) > 0
                    w.write(chunk, valid_idx[row_hits])
    finally:
        if w is not None:
            w.close()
    if stats is not None:
        stats.update(
            packets=n_packets, valid_payloads=n_valid, payload_bytes=n_bytes,
        )
        if w is not None:
            stats["dumped_packets"] = w.packets_written
    if total is None:
        counts = np.zeros(len(matcher.patterns), dtype=np.int32)
    else:
        if row_fn is not None:
            total = np.asarray(total.cpu() if torch.is_tensor(total) else total, np.int64)
            total = total[matcher.window.dup_map]
        # Beyond int32: exact int64 (mirror count_pcap_streamed).
        counts = total if total.size and total.max() > np.iinfo(np.int32).max else (
            total.astype(np.int32))
    if offsets:
        all_rows = (
            np.concatenate(found, axis=0) if found else np.zeros((0, 3), dtype=np.int64)
        )
        return counts, all_rows
    return counts


def dump_matches_streamed(
    matcher,
    pcap_path,
    out_path,
    mode: str = "udp",
    **kw,
) -> np.ndarray:
    """Bounded-memory scan that re-emits every matching packet
    (:func:`scan_pcap_streamed` with ``dump_path`` fixed)."""
    return scan_pcap_streamed(matcher, pcap_path, mode, dump_path=out_path, **kw)


def count_pcap_pipelined(
    matcher,
    pcap_path,
    mode: str = "udp",
    *,
    batch_size: int = DEFAULT_BATCH,
    strict: bool = False,
    vlan: bool = False,
    ipv6: bool = False,
    host_workers: int = 0,
) -> np.ndarray:
    """Full-file counting through the batched pipeline (the reference's task
    program, openmp_task.c): counts are identical to the one-shot scan,
    only the execution schedule differs.

    Ingest is streamed (``io.pcap.iter_pcap``), so captures larger than
    host RAM flow through with bounded residency.  ``host_workers >= 1``
    threads the read/extract host stages (parallel/host.py), as the
    reference's ``num_threads(thread_count)`` sizes its producer and
    workers; the ``task`` command's thread count drives it.

    Each ``batch_size``-packet batch, at its own pow2 width, is staged
    through a :class:`TileStager` (slots sized to the widest batch seen)
    and counted with the matcher's RESOLVED engine without waiting: one
    ``count_tiles`` launch (the window or table kernels) for ``pallas``,
    one DFA scan launch for ``ac``/``kmp`` (the JAX package takes its
    window form for these; the counts are the same), the plain window
    count for ``window``.  The int32 device accumulator
    drains to host int64 every ``DRAIN_POSITIONS`` scanned positions."""
    engine = matcher._resolve_engine(None)
    total = None          # device-resident int32 accumulator
    host_total = None     # int64 accumulator drained periodically
    pos_since_drain = 0   # scanned positions bound the per-pattern growth

    def drain():
        nonlocal total, host_total, pos_since_drain
        if total is None:
            return
        t = total.cpu().numpy().astype(np.int64)
        host_total = t if host_total is None else host_total + t
        total = None
        pos_since_drain = 0

    chunks = _iter_pcap_paths(pcap_path, batch_size)

    def _extract(chunk):
        return list(iter_batches(
            chunk, mode, batch_size, strict=strict, vlan=vlan, ipv6=ipv6
        ))

    if host_workers:
        from multithreading_string_matching_tpu_torch.parallel.host import (
            map_prefetch,
            prefetch_iter,
        )

        batch_lists = map_prefetch(
            _extract, prefetch_iter(chunks, depth=max(2, host_workers)),
            workers=host_workers,
        )
    else:
        batch_lists = (_extract(c) for c in chunks)

    stager = TileStager(matcher.device, batch_size, 8)
    if engine == "pallas":
        def count(p, l):
            return matcher.kernels.count_tiles([(p, l)])
    elif engine in ("ac", "kmp"):
        fn = matcher._engine_fn(engine)

        def count(p, l):
            return fn(p, l, per_packet=False)
    else:
        count = _window_tile_fn(matcher, stager.device)

    for batches in batch_lists:
        for payloads, lengths in batches:
            hb, hf = stager.host(*payloads.shape)
            np.copyto(hb, matcher._maybe_fold(payloads))
            hf[:] = lengths
            counts = stager.dispatch(count)
            total = counts if total is None else total + counts
            # A batch contributes at most rows*cols matches per pattern;
            # drain the int32 device accumulator to host int64 before it can
            # wrap (same rule as count_pcap_streamed's drain_every).
            pos_since_drain += payloads.shape[0] * payloads.shape[1]
            if pos_since_drain >= DRAIN_POSITIONS:
                drain()
    drain()
    if host_total is None:
        return np.zeros(len(matcher.patterns), dtype=np.int32)
    if host_total.size and host_total.max() > np.iinfo(np.int32).max:
        return host_total  # beyond int32: exact int64 totals
    return host_total.astype(np.int32)
