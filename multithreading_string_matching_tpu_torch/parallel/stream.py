"""Streaming matcher (the live program's engine, live_openmp_task.c).

Counterpart of ``multithreading_string_matching_tpu/parallel/stream.py``.
The reference's live program pulls packets one at a time, buffers batches
of 10, spawns a matching task per full batch, and on SIGINT drains the
partial batch, then prints totals (live_openmp_task.c:160-241).  A
:class:`StreamMatcher` accumulates counts over an unbounded sequence of
packet batches; batch boundaries are packet boundaries, so no matcher state
crosses them.  A payload wider than one scan window is chunked along its
bytes with carried state (a byte halo for the window engine, DFA states for
AC), so a match across a chunk edge counts once.

On the card every scan runs a hand-written kernel:

- packed tiles (the default for NUL-free sets): the rows sequence-pack into
  pinned ``[tile_rows, pack_width]`` slots of parallel/pipeline.
  ``PackedTileCounter``, one ``window_count_totals`` launch (or one class
  kernel a word-count class, for table-route sets) per full tile;
- unpacked batches (NUL sets, ``packed=False``): one launch of the
  matcher's kernels per batch on the staged batch (``ac_scan`` with
  ``engine="ac"``);
- payloads wider than ``fixed_len``: ``window_stream_chunk`` with the halo
  kernel (``window_count_halo``), or ``ac_scan`` with carried states;
- the dump scan: the per-row kernels (``window_count_rows``, or the table
  and filter rows kernels).

The matcher's ``window`` engine is the plain PyTorch version in this
package, so the stream takes the kernels for it; on ``device="cpu"`` every
one of these paths runs the kernels' plain versions.  Counts accumulate as
int32 on the device and drain to a host int64 base before they can wrap
(``parallel.pipeline.DRAIN_POSITIONS``); checkpoints restore into that base.

Graceful shutdown: :meth:`StreamMatcher.install_sigint` sets a flag, as the
reference's signalHandler does (live_openmp_task.c:262-264); the driving
loop, :func:`run_live` (what ``live`` runs), checks
:attr:`StreamMatcher.stopped` and drains.

Under ``torch.profiler`` :func:`run_live` opens ``msm.stream`` around a
call and ``msm.ingest`` around the capture's read and each batch the
source yields; :meth:`StreamMatcher.feed_pcap_slice` opens ``msm.live.feed``
around a feed.  Inside it, an Ethernet feed (the walk's library loaded)
opens ``msm.decode`` around the one native walk (``io/live_walk.walk``: the
capture filter, the decode and the gather together); any other feed opens
``msm.decode`` around ``extract_payloads`` and, behind the capture filter,
``msm.live.filter`` around ``bpf_protocol_mask``.  :data:`LIVE` counts the
feeds, the frames fed, the frames the capture filter passed and the feeds
that took the walk.
"""

from __future__ import annotations

import os
import signal
from typing import Callable, Dict, Optional

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.io import live_walk
from multithreading_string_matching_tpu_torch.io.decode import bpf_protocol_mask, extract_payloads
from multithreading_string_matching_tpu_torch.io.live import FileReplaySource
from multithreading_string_matching_tpu_torch.io.pcap import PcapFile
from multithreading_string_matching_tpu_torch.ops.scan import count_matches_ac
from multithreading_string_matching_tpu_torch.ops.window import window_stream_chunk
from multithreading_string_matching_tpu_torch.parallel import pipeline
from multithreading_string_matching_tpu_torch.utils.timing import span

# Feeds of :meth:`StreamMatcher.feed_pcap_slice` (``batches``), the frames
# they held (``frames``), those the capture filter passed (``passed``;
# every frame of a feed without the filter) and the feeds that took the
# one native header walk (``walked``).
LIVE: Dict[str, int] = {"batches": 0, "frames": 0, "passed": 0, "walked": 0}


def patterns_npz_fields(patterns) -> dict:
    """Pattern list as npz-safe arrays: a byte blob + lengths, NOT a unicode
    array (numpy 'U' arrays strip trailing NULs, which would fail the
    load-time identity check for a b"ab\\x00" pattern).  Shared by the
    StreamMatcher and FlowStreamMatcher checkpoints, as in the JAX package,
    whose checkpoints this format reads and writes."""
    return {
        "pattern_blob": np.frombuffer(b"".join(patterns), np.uint8),
        "pattern_lens": np.array([len(p) for p in patterns], np.int64),
    }


def patterns_from_npz(data) -> list:
    """Inverse of :func:`patterns_npz_fields`; also reads the older unicode
    'patterns' array (NUL-free sets only)."""
    if "pattern_blob" in data:
        blob = data["pattern_blob"].tobytes()
        pats, pos = [], 0
        for ln in data["pattern_lens"]:
            pats.append(blob[pos : pos + int(ln)])
            pos += int(ln)
        return pats
    return [p.encode("latin-1") for p in data["patterns"].tolist()]


def checkpoint_path(path) -> str:
    """np.savez appends .npz to extension-less paths; accept the same path
    save() was called with."""
    path = str(path)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return path + ".npz"
    return path


DEFAULT_BATCH = 10  # live_openmp_task.c:142


class StreamMatcher:
    """Engine 'window' (default): whole-packet batches through the
    matcher's kernels, long payloads chunked with a carried byte halo.
    Engine 'ac': the Aho-Corasick scan with carried DFA states; same counts.

    ``packed`` ('auto' default) is the serving shape: feeds accumulate into
    fixed ``[tile_rows, pack_width]`` sequence-packed tiles and ONE launch
    per full tile runs the matcher's engine, so a live loop fed 10-packet
    batches amortizes the per-launch cost over the tile.  Counts are
    identical; the partial tile flushes on :meth:`counts` (report, SIGINT
    drain, checkpoint).  'auto' packs whenever the pattern set is NUL-free
    (packing is inexact otherwise); ``packed=True`` on NUL patterns raises.
    ``sharded=True`` scans each full tile over a mesh (``mesh=``, default
    every device of the matcher's type)."""

    def __init__(
        self,
        matcher,
        batch_size: int = DEFAULT_BATCH,
        fixed_len: int = 2048,
        engine: str = "window",
        dump_writer=None,
        packed="auto",
        tile_rows: int = 1024,
        pack_width: int = 2048,
        sharded: bool = False,
        mesh=None,
    ):
        self.matcher = matcher
        # The JAX package pads each batch's rows to a multiple of it for its
        # compiled shapes; the kernels here take any row count.
        self.batch_size = batch_size
        self.fixed_len = fixed_len
        if engine not in ("window", "ac"):
            # A typo must not silently run the window path; only these two
            # have carried-state long-payload forms.
            raise ValueError(f"unknown stream engine {engine!r}: expected window or ac")
        self.engine = engine
        # Optional io.pcap.PcapWriter: batches fed through feed_pcap_slice
        # also append their MATCHING packets (original records) to it, the
        # live analogue of `match --dump-matches`.
        self.dump_writer = dump_writer
        if mesh is not None and not sharded:
            raise ValueError("mesh= is only meaningful with sharded=True")
        # Tile config persists so reload() re-arms identically for a new set.
        self._packed = packed
        self._tile_rows = tile_rows
        self._pack_width = pack_width
        self._sharded = sharded
        self._mesh = mesh
        self._tiles = self._build_tiles(matcher)
        self._counts: Optional[torch.Tensor] = None  # device int32, pattern-file order
        # Host int64 base: checkpoints restore here, and the device int32
        # accumulator drains here before it can wrap.
        self._host_counts: Optional[np.ndarray] = None
        self._pos_since_drain = 0
        # Packed-mode dump attribution is batched like counting: slices pend
        # until ~dump_scan_rows rows, then ONE per-row scan serves them all.
        self._dump_pending = []  # (pcap_slice, src_idx, payloads, lengths)
        self._dump_pending_rows = 0
        self.dump_scan_rows = 1024
        self.packets_seen = 0
        self.stopped = False
        self._old_handler = None

    @staticmethod
    def _kernel_engine(matcher) -> Optional[str]:
        """The engine the tile path runs: the matcher's own, except that its
        ``window`` engine (the plain version here) takes the kernels."""
        return "pallas" if matcher._requested_engine(None) == "window" else None

    def _build_tiles(self, matcher):
        """Check the packed/sharded rules for ``matcher`` and build its tile
        counter (None for the unpacked path).  Shared by __init__ and
        :meth:`reload`, so the two cannot diverge on the rules."""
        nul_free = not any(0 in p for p in matcher.window.unique_patterns)
        if self._packed is True and not nul_free:
            raise ValueError(
                "packed tiles require NUL-free patterns (sequence packing "
                "is inexact otherwise); use packed='auto' or False"
            )
        if self._sharded and not (self._packed is True or (self._packed == "auto" and nul_free)):
            raise ValueError(
                "sharded live streaming rides the packed tiles; it needs "
                "packed=True/'auto' and a NUL-free pattern set"
            )
        if self._packed is True or (self._packed == "auto" and nul_free):
            # The constructor's `engine` only steers the long-payload path of
            # unpacked feeds; the tiles run the matcher's engine.
            return pipeline.PackedTileCounter(
                matcher, engine=self._kernel_engine(matcher), tile_rows=self._tile_rows,
                pack_width=self._pack_width, sharded=self._sharded, mesh=self._mesh,
            )
        return None

    def reload(self, matcher) -> np.ndarray:
        """Swap the pattern set mid-stream (the IDS rule update).

        Drains everything pending under the CURRENT set (partial packed
        tile, batched dump scans, device accumulator) and returns its final
        counts, then re-arms every accumulator for ``matcher``.  The source,
        ``packets_seen``, the SIGINT handler and the dump writer persist.
        Batch boundaries are packet boundaries, so the swap is exact.  The
        kernels are one built library each and take their tables as
        arguments, so nothing is rebuilt: the new matcher's tables are bound.

        Validation runs BEFORE any change: a reload that breaks the
        packed/sharded rules (NUL patterns under packed=True) raises and
        leaves the stream untouched and usable.
        """
        tiles = self._build_tiles(matcher)
        final = self.counts()  # flushes dump scans + the partial tile
        self.matcher = matcher
        self._tiles = tiles
        self._counts = None
        self._host_counts = None
        self._pos_since_drain = 0
        self._dump_pending = []
        self._dump_pending_rows = 0
        return final

    # -- lifecycle ---------------------------------------------------------

    def install_sigint(self, on_stop=None):
        """SIGINT sets a drain flag (live_openmp_task.c:156-158,262-264).

        ``on_stop`` (e.g. ``LiveSource.stop``) also fires from the handler:
        a blocking capture loop on a QUIET interface never yields a batch,
        so a flag checked only between batches would never be seen."""

        def handler(signum, frame):
            self.stopped = True
            if on_stop is not None:
                on_stop()

        self._old_handler = signal.signal(signal.SIGINT, handler)

    def uninstall_sigint(self):
        if self._old_handler is not None:
            signal.signal(signal.SIGINT, self._old_handler)
            self._old_handler = None

    # -- whole-packet batches (the reference's streaming shape) -------------

    def _drain_counts(self):
        """Drain the device int32 accumulator into the host int64 base."""
        if self._counts is not None:
            t = self._counts.cpu().numpy().astype(np.int64)
            self._host_counts = t if self._host_counts is None else self._host_counts + t
            self._counts = None
        self._pos_since_drain = 0

    def _add(self, counts: torch.Tensor, positions: int):
        self._counts = counts if self._counts is None else self._counts + counts
        self._pos_since_drain += positions
        if self._pos_since_drain >= pipeline.DRAIN_POSITIONS:
            self._drain_counts()

    def _device_tile(self, a: np.ndarray) -> torch.Tensor:
        # A copy: the kernel runs after this returns, and the host buffer
        # may be reused by then.
        return torch.tensor(np.ascontiguousarray(a), device=self.matcher.device)

    def feed_batch(self, payloads: np.ndarray, lengths: np.ndarray):
        """Accumulate counts for one batch of whole packets (no wait for the
        card)."""
        if self._tiles is not None:
            # Packed serving shape: rows pack host-side into pinned slots and
            # launch once per FULL tile (oversized rows detour internally).
            payloads = np.asarray(payloads, dtype=np.uint8)
            self.packets_seen += payloads.shape[0]
            self._tiles.add(payloads, np.asarray(lengths))
            return
        # The launches below do not wait for the card, and a CPU tensor made
        # by torch.as_tensor aliases its numpy array: copy unless the working
        # array owns fresh memory (`is src`: asarray's pass-through; `base`:
        # a view over any buffer).
        src_p, src_l = payloads, lengths
        payloads = self.matcher._maybe_fold(np.asarray(payloads, dtype=np.uint8))
        if payloads is src_p or payloads.base is not None:
            payloads = payloads.copy()
        lengths = np.asarray(lengths, dtype=np.int32)
        if lengths is src_l or lengths.base is not None:
            lengths = lengths.copy()
        self.packets_seen += payloads.shape[0]
        if payloads.shape[1] > self.fixed_len:
            # Longer-than-window payloads stream through the carried-state path.
            self._feed_long(payloads, lengths)
            return
        if self.engine == "ac":
            m = self.matcher
            counts = count_matches_ac(m.cac, self._device_tile(payloads),
                                      self._device_tile(lengths), dup_map=m.ac.dup_map)
        else:
            # One launch of the matcher's kernels on the staged batch (bytes
            # past each length zeroed by prepare).
            prep = self.matcher.prepare(payloads, lengths, bucketed=False, packed=False)
            counts = self.matcher.count_prepared(prep, engine="pallas", block=False)
        self._add(counts, payloads.shape[0] * payloads.shape[1])

    def _feed_long(self, payloads: np.ndarray, lengths: np.ndarray):
        """Chunk the byte axis with carried state (a match across a chunk
        edge counts once): a byte halo through the halo kernel for the
        window engine, DFA states through ``ac_scan`` for the AC engine."""
        n, L = payloads.shape
        m = self.matcher
        W = self.fixed_len
        if self.engine == "ac":
            states = m.streaming_state(n)
            for start in range(0, L, W):
                chunk = payloads[:, start : start + W]
                rel = np.clip(lengths.astype(np.int64) - start, 0, W).astype(np.int32)
                # The states are zeros or the kernel's own: no check that
                # would wait for the card.
                counts, states = count_matches_ac(
                    m.cac, self._device_tile(chunk), self._device_tile(rel),
                    initial_states=states, dup_map=m.ac.dup_map, return_states=True,
                    check=False,
                )
                self._add(counts, n * W)
            return
        halo = None
        halo_count = m.halo_kernels.count_tile_halo
        for start in range(0, L, W):
            chunk = payloads[:, start : start + W]
            if chunk.shape[1] < W:
                chunk = np.pad(chunk, ((0, 0), (0, W - chunk.shape[1])))
            rel = (lengths.astype(np.int64) - start).astype(np.int32)
            counts, halo = window_stream_chunk(m.window, self._device_tile(chunk), rel, halo,
                                               halo_count=halo_count)
            self._add(counts, n * W)

    def feed_pcap_slice(self, pcap: PcapFile, mode: str = "udp", *, bpf_filter: bool = False):
        """``bpf_filter=True`` reproduces the live program's capture filter
        (live_openmp_task.c:127): only protocol-matching packets enter the
        stream at all, so ``packets_seen`` counts what the filter passed.

        In udp mode counts are identical either way (extraction already
        requires proto 17).  In tcp mode the extractor has no protocol check
        (packet_dumping.h:150-188), so an unfiltered scan can count matches
        inside non-TCP packets that the filter excludes, as the reference's
        filtered live program can differ from its own serial program."""
        with span("msm.live.feed"):
            if live_walk.applies(pcap):
                # One native walk decides the filter bit and the payload of
                # each frame and gathers the kept rows into a fresh matrix.
                with span("msm.decode"):
                    payloads, lengths, src_idx = live_walk.walk(pcap, mode, bpf_filter)
                LIVE["walked"] += 1
            else:
                with span("msm.decode"):
                    batch = extract_payloads(pcap, mode, keep_invalid=True)
                src_idx = np.arange(pcap.num_packets, dtype=np.int64)
                # extract_payloads pads to >= 1 row even for an EMPTY slice;
                # rows past num_packets are padding.
                payloads = batch.payloads[: src_idx.size]
                lengths = batch.lengths[: src_idx.size]
                if bpf_filter:
                    with span("msm.live.filter"):
                        mask = bpf_protocol_mask(pcap, mode)
                    payloads, lengths = payloads[mask], lengths[mask]
                    src_idx = src_idx[mask]
            LIVE["batches"] += 1
            LIVE["frames"] += pcap.num_packets
            LIVE["passed"] += src_idx.size
            if self.dump_writer is not None:
                if payloads.shape[0] and self._tiles is not None:
                    # A row for every frame that entered (src_idx), so per-row
                    # attribution maps straight back to records.  Batched.
                    self._dump_pending.append((pcap, src_idx, payloads, lengths))
                    self._dump_pending_rows += payloads.shape[0]
                    if self._dump_pending_rows >= self.dump_scan_rows:
                        self._flush_dump()
                elif payloads.shape[0]:
                    per_row = self._rows(payloads, lengths)
                    hits = per_row[: src_idx.size].sum(axis=1) > 0
                    self.dump_writer.write(pcap, src_idx[hits])
                else:
                    # Lock the header to the capture's metadata even when the
                    # slice gave no payloads.
                    self.dump_writer.write(pcap, src_idx[:0])
            if payloads.shape[0]:
                self.feed_batch(payloads, lengths)

    def _rows(self, payloads, lengths) -> np.ndarray:
        """int32[n, P] per-row counts through the per-row kernels."""
        return np.asarray(self.matcher.count(payloads, lengths, per_packet=True, engine="pallas"))

    # -- checkpoint / resume -------------------------------------------------
    # The reference's live program loses all counts on a hard kill (it
    # prints only after a graceful SIGINT).  A stream here can checkpoint
    # between batches and resume exactly; the file is the JAX package's.

    def save(self, path) -> str:
        np.savez(
            path,
            counts=self.counts(),
            packets_seen=np.int64(self.packets_seen),
            **patterns_npz_fields(self.matcher.patterns),
        )
        # np.savez appends .npz to extension-less paths; return the real one.
        path = str(path)
        return path if path.endswith(".npz") else path + ".npz"

    def load(self, path):
        data = np.load(checkpoint_path(path), allow_pickle=False)
        if patterns_from_npz(data) != self.matcher.patterns:
            raise ValueError("checkpoint pattern list does not match matcher")
        # load() REPLACES the stream's state (the checkpoint's counts hold
        # every accumulator at save time), so all of them reset; the counts
        # restore into the host int64 base, exact past int32.
        self._counts = None
        self._pos_since_drain = 0
        self._dump_pending = []
        self._dump_pending_rows = 0
        if self._tiles is not None:
            self._tiles.reset()
        self._host_counts = np.asarray(data["counts"]).astype(np.int64)
        self.packets_seen = int(data["packets_seen"])

    # -- results -----------------------------------------------------------

    def _flush_dump(self):
        """One per-row scan over all pending slices, hits written in feed
        order: the batched form of the per-slice dump attribution."""
        if not self._dump_pending:
            return
        pend, self._dump_pending = self._dump_pending, []
        self._dump_pending_rows = 0
        lmax = max(p.shape[1] for _, _, p, _ in pend)
        rows = sum(p.shape[0] for _, _, p, _ in pend)
        pays = np.zeros((rows, lmax), dtype=np.uint8)
        lens = np.zeros(rows, dtype=np.int32)
        r = 0
        for _, _, p, l in pend:
            pays[r : r + p.shape[0], : p.shape[1]] = p
            lens[r : r + p.shape[0]] = l
            r += p.shape[0]
        per_row = self._rows(pays, lens)
        r = 0
        for pcap, src_idx, p, _ in pend:
            hits = per_row[r : r + p.shape[0]][: src_idx.size].sum(axis=1) > 0
            self.dump_writer.write(pcap, src_idx[hits])
            r += p.shape[0]

    def flush(self):
        """Flush pending work: the batched dump scan and the partial packed
        tile.  Call before closing a dump writer; counts() also flushes."""
        self._flush_dump()
        if self._tiles is not None:
            self._tiles.flush()

    def counts(self) -> np.ndarray:
        """Wait for the card and return counts over the original pattern
        list (flushes the partial tile and any pending dump scan first;
        int64 past int32)."""
        self._flush_dump()
        total = np.zeros(len(self.matcher.patterns), dtype=np.int64)
        if self._host_counts is not None:
            total = total + self._host_counts
        if self._counts is not None:
            total = total + self._counts.cpu().numpy().astype(np.int64)
        if self._tiles is not None:
            total = total + self._tiles.totals()
        if total.size and total.max() > np.iinfo(np.int32).max:
            return total  # beyond int32: exact int64 (the reference wraps here)
        return total.astype(np.int32)

    @property
    def tiles_dispatched(self) -> int:
        """Packed-mode launches (0 when unpacked): tiles, not batches."""
        return self._tiles.tiles_dispatched if self._tiles is not None else 0


def run_live(stream: StreamMatcher, source, mode: str = "udp", *,
             between: Optional[Callable[[StreamMatcher], None]] = None) -> None:
    """The live program's loop (live_openmp_task.c:142-241): every batch of
    ``source`` through ``stream`` behind the capture filter
    (``feed_pcap_slice(..., bpf_filter=True)``, so ``packets_seen`` counts
    what the filter passed) until the source ends or ``stream.stopped``
    is set, then :meth:`StreamMatcher.flush` (the partial tile and the
    pending dump scan), also when the loop raises.  Counts stay on the
    stream (:meth:`StreamMatcher.counts`).

    ``source`` iterates :class:`PcapFile` batches (``io.live.LiveSource``,
    ``FileReplaySource``, or a prefetch iterator over one), or is the path
    of a capture, read here and replayed in batches of
    ``stream.batch_size``.  ``between(stream)`` runs before each batch is
    fed (the CLI's SIGHUP reload).  A stop after a feed calls the source's
    ``stop`` where it has one; a prefetch iterator has none, and its
    source is stopped by the SIGINT handler
    (:meth:`StreamMatcher.install_sigint`)."""
    with span("msm.stream"):
        if isinstance(source, (str, bytes, os.PathLike)):
            with span("msm.ingest"):
                source = FileReplaySource(source, batch_size=stream.batch_size)
        batches = iter(source)
        try:
            while True:
                with span("msm.ingest"):
                    batch = next(batches, None)
                if batch is None:
                    break
                if between is not None:
                    between(stream)
                stream.feed_pcap_slice(batch, mode, bpf_filter=True)
                if stream.stopped:
                    if hasattr(source, "stop"):
                        source.stop()
                    break
        finally:
            stream.flush()
