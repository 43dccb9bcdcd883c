#!/usr/bin/env python3
"""Drive the torch port's main path once on one NVIDIA GPU, and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Print the card's name and power limit, build the CUDA kernels from
   ``multithreading_string_matching_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together) and print the build times; rows 1 and 4's
   device times are printed at the end beside PERF.md's earlier ones (they
   share the probe table build with ``window_find``).
2. Hold each kernel equal to its plain PyTorch version on the same CUDA
   tensors: the window kernels (``window_count_totals``, also with
   ``reps=3``, and ``window_count_rows``) and the table and filter kernels
   (``table_count_*``, ``filter_count_*``, totals also with ``reps=3``) on
   ragged widths, NUL patterns over rows that are not zero-filled, zero-row
   and zero-width tiles, patterns longer than the row, multi-segment rows,
   3072 ``rs%06d`` patterns, a mixed set of word-count classes 1..8, a class
   of one pattern, a shared-prefix set and filter words present without
   their patterns; and the hashed probe's hard cases (``csrc/probe.cuh``):
   3,072 patterns sharing one probe key, 64 keys in one hash bucket, a
   class of 1-, 2-, 3- and 4-byte patterns (four probe masks), NUL bytes
   inside keys, a filter word that occurs twice in its pattern, U = 1 and
   U = 3,072 at K = 8, and 9,000 patterns (three hash chunks).  A table of
   nine probe masks is refused by the wrappers (``ValueError``) and counted
   exactly by the C entry point.  The DFA scans ``ac_scan`` and
   ``kmp_scan`` on 12 cases (see phase 11), each from the root and from
   carried in-table states with dead lanes in every segment, at the AC
   kernel's own segment size and at small ones (warm-ups across every
   boundary, patterns longer than a segment, two cases planted across
   every boundary at offsets -40 .. +40), KMP at the fewest pattern groups
   and at one pattern a group, one tile and a list of three tiles in one
   launch; start states outside the table (S, S + 7, -1, -5) are refused
   by ``ac_scan``, ``ac_scan_tiles`` and ``count_matches_ac`` with nothing
   launched; a table with a state the root does not reach (no depth) at
   small segments asked for, the input phase 14's soak found.  ``window_find`` (``csrc/window_find.cu``) on its traps, each
   over many 16,384-position tiles: every position dense with matches (1-,
   2-, 3-byte and NUL-tailed patterns), heads and tails of a pattern on two
   sides of every row boundary, lengths past the width under NUL-tailed
   patterns, rows of length 0 and below, rows of 5 bytes (every position
   takes the full probe), and 9,004 patterns whose hits at
   one start fall in three hash chunks; each also with a first capacity of
   1 row (one rerun) and in row slices at unaligned addresses.
3. The main path at a real size: a seeded 100,000-packet capture of
   ~1 KB payloads (~100 MB) with the 97-token stand-in pattern set, counted
   by ``Matcher(device="cuda").count_pcap``, per packet on its first 8,192
   rows and with ``count_tiles_repeated`` on its staged tiles, with the
   kernels' launch counters reset just before.  Counts must equal the plain
   version's on the card and, on the first rows, a pure-Python count.
4. Times, with the card's name and power limit beside each: the scan rate
   of the resident prepared tiles (median of 20 runs, CUDA events), the
   device time of one such pass queued alone ahead of the card
   (``utils.timing.queued_ms``: without the host's time between launches,
   and only where the host enqueued the whole pass before the card
   reached it), the plain version's rate at the same shapes, and the wall
   time of the full ``serial`` path.
5. The large-rule-set path: 3,072 seeded patterns of 4-32 bytes over a
   second seeded 100,000-packet capture.  ``Matcher`` must choose the
   filter kernels (``explain()``), and ``count_pcap``, per-packet counts and
   repeats must launch them; with ``MSM_PALLAS_FILTER=0`` the table kernels.
   Totals equal the window kernel's, the plain version's and, on the first
   rows, a pure-Python count.  Times: table+filter, table and window kernels
   on the resident tiles, the plain versions, the filter kernels of the
   87-pattern stand-in set and of the 3,072 rules over the same tiles, the
   bench's 3,072 ``rs%06d`` set over the phase-3 capture, and ``serial``
   with the large file.
6. The flow path: a seeded capture of 768 TCP flows x 131,072 stream bytes
   (~100.7 MB) in 1,400-byte segments, interleaved, with stand-in patterns
   planted at random offsets and across segment boundaries, streamed
   through ``FlowStreamMatcher`` (the window engine, 8,192-packet slices)
   with the launch counters reset just before: ``window_count_halo`` must
   launch in every scan round and no other kernel.  The stream's counts
   equal one-shot ``extract_flows`` + ``Matcher.count`` on the card, the
   plain version's stream on the card and a pure-Python count over every
   reassembled stream; the per-packet count is lower.  Also a reordered,
   retransmitting capture, a NUL + nocase case, a forced chunk-loop round
   and a forced drain, and the halo kernel against its plain version on
   random lanes.  Times: stream rate (median of 3), where a stream's wall
   time goes, the halo kernel on the largest round tile against the plain
   version, and the ``match --flows [--stream]`` wall times.
7. The sharded path, on phase 5's rule set and capture: pattern-axis totals
   on a one-shard mesh must launch the shard filter kernel (the shard table
   kernel with ``MSM_PALLAS_FILTER=0``) and no class kernel, and equal phase
   5's counts; so must 4-shard, 3-shard and 2x2 virtual meshes on the card,
   one launch per shard.  Pattern-sharded rows and summary on the first
   8,192 rows equal phase 5's per-packet counts.  Each shard kernel equals
   its plain version there, on the whole set's block and on five padded
   blocks of each form.  ``match --sharded --shard-axis packets`` on the
   phase-3 files gives phase 3's counts through ``window_count_totals``; a
   sharded flow
   stream on a 2-shard mesh equals the unsharded one through
   ``window_count_halo``.  Times: the shard kernels on the resident
   [N, L_max] tile and on 8,192 rows against the class route and the plain
   versions, ``match --sharded --shard-axis patterns`` against unsharded
   ``match`` (median of 3), and the device busy share of one
   pattern-sharded count (torch.profiler).
8. The matrix-unit measurement path (``tools/mxu_match.py``, the port of
   ``bench/mxu_match.py``): ``mxu_count`` (int8 ``wgmma``) equals its
   plain version, over all padded slots and over the live ones, at reps 1
   and 3, on ragged widths and row counts, U = 1, 88, 96, 127, 128, 129,
   256, 257 and 3,072 (``rs`` and ``pt`` at C = 64), 60 and 90 at four
   k-steps, 1-byte patterns and m_max = 99, widths 1, 63 and 65, 3,000 rows of 1,100 (more row segments
   than the persistent grid has warpgroups), patterns planted across every
   64-position boundary of 4,133-byte rows, a packed tile and a zero-row
   tile; it prints the kernel's tensor-core opcodes (``cuobjdump -sass``:
   warpgroup ``*GMMA`` against ``mma.sync``).  With the launch counter
   reset just before, the tool's three
   pattern sets over its corpus and the stand-in set over phase 3's resident
   tiles must launch ``mxu_count`` once per tile and call, and give the
   table kernel's totals, phase 3's counts and, on the first rows, a
   pure-Python count.  Times: the kernel over phase 3's tiles (median of
   20, its device time queued alone, and its share of the bound,
   ``bound_share``) against the plain version (1 run), the tool's rows (mxu and table
   rates per set), ``torch._int_mm`` on the score product alone for the
   first 1,024 rows of one tile beside the kernel on the same rows, and
   the mxu, table and window kernels over phase 3's tiles alternated over
   ``ALT_ROUNDS`` rounds.
9. The streamed packet path (``parallel/pipeline.py`` through
   ``parallel/stager.py``'s pinned, double-buffered tile staging), on phase
   3's and phase 5's captures, each run with the launch counters reset just
   before and held to its counts and launches (no other kernel launched):
   ``count_pcap_streamed`` on the stand-in capture (``window_count_totals``
   once per packed [4096 x 2048] tile) async and with ``sync_dispatch``,
   with 0 and ``min(8, cpus)`` host workers, with ``tile_rows=64`` (the
   3-slot ring turned hundreds of times) and with a drain after every
   tile; ``count_pcap_pipelined`` (one launch per 100-packet batch); the
   3,072 rules (one filter launch per class and tile; the table kernels with
   ``MSM_PALLAS_FILTER=0``; one shard launch per tile on the pattern axis);
   the stand-in set and the 3,072 rules each plus a NUL pattern, against
   their one-shot counts (the rows kernels, one launch per class and
   8,192-packet chunk); and the ``data``, ``task`` (4 threads) and ``match
   --stream --json`` commands against ``serial``'s counts.  Times: the
   streamed end-to-end rate (payload bytes / wall, median of 3 after a warm
   run) async and sync and their ratio, the host stages alone with 0 and N
   workers (best of 3, as ``bench.py:291-318``), the ``data`` and ``task``
   walls, and one streamed pass under torch.profiler split by the
   program's spans (``split_pass``: each ``msm.*`` span's self seconds, the
   trace's copy and kernel device time, one window launch and one
   ``msm.stage.dispatch`` a tile).  The
   window, table and filter records gain ``stream_launches``.
10. Match attribution at full width (``window_find``, one ordered launch
   of ``csrc/window_find.cu``).  ``match --offsets --json`` on phase 3's
   capture, with the launch counters reset just before, must launch
   ``window_find`` once a row slice (plus at most one counted rerun) and
   nothing else, no ``window_count_totals``; its triples must be unique, bincount to phase
   3's counts, and each read back on the host as its pattern's bytes; on
   the first 8,192 rows they equal the plain version on the card.  The
   same on phase 5's 3,072-rule capture.  ``--dump-matches`` writes the
   hit packets, which re-count to phase 3's counts; ``--stream --offsets
   --dump-matches`` gives the one-shot triples and dump bytes; ``--flows
   --offsets`` and ``--flows --stream --offsets`` on phase 6's capture give
   the same triples and phase 6's counts.  Times: ``window_find`` over the
   staged stand-in batch (median of 20) and the device time of its one
   launch queued alone (with and without its flag clear), the kernel and the plain version on the first 8,192
   rows, and the walls of ``match``, ``match --offsets``, ``match
   --dump-matches``, ``match --stream`` and ``match --stream --offsets``
   (median of 3, in turns).
11. The DFA scans at full width (``ac_scan`` and ``kmp_scan`` of
   ``csrc/scan.cu``; phase 2 holds both against their plain versions:
   totals, rows, carried states, lengths <= 0 and past the width, NUL
   patterns, uint16 and int32 tables in shared and device memory, a set of
   more than 65,536 states, duplicates and a 99-byte pattern).  With the
   launch counters reset just before each step: ``Matcher(engine='ac')``
   and ``Matcher(engine='kmp')`` ``count_pcap`` on phase 3's capture and
   ``count_prepared`` on its 53 resident tiles give phase 3's counts in one
   launch of their kernel each (the tile list); per packet on the first
   8,192 rows they equal phase 3's rows, the plain version on the card and
   a pure-Python count; ``count_chunk`` over phase 3's rows in 2,048- and
   512-byte chunks gives phase 3's counts; ``engine='ac'`` on phase 5's
   3,072 rules gives phase 5's counts in one launch (``count_pcap`` and
   ``count_prepared``), and ``kmp`` at 3,072 rules on the first 8,192 rows
   phase 5's rows; ``match --engine ac|kmp [--stream] [--sharded
   --shard-axis packets] --json`` gives phase 3's counts with the JAX CLI's
   ``execution`` keys (one launch one-shot); ``FlowStreamMatcher(engine=
   'ac')`` (its flows revived round after round from their stored states),
   ``match --flows --stream --engine ac``, ``count_flows_chunked`` and a
   2-shard lane mesh give phase 6's counts, and the reordered capture the
   window engine's and the pure-Python counts.  Times: each kernel's pass
   over phase 3's resident tiles in one launch (``ac_scan_tiles``,
   ``kmp_scan_tiles``: median of 20, and the device time queued alone)
   beside the same pass at one launch a tile, against its bound; ``kmp``'s
   groups at four fill-lane settings; the kernel and its plain version on
   the first 8,192 rows, beside them the window and filter kernels over the
   same tiles; ``ac`` over phase 5's tiles in one launch and one a tile
   beside the filter and window kernels there; the AC flow stream and its
   rounds; the walls of ``match --engine pallas|ac|kmp [--stream]`` (median
   of 3, in turns).
12. The live path (``live``, parallel/stream.py ``StreamMatcher``) and the
   new inputs: phase 3's capture replayed in batches of 10 with the
   stand-in set (packed tiles, ``window_count_totals``) and with it plus a
   NUL pattern (unpacked, one launch a batch), phase 5's with the 3,072
   rules (packed, the filter class kernels), each through a StreamMatcher
   driven directly with its launches counted (tiles, not batches) and
   through ``live ... 4 udp`` (median of 3 walls); counts equal
   ``serial``'s and ``packets_seen`` the packets the udp filter passes.  The
   device's busy share of one replay (torch.profiler); ``live
   --dump-matches`` byte-equal to ``match --dump-matches`` (the rows
   kernels); payloads of ~6,000 bytes through ``window_count_halo`` and
   ``ac_scan`` with carried states; a StreamMatcher and the window and AC
   flow streams resumed from checkpoints; phase 3's capture as pcapng under
   ``match``, ``--stream`` and ``--engine ac``, its ingest seconds beside
   the classic ones; ``match --profile`` writing a trace that names the
   window_count launches.  Each kernel is held against its plain version at
   this path's shapes; the records carry the launches as ``live_launches``.
13. The multi-process path (parallel/distributed.py): ranks are processes
   of this script's host, two on the one card, joined by a gloo group
   through ``MSM_COORDINATOR`` on a free port; any rank's nonzero exit or
   traceback fails the run.  ``mesh`` on phase 3's capture with one
   process and with two ranks, in turns (3 runs each): rank 0 prints phase
   3's counts, rank 1 nothing; its wall and rank 0's ``elapsed_max_s``
   beside each.  ``mesh`` with two ranks on phase 5's capture and rules
   gives phase 5's counts; ``match --stream --distributed --json`` with two
   ranks gives the single process's counts and stats.  This script with
   ``--distributed-rank`` runs ``count_pcap_distributed`` (``pallas``,
   ``ac``, the 3,072 rules) and ``count_pcap_streamed_distributed`` in each
   rank with the launch counters reset just before each, and the device's
   busy share of one one-shot count (torch.profiler).  ``window_count_totals``
   equals its plain version at rank 0's shard shape (the first half of
   phase 3's rows at the ranks' common width), ``ac_scan`` and the filter
   class kernels on its first 1,024 rows; the records carry the ranks'
   launches as ``distributed_launches``.
14. The verification harnesses and the demos, in process, with a seed
   drawn and printed by the run: ``tools/differential.py`` at its default
   budget (at least ``differential.DEFAULT_CASES`` random cases of each of
   the 12 kernel entry points, each held to its plain version on the card
   and every third to the ``bytes.find`` oracle; the generators must reach
   their edges), ``tools/fuzz_soak.py`` for ``SOAK_FUZZ_MINUTES`` (every
   engine against the oracle, the table route, ``find_matches``, the
   streamed pipeline from pcap, pcapng and gzip), and both demos on the
   card: ``examples/ids_demo.py`` on phase 3's capture (its alerts by
   signature and its total equal phase 3's counts, its ``MSM_DUMP`` the
   hit packets) and ``examples/flow_ids_demo.py`` on its own capture and
   on a seeded capture of ``DEMO_FLOWS`` TCP flows (its alerts, streamed
   alerts and misses equal the window kernel's counts over the reassembled
   flows and the per-packet counts).  Any divergence fails the run; the
   phase's wall and each part's seconds are printed, and the records carry
   each kernel's cases as ``soak_cases``; the fuzz soak must have run its
   flow cases (``ran["flows"]``: the texts as TCP flows through the halo
   kernel's and ``ac_scan``'s flow rounds).
15. The audits (``AUDIT_BUDGET_S``): ``tools/sanitize.py`` runs
   compute-sanitizer's memcheck, racecheck, synccheck and initcheck over
   ``tools/differential.py`` at ``AUDIT_CASES`` case an entry point, the
   kernel filter naming the port's six kernels and PyTorch's caching
   allocator off, and its planted overrun must be reported; each record
   (tool, cases, errors, hazards, warnings, blind spots, seconds, the
   card) is printed.  A sanitizer that is missing or refuses the card is
   printed as "not available" and counted as nothing checked.  Then
   ``tools/edges.py`` (``differential --edges``): every entry point at its
   largest accepted launch (2^31 - 2,048 positions on a 2 GiB tile built
   on the card) and refused one row past it, the per-row forms past 2^31,
   the DFA scans' ``split_tiles`` runs, ``find_matches``' row slices and
   the mesh summary's slices past 2^31, and 2,155,872,256 matches of
   ``b"z"`` through ``PackedTileCounter`` in int64, each exact against
   counts, rows, triples and end states known by construction, under 10
   GiB of device memory.

The line before the last is one JSON object with a record per kernel, each
with its bound (``bound_ms``: the larger of its bytes over 3.35 TB/s and its
operations over the peak rate for their type, ``bound_by`` which) and, where
one PyTorch call computes a yardstick, ``library_ms``; the last line is
``{"ok": true, "device": {...}}``.  The operations of the window, table and
filter kernels are those of the hashed probe on this run's inputs
(:func:`probe_ops`: a key-map test per position and pass, hash lookups
only where the map lets a position through, candidates' verify chains);
the per-pattern probe count of earlier versions is printed beside each of
their bounds.  Their records also carry ``device_ms``, the device time of
the call that ``ms`` times queued alone ahead of the card (``null`` where
the host could not stay ahead: the upper bound is printed instead).
"""

from __future__ import annotations

import ast
import contextlib
import ctypes
import copy
import functools
import hashlib
import io
import json
import os
import pathlib
import re
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from multithreading_string_matching_tpu_torch.utils.timing import (
    card_line,
    cuda_ms,
    queued_ms,
)

SEED = 1
MAIN_PACKETS = 100_000
ROWS_PER_PACKET_RUN = 8192
SCAN_RUNS = 20
PLAIN_RUNS = 5
SERIAL_RUNS = 3
ALT_ROUNDS = 6
RULES = 3072
SOAK_FUZZ_MINUTES = 0.5
AUDIT_CASES = 1                 # random cases an entry point, per sanitizer tool
AUDIT_TOOL_TIMEOUT_S = 45       # one tool's child process
AUDIT_BUDGET_S = 240            # phase 15 in all
EDGE_CASES = 33
EDGE_MEMORY_BYTES = 10 * 2**30
DEMO_FLOWS = 48
DEMO_FLOW_BYTES = 4096
DEMO_SEGMENT = 600
ALNUM = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


DEVICE_RUNS = 3


def device_ms(fn):
    """Device milliseconds of one call of ``fn`` queued alone ahead of the
    card (:func:`queued_ms`, median of ``DEVICE_RUNS``), or ``None`` when
    the host could not enqueue the whole call before the card reached it:
    the reading, printed as an upper bound, would hold the host's pace."""
    ms, clean = queued_ms(fn, DEVICE_RUNS)
    if clean:
        return ms
    print(f"queued device time: the host fell behind the card; {ms:.4f} ms is an upper bound")
    return None


def fmt_ms(ms) -> str:
    return "not measured (host fell behind)" if ms is None else f"{ms:.4f} ms"


# The least time the card could take for a kernel's work (the ``bound_ms`` of
# each record): the larger of its bytes (each input read once, each output
# written once) over the device memory rate and its operations over the
# peak rate for their type.  H100 SXM rates from NVIDIA's data sheet (the
# int8 tensor rate is tools/mxu_match.INT8_TENSOR_OPS_PER_S).
HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES_PER_SM = 132, 64


@functools.lru_cache(maxsize=1)
def int32_ops_per_s() -> float:
    """132 SMs x 64 INT32 lanes x ``clocks.max.sm``: derived from the card's
    clock, not a published rate."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    print(f"int32 rate: {SMS} SMs x {INT32_LANES_PER_SM} lanes x {mhz:.0f} MHz = "
          f"{SMS * INT32_LANES_PER_SM * mhz * 1e6:.6e} ops/s (derived, not published)")
    return SMS * INT32_LANES_PER_SM * mhz * 1e6


def bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """``{"bound_ms", "bound_by"}`` of a kernel that moves ``nbytes`` and
    does ``ops`` operations of a type the card runs at ``ops_per_s``."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def window_bound(wp, w, nbytes: int, out_ints: int, reps: int = 1, label: str = "") -> dict:
    """Window kernels over the ``nbytes`` real positions whose words are
    ``w`` (:func:`position_words`), ``reps`` times: one pass, its probe
    word 0 (:func:`probe_ops`)."""
    col = (wp.pat_words[:, 0], wp.pat_masks[:, 0])
    return probe_bound(label, probe_work(wp, w, filtered=False), nbytes, [lookups(w, *col)],
                       nbytes + 4 * out_ints, reps)


def position_words(tiles):
    """Sorted int64 tensor of the 4-byte little-endian word (bytes past the
    row's width read as 0) at every real payload position of ``tiles``.  A
    tile is ``(payload, lengths)``, its positions ``[0, lengths[r])``, or
    ``(payload, lengths, starts)``, its positions ``[starts[r],
    lengths[r])``."""
    import torch
    import torch.nn.functional as F

    vals = []
    for p, l, *s in tiles:
        x = F.pad(p, (0, 3)).to(torch.int64)
        L = p.shape[1]
        w = x[:, :L] | (x[:, 1:L + 1] << 8) | (x[:, 2:L + 2] << 16) | (x[:, 3:L + 3] << 24)
        pos = torch.arange(L, device=p.device)[None, :]
        keep = pos < l[:, None]
        if s:
            keep &= pos >= s[0][:, None]
        vals.append(w[keep])
    return torch.sort(torch.cat(vals)).values


def probe_hits(w, words: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Per pattern, the positions (sorted words ``w``) whose word equals its
    probe word under its mask."""
    import torch

    hits = np.zeros(len(words), np.int64)
    full = masks.astype(np.uint32) == 0xFFFFFFFF
    fw = torch.from_numpy(words[full].astype(np.int64)).to(w.device)
    hits[full] = (torch.searchsorted(w, fw, right=True) - torch.searchsorted(w, fw)).cpu().numpy()
    for u in np.flatnonzero(~full):
        hits[u] = int(((w & int(masks[u])) == int(words[u])).sum())
    return hits


def lookups(w, words, masks) -> int:
    """Hash lookups of one pass of a probe kernel over the positions whose
    words are ``w``, with ``words``/``masks`` its probe column
    (csrc/probe.cuh): one per distinct probe mask at each position whose
    low 16 bits are set in the launch's key map; at every position when a
    mask's low 16 bits are neither 0xFF nor 0xFFFF (the map is off).  Keys
    that can never fire (bits outside their mask, mask 0) build nothing."""
    import torch

    words = np.asarray(words).astype(np.uint32)
    masks = np.asarray(masks).astype(np.uint32)
    live = (masks != 0) & ((words & masks) == words)
    n_masks = int(np.unique(masks[live]).size)
    lo, key = masks[live] & 0xFFFF, words[live].astype(np.int64)
    if not n_masks:
        return 0
    if np.any((lo != 0xFFFF) & (lo != 0xFF)):
        return n_masks * int(w.numel())
    bits = np.zeros(1 << 16, bool)
    bits[key[lo == 0xFFFF] & 0xFFFF] = True
    bits[((key[lo == 0xFF] & 0xFF)[:, None] + np.arange(0, 1 << 16, 256)[None, :]).ravel()] = True
    return n_masks * int(torch.from_numpy(bits).to(w.device)[w & 0xFFFF].sum())


def probe_work(wp, w, filtered: bool):
    """``(hits, chain)`` per pattern over the positions whose words are
    ``w``: the candidates (positions where its probe word matches: the
    filter word with the filter, else word 0) and the words a candidate
    verifies (K after a filter-word hit, K - 1 after word 0)."""
    from multithreading_string_matching_tpu_torch.ops.table import filter_words

    K = -(-wp.pat_lens.astype(np.int64) // 4)
    if filtered:
        return probe_hits(w, *filter_words(wp)), K
    return probe_hits(w, wp.pat_words[:, 0], wp.pat_masks[:, 0]), K - 1


def probe_ops(work, nbytes: int, passes) -> tuple:
    """``(ops, per_pattern_ops)``: int32 operations of the hashed-probe
    kernels (csrc/probe.cuh) over ``nbytes`` real positions, and those of
    the per-pattern probe they replaced.

    Hashed, per pass over the positions (``passes`` holds each pass's
    :func:`lookups`: one pass for the window kernels and a shard block, one
    per word-count class for the class route): per position one map test
    (window build, map index, map load, bit test: 4 ops); per lookup an
    AND, a hash, a head load and a compare (4 ops); then per candidate its
    probe compare (2 ops) and its verify chain (2 ops a word).  Per
    pattern: one masked probe (2 ops) per (position, pattern), then the
    same verify chains."""
    hits, chain = work
    verify = 2 * int((hits * chain).sum())
    ops = 4 * nbytes * len(passes) + 4 * sum(passes) + 2 * int(hits.sum()) + verify
    return ops, 2 * nbytes * len(hits) + verify


def probe_bound(label: str, work, nbytes: int, passes, out_bytes: int, reps: int = 1) -> dict:
    """The record's bound from :func:`probe_ops`, ``reps`` times over
    (bytes: the payload read once and the counts written once); prints the
    per-pattern probe bound beside it."""
    ops, old = (reps * x for x in probe_ops(work, nbytes, passes))
    i32 = int32_ops_per_s()
    new, prev = bound(out_bytes, ops, i32), bound(out_bytes, old, i32)
    print(f"bound {label}: {new['bound_ms']:.4f} ms ({new['bound_by']}; {nbytes} B x {reps} "
          f"rep(s), {len(passes)} map test(s) a position, lookups {list(passes)} "
          f"({sum(passes) / max(nbytes, 1):.6f} a position), {int(work[0].sum())} candidates, "
          f"{ops:.6e} int32 ops; bytes alone {bound(out_bytes, 0, i32)['bound_ms']:.4f} ms); "
          f"per-pattern probe bound {prev['bound_ms']:.4f} ms ({len(work[0])} patterns, "
          f"{old:.6e} ops)")
    return new


def overlapping(text: bytes, pat: bytes) -> int:
    n, i = 0, text.find(pat)
    while i >= 0:
        n += 1
        i = text.find(pat, i + 1)
    return n


def rule_set(seed: int, n: int, lo: int = 4, hi: int = 32, alphabet: bytes = ALNUM):
    """``n`` unique NUL-free patterns of ``lo``..``hi`` bytes, from ``seed``."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    out = {}
    while len(out) < n:
        ln = int(rng.integers(lo, hi + 1))
        out.setdefault(bytes(letters[rng.integers(0, len(letters), size=ln)]), None)
    return list(out)


def capture_for(patterns, seed: int, tag: str) -> pathlib.Path:
    """A seeded 100,000-packet capture of ~1 KB payloads planted with
    ``patterns``, made once per machine in the temporary directory."""
    from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap

    h = hashlib.sha256(b"\x00".join(patterns)).hexdigest()[:12]
    cap = pathlib.Path(tempfile.gettempdir()) / f"msm_torch_{tag}_{h}_{seed}_{MAIN_PACKETS}.pcap"
    if not cap.exists():
        tmp = cap.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        synth_udp_pcap(tmp, MAIN_PACKETS, payload_len=1024, payload_len_jitter=256,
                       patterns=patterns, plant_rate=0.05, seed=seed)
        os.replace(tmp, cap)
        print(f"synth: {cap} ({cap.stat().st_size} bytes) in {time.perf_counter() - t0:.3f} s")
    return cap


def planted_tile(rng, pats, n, L, alphabet):
    """Random rows of ``alphabet`` (not zero past their random lengths);
    row r holds ``pats[r % len(pats)]`` where it fits."""
    letters = np.frombuffer(alphabet, np.uint8)
    p = letters[rng.integers(0, len(letters), size=(n, L))]
    for r in range(n):
        pat = pats[r % len(pats)]
        if len(pat) <= L:
            o = int(rng.integers(0, L - len(pat) + 1))
            p[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    return p, rng.integers(0, L + 1, size=n).astype(np.int32)


def one_bucket(n: int, alphabet: bytes, seed: int):
    """``n`` 4-byte patterns whose probe keys share one hash bucket of a
    launch over ``n`` patterns with one probe mask (csrc/probe.cuh)."""
    from multithreading_string_matching_tpu_torch.ops.cuda_window import probe_bucket

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    groups = {}
    while True:
        pat = bytes(letters[rng.integers(0, len(letters), size=4)])
        group = groups.setdefault(probe_bucket(int.from_bytes(pat, "little"), 0, n), set())
        group.add(pat)
        if len(group) == n:
            return sorted(group)


def probe_cases(rng):
    """(name, patterns, payload, lengths) cases aimed at the hashed probe
    (csrc/probe.cuh), on planted rows."""
    hexd = b"0123456789abcdef"
    alnum = b"abcdefghijklmnopqrstuvwxyz0123456789"
    cases = [
        ("one-probe-key-3072", [b"HTTP/1.%04d" % i for i in range(RULES)], 512, 600,
         b"HTP/1.0123456789"),
        ("one-bucket-64", one_bucket(64, hexd, SEED + 20), 512, 600, hexd),
        ("four-masks-1-2-3-4-bytes", [b"a", b"b", b"ab", b"ca", b"abc", b"bca", b"abca", b"cabc",
                                      b"abcab"], 256, 300, b"abc"),
        ("nul-inside-keys", [b"\x00a\x00b", b"a\x00\x00", b"\x00", b"\x00\x00\x00\x00",
                             b"a\x00b\x00c\x00d\x00", b"\x00\x00ab"], 256, 120, b"ab\x00"),
        ("filter-word-twice", [b"wxyzabcdwxyz", b"abcdefgh", b"ijklabcd", b"abcdmnop",
                               b"qrstabcd"], 256, 300, b"wxyzabcd"),
        ("u1-k8", [alnum[:32]], 256, 400, alnum[:32]),
        ("u3072-k8", rule_set(SEED + 21, RULES, lo=29, hi=32, alphabet=alnum), 512, 600, alnum),
        ("u9000-three-chunks",[b"c%05d" % i for i in range(9000)], 256, 300, b"c0123456789"),
    ]
    return [(name, pats, *planted_tile(rng, pats, n, L, alphabet))
            for name, pats, n, L, alphabet in cases]


def table_cases(rng):
    """(name, patterns, payload, lengths) cases aimed at the table kernels;
    every row holds a planted pattern where it fits."""

    def tile(pats, n, L, alphabet):
        return planted_tile(rng, pats, n, L, alphabet)

    mixed = rule_set(3, n=400, lo=1, hi=32, alphabet=b"abc")
    nul = [b"\x00" * k for k in range(1, 10)] + [b"a\x00b\x00c\x00d", b"ab\x00\x00ab"]
    one = [b"abcdefghijklmnopq", b"ab", b"abc", b"abcd"]
    prefix = [b"GET /index%04d.html" % i for i in range(200)]
    absent = [b"abcdwxyz", b"efghijkl", b"mnopqrst"]
    longk = [b"a" * 36, b"ab" * 32, b"b" * 132, b"ab" * 128]
    return [
        ("mixed-k1-8", mixed, *tile(mixed, 512, 600, b"abc")),
        ("nul-k1-9-not-zero-filled", nul, *tile(nul, 256, 90, b"ab\x00")),
        ("one-pattern-class", one, *tile(one, 128, 64, b"abcdefghijklmnopq")),
        ("shared-prefix-word0", prefix, *tile(prefix, 512, 256, b"GET /index0123.html")),
        ("filter-words-without-patterns", absent, *tile(absent[:1], 256, 256, b"wxyzijklqrst")),
        ("k-up-to-64-multi-segment", longk, *tile(longk, 24, 5000, b"ab")),
    ]


def reset_launches(*modules) -> None:
    for m in modules:
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


def timed_once(fn):
    """``(result, milliseconds)`` of one call of ``fn`` between CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def serial_wall(cli, cap, pat_file, patterns, counts, card) -> float:
    """Median wall seconds of ``serial`` over ``SERIAL_RUNS`` runs; each
    report must equal ``counts``."""
    serial_s = []
    for _ in range(SERIAL_RUNS):
        reported, rc, wall = report_of(cli, ["serial", cap, pat_file, "udp"])
        serial_s.append(wall)
        check(rc == 0, f"serial exited {rc}")
        check(reported == nonzero(patterns, counts),
              f"serial report differs from the main-path counts ({pat_file})")
    med = statistics.median(serial_s)
    print(f"serial wall ({len(patterns)} patterns): median {med:.4f} s of {SERIAL_RUNS} "
          f"({', '.join(f'{s:.4f}' for s in serial_s)}) [{card}]")
    return med


def kernel_cases(rng):
    """(name, patterns, payload uint8[n, L], lengths int32[n]) edge cases."""
    small = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"abcdefgh", b"abcde"]

    def ragged(n, L, alphabet=b"abc", lmax=None):
        letters = np.frombuffer(alphabet, np.uint8)
        p = letters[rng.integers(0, len(letters), size=(n, L))]
        hi = L if lmax is None else lmax
        return p, rng.integers(0, hi + 1, size=n).astype(np.int32)

    def planted(pats, n, L):
        p = rng.integers(0, 256, size=(n, L)).astype(np.uint8)
        for _ in range(n * 4):
            pat = pats[int(rng.integers(0, len(pats)))]
            r = int(rng.integers(0, n))
            o = int(rng.integers(0, L - len(pat) + 1))
            p[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
        ln = rng.integers(L // 2, L + 1, size=n).astype(np.int32)
        return p, ln

    cases = [
        ("small-ragged", small, *ragged(16, 128)),
        ("width-100", small, *ragged(5, 100)),
        ("width-13", small, *ragged(7, 13)),
        ("nul-not-zero-filled", [b"a\x00b", b"\x00\x00", b"ab", b"\x00"],
         *ragged(32, 77, b"ab\x00")),
        ("zero-rows", small, np.zeros((0, 64), np.uint8), np.zeros(0, np.int32)),
        ("zero-width", small, np.zeros((4, 0), np.uint8), np.zeros(4, np.int32)),
        ("pattern-longer-than-row", [b"abcdefghijklmnopq", b"ab"],
         *ragged(64, 8, b"abcdefgh")),
        ("lengths-past-width", small, *ragged(8, 40, lmax=60)),
        ("multi-segment-rows", small, *ragged(6, 5000)),
    ]
    rs = [b"rs%06d" % i for i in range(3072)]
    cases.append(("rs3072", rs, *planted(rs, 512, 512)))
    return cases


FLOWS = 768
FLOW_BYTES = 131_072
FLOW_SEGMENT = 1400
FLOW_SLICE = 8192
STREAM_RUNS = 3


def flow_capture(patterns, seed: int) -> pathlib.Path:
    """The flow-rate capture at 4x ``bench/flow_rate.py``'s flow count:
    ``FLOWS`` flows of ``FLOW_BYTES`` printable bytes, each planted with 8
    patterns at random offsets and 2 across a segment boundary, cut into
    ``FLOW_SEGMENT``-byte segments and interleaved; made once per machine."""
    from multithreading_string_matching_tpu_torch.io.synth import synth_tcp_flows_pcap

    h = hashlib.sha256(b"\x00".join(patterns)).hexdigest()[:12]
    cap = pathlib.Path(tempfile.gettempdir()) / f"msm_torch_flows_{h}_{seed}_{FLOWS}.pcap"
    if cap.exists():
        return cap
    rng = np.random.default_rng(seed)
    flows = []
    for i in range(FLOWS):
        pay = rng.integers(0x20, 0x7F, size=FLOW_BYTES, dtype=np.uint8)
        for _ in range(8):
            p = patterns[int(rng.integers(0, len(patterns)))]
            o = int(rng.integers(0, FLOW_BYTES - len(p)))
            pay[o : o + len(p)] = np.frombuffer(p, np.uint8)
        for _ in range(2):
            p = patterns[int(rng.integers(0, len(patterns)))]
            edge = FLOW_SEGMENT * int(rng.integers(1, FLOW_BYTES // FLOW_SEGMENT))
            o = edge - int(rng.integers(1, len(p)))
            pay[o : o + len(p)] = np.frombuffer(p, np.uint8)
        flows.append(((f"10.{i // 250}.{i % 250}.1", "10.255.0.1", 1024 + i, 80), pay.tobytes(),
                      [FLOW_SEGMENT] * (-(-FLOW_BYTES // FLOW_SEGMENT))))
    tmp = cap.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    synth_tcp_flows_pcap(tmp, flows, interleave_seed=1)
    os.replace(tmp, cap)
    print(f"synth: {cap} ({cap.stat().st_size} bytes) in {time.perf_counter() - t0:.3f} s")
    return cap


def oracle_counts(streams, patterns):
    return np.array([sum(overlapping(s, p) for s in streams) for p in patterns], np.int64)


def halo_lanes(pats, seed: int, n: int, C: int, alphabet: bytes):
    """Random ``[halo | bytes]`` rows with random real fills, random valid
    lengths (every 7th 0) and planted patterns, not zero past their length."""
    from multithreading_string_matching_tpu_torch.ops.window import WindowProgram

    wp = WindowProgram.build(pats)
    H = max(int(wp.max_len) - 1, 1)
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    x = letters[rng.integers(0, len(letters), size=(n, H + C))]
    for r in range(n):
        pat = pats[r % len(pats)]
        for _ in range(3):
            o = int(rng.integers(0, H + C - len(pat) + 1))
            x[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    eff = np.minimum(rng.integers(0, C + 1, size=n) + H, H + C).astype(np.int32)
    eff[::7] = 0
    ms = (H - rng.integers(0, H + 1, size=n)).astype(np.int32)
    return wp, H, x, eff, ms


def reorder_capture(patterns):
    """``(flows, pcap)``: 64 seeded TCP flows of 32 KB planted with
    ``patterns``, reordered, with 5% retransmits and 5% overlaps."""
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
    from multithreading_string_matching_tpu_torch.io.synth import synth_tcp_flows_pcap

    rng = np.random.default_rng(SEED + 6)
    rflows = []
    for i in range(64):
        pay = rng.integers(0x20, 0x7F, size=32 << 10, dtype=np.uint8)
        for _ in range(10):
            p = patterns[int(rng.integers(0, len(patterns)))]
            o = int(rng.integers(0, len(pay) - len(p)))
            pay[o : o + len(p)] = np.frombuffer(p, np.uint8)
        rflows.append(((f"10.77.{i}.1", "10.77.255.1", 2000 + i, 80), pay.tobytes()))
    rcap = pathlib.Path(tempfile.gettempdir()) / f"msm_torch_reorder_{os.getpid()}.pcap"
    synth_tcp_flows_pcap(rcap, rflows, segment_len=FLOW_SEGMENT, interleave_seed=2,
                         reorder_seed=3, retransmit_rate=0.05, overlap_rate=0.05, seed=4)
    rp = read_pcap(rcap)
    rcap.unlink()
    return rflows, rp


def reorder_stream(matcher, rp, **kw):
    """Counts of the reorder capture streamed in 1,000-packet slices.  The
    reorder window is one scan round: the stream holds the whole capture
    for one round."""
    from multithreading_string_matching_tpu_torch.io.pcap import slice_pcap
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher

    fs = FlowStreamMatcher(matcher, "tcp", engine="window", reorder=True, scan_bytes=1 << 40, **kw)
    for s in range(0, rp.num_packets, 1000):
        fs.feed_pcap_slice(slice_pcap(rp, s, s + 1000, copy=False))
    fs.flush()
    return fs.counts()


def device_busy(prof) -> dict:
    """Device milliseconds of a torch.profiler run: kernels, copies and the
    union of both (``busy``); empty when the trace holds no device events."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.name.startswith("Activity Buffer")]
    if not spans:
        return {}
    out = {"kernel_ms": 0.0, "copy_ms": 0.0, "busy_ms": 0.0, "events": len(spans)}
    for s, e, name in spans:
        out["copy_ms" if name.startswith(("Memcpy", "Memset")) else "kernel_ms"] += (e - s) / 1e3
    end = -1.0
    for s, e, _ in sorted(spans):
        if e > end:
            out["busy_ms"] += (e - max(s, end)) / 1e3
            end = e
    return out


def shard_phase(dev, card: str, cw, ct, big, rules_file, cap2, batch2, big_counts, big_rows,
                class_filter_ms: float, cap, pat_file, patterns, std_counts,
                head_bounds: dict) -> list:
    """Phase 7; returns the kernel record entries of the four shard kernels
    (their bounds, on the first ``ROWS_PER_PACKET_RUN`` rows, come in
    ``head_bounds`` by ``(form, "totals" | "rows")``)."""
    import torch

    from multithreading_string_matching_tpu_torch import cli
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.ops.table import filter_count, table_count
    from multithreading_string_matching_tpu_torch.parallel.mesh import make_mesh
    from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
        build_pattern_shards,
        count_matches_pattern_sharded,
        count_rows_pattern_sharded,
        count_rows_summary_pattern_sharded,
        make_2d_mesh,
        make_pattern_mesh,
    )

    t_phase = time.perf_counter()
    P, Ls = batch2.payloads, batch2.lengths
    head_p, head_l = P[:ROWS_PER_PACKET_RUN], Ls[:ROWS_PER_PACKET_RUN]
    dup = big.window.dup_map
    launches = {f"shard_{f}_count_{k}": 0 for f in ("filter", "table") for k in ("totals", "rows")}

    def drive(label, fn, key, n_launch):
        """One sharded call with the launch counters reset just before:
        exactly ``n_launch`` launches of ``key`` and none of anything else."""
        torch.cuda.synchronize()
        reset_launches(cw, ct)
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in {**cw.LAUNCHES, **ct.LAUNCHES}.items() if v}
        print(f"sharded {label}: {wall:.4f} s, launches {got}")
        check(got == {key: n_launch}, f"sharded {label} launched {got}, not {n_launch} x {key}")
        launches[key] += n_launch
        return out

    # -- the pattern axis: totals on one shard and on virtual meshes --------
    mesh1 = make_pattern_mesh([dev])
    got = drive("patterns x1 (filter)", lambda: count_matches_pattern_sharded(big, P, Ls, mesh1),
                "shard_filter_count_totals", 1)
    check(np.array_equal(got, big_counts), "pattern-sharded totals differ from phase 5's")
    os.environ["MSM_PALLAS_FILTER"] = "0"
    got = drive("patterns x1 (table)", lambda: count_matches_pattern_sharded(big, P, Ls, mesh1),
                "shard_table_count_totals", 1)
    check(np.array_equal(got, big_counts), "pattern-sharded table totals differ from phase 5's")
    got = drive("patterns x1 rows (table)",
                lambda: count_rows_pattern_sharded(big, head_p, head_l, mesh1),
                "shard_table_count_rows", 1)
    check(np.array_equal(got, big_rows), "pattern-sharded table rows differ from phase 5's")
    del os.environ["MSM_PALLAS_FILTER"]
    mesh4 = make_pattern_mesh([dev] * 4)
    for label, mesh, n in (("patterns x4", mesh4, 4),
                           ("patterns x3", make_pattern_mesh([dev] * 3), 3),
                           ("packets x patterns 2x2", make_2d_mesh(2, 2, [dev] * 4), 4)):
        got = drive(label, lambda: count_matches_pattern_sharded(big, P, Ls, mesh),
                    "shard_filter_count_totals", n)
        check(np.array_equal(got, big_counts), f"{label} totals differ from phase 5's")
    for label, mesh, n in (("x1", mesh1, 1), ("x4", mesh4, 4)):
        rows = drive(f"patterns {label} rows",
                     lambda: count_rows_pattern_sharded(big, head_p, head_l, mesh),
                     "shard_filter_count_rows", n)
        check(np.array_equal(rows, big_rows), f"pattern-sharded rows ({label}) differ")
        tot, hits = drive(f"patterns {label} summary",
                          lambda: count_rows_summary_pattern_sharded(big, head_p, head_l, mesh),
                          "shard_filter_count_rows", n)
        check(np.array_equal(tot[dup], big_rows.sum(axis=0))
              and np.array_equal(hits, big_rows.sum(axis=1) > 0),
              f"pattern-sharded summary ({label}) differs from the per-packet counts")
    print(f"pattern axis: 1, 4, 3 and 2x2 shards = phase 5's totals ({int(big_counts.sum())} "
          "matches); rows and summary = phase 5's per-packet counts")

    # -- each shard kernel against its plain version --------------------------
    max_err = {k: 0 for k in launches}

    def compare(key, got, want, name):
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{key} {name}: shape {tuple(got.shape)}")
        err = int((got.long() - want.long()).abs().max())
        max_err[key] = max(max_err[key], err)
        check(err == 0, f"{key} disagrees with the plain version on {name}")

    def block(plan, d):
        rows = slice(d * plan.S, (d + 1) * plan.S)
        return (torch.from_numpy(np.ascontiguousarray(plan.words[rows]).view(np.int32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(plan.masks[rows]).view(np.int32)).to(dev),
                torch.from_numpy(plan.lens[rows, 0].copy()).to(dev))

    hp, hl = torch.from_numpy(head_p).to(dev), torch.from_numpy(head_l).to(dev)
    fp, fl = torch.from_numpy(P).to(dev), torch.from_numpy(Ls).to(dev)
    times = {}
    for form, plain in (("filter", filter_count), ("table", table_count)):
        filtered = form == "filter"
        plan = build_pattern_shards(big.window, 1, filtered=filtered)
        kern = ct.ShardTableKernel(plan.K, plan.S, plan.use_fit, filtered, dev)
        tabs = block(plan, 0)
        tot_key, rows_key = f"shard_{form}_count_totals", f"shard_{form}_count_rows"
        want_t, plain_t = timed_once(lambda: plain(*tabs, hp, hl, plan.K))
        compare(tot_key, kern.counts(*tabs, hp, hl), want_t, f"{ROWS_PER_PACKET_RUN} rows")
        want_r, plain_r = timed_once(lambda: plain(*tabs, hp, hl, plan.K, per_row=True))
        compare(rows_key, kern.rows(*tabs, hp, hl), want_r, f"{ROWS_PER_PACKET_RUN} rows")
        full = kern.counts(*tabs, fp, fl)
        check(np.array_equal(plan.gather(full.cpu().numpy())[dup], big_counts),
              f"{tot_key} on the whole capture differs from phase 5's counts")
        times[form] = {
            "full": cuda_ms(lambda: kern.counts(*tabs, fp, fl), SCAN_RUNS),
            "totals": cuda_ms(lambda: kern.counts(*tabs, hp, hl), SCAN_RUNS),
            "rows": cuda_ms(lambda: kern.rows(*tabs, hp, hl), SCAN_RUNS),
            "dev_full": device_ms(lambda: kern.counts(*tabs, fp, fl)),
            "dev_totals": device_ms(lambda: kern.counts(*tabs, hp, hl)),
            "dev_rows": device_ms(lambda: kern.rows(*tabs, hp, hl)),
            "plain_totals": plain_t, "plain_rows": plain_r,
        }
        print(f"shard {form} kernels (K={plan.K}, S={plan.S}) = plain on {ROWS_PER_PACKET_RUN} "
              f"rows: totals {int(want_t.sum())}")
    # Five blocks with padded slots (C=615, S=640), each form: kernels = plain
    # per row.  The filter form's padded slots hold the never-fires sentinel,
    # the table form's a probe that fires everywhere and never fits.
    for form, plain in (("filter", filter_count), ("table", table_count)):
        plan5 = build_pattern_shards(big.window, 5, filtered=form == "filter")
        kern5 = ct.ShardTableKernel(plan5.K, plan5.S, plan5.use_fit, form == "filter", dev)
        for d in range(5):
            tabs = block(plan5, d)
            want_r = plain(*tabs, hp, hl, plan5.K, per_row=True)
            compare(f"shard_{form}_count_rows", kern5.rows(*tabs, hp, hl), want_r,
                    f"block {d} of 5")
            compare(f"shard_{form}_count_totals", kern5.counts(*tabs, hp, hl),
                    want_r.sum(dim=0, dtype=torch.int32), f"block {d} of 5")
            check(not want_r[:, plan5.valid(d):].any(), f"padded slots of block {d} counted")
        print(f"shard {form} kernels = plain on 5 padded blocks (C={plan5.C}, S={plan5.S})")
    class_same_ms = cuda_ms(lambda: big.kernels.count_tiles([(fp, fl)]), SCAN_RUNS)
    nb = int(batch2.total_payload_bytes)
    for form, t in times.items():
        print(f"shard {form} totals kernel, resident tile {tuple(fp.shape)}: {t['full']:.4f} ms = "
              f"{nb / t['full'] * 1e3:.6e} payload B/s (median of {SCAN_RUNS}); device "
              f"time {fmt_ms(t['dev_full'])} [{card}]")
    print(f"class-route filter kernels, same tile: {class_same_ms:.4f} ms; on phase 5's "
          f"bucketed tiles: {class_filter_ms:.4f} ms [{card}]")
    for form, t in times.items():
        print(f"shard {form} on {ROWS_PER_PACKET_RUN} rows: totals {t['totals']:.4f} ms, rows "
              f"{t['rows']:.4f} ms (median of {SCAN_RUNS}); device time "
              f"{fmt_ms(t['dev_totals'])}, {fmt_ms(t['dev_rows'])}; plain totals "
              f"{t['plain_totals']:.4f} ms, rows "
              f"{t['plain_rows']:.4f} ms (1 run) [{card}]")

    # -- the packet axis through the CLI ----------------------------------------
    def match(pcap, pats, *flags):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["match", "--pcap", str(pcap), "--patterns", str(pats), "--json",
                           *flags])
        wall = time.perf_counter() - t0
        check(rc == 0, f"match {' '.join(flags)} exited {rc}")
        return json.loads(out.getvalue().splitlines()[-1]), wall

    torch.cuda.synchronize()
    reset_launches(cw, ct)
    blob, _ = match(cap, pat_file, "--sharded", "--shard-axis", "packets")
    got = {k: v for k, v in {**cw.LAUNCHES, **ct.LAUNCHES}.items() if v}
    check(blob["counts"] == std_counts.tolist(), "match --sharded (packets) differs from phase 3")
    check(set(got) == {"window_count_totals"}, f"match --sharded (packets) launched {got}")
    check(blob["execution"]["shard_axis"] == "packets", f"execution {blob['execution']}")
    print(f"match --sharded --shard-axis packets: phase 3's counts, launches {got}")

    walls = {"match": [], "match --sharded --shard-axis patterns": []}
    for _ in range(SERIAL_RUNS):
        for label, flags in (("match", ()),
                             ("match --sharded --shard-axis patterns",
                              ("--sharded", "--shard-axis", "patterns"))):
            blob, wall = match(cap2, rules_file, *flags)
            check(blob["counts"] == big_counts.tolist(), f"{label} counts differ from phase 5's")
            walls[label].append(wall)
    check(blob["execution"]["shard_axis"] == "patterns", f"execution {blob['execution']}")
    for label, ws in walls.items():
        print(f"{label} --json ({RULES} rules): median {statistics.median(ws):.4f} s of "
              f"{SERIAL_RUNS} ({', '.join(f'{w:.4f}' for w in ws)}) [{card}]")

    # -- the sharded flow lanes ---------------------------------------------
    _, rp = reorder_capture(patterns)
    std = Matcher(patterns, device=dev)
    want = reorder_stream(std, rp)
    torch.cuda.synchronize()
    reset_launches(cw, ct)
    got_c = reorder_stream(std, rp, sharded=True, mesh=make_mesh([dev] * 2))
    got = {k: v for k, v in {**cw.LAUNCHES, **ct.LAUNCHES}.items() if v}
    check(np.array_equal(got_c, want), "the sharded flow stream differs from the unsharded one")
    check(set(got) == {"window_count_halo"} and got["window_count_halo"] >= 2,
          f"the sharded flow stream launched {got}")
    print(f"sharded flow lanes (2 shards): {int(got_c.sum())} matches = unsharded, launches {got}")

    # -- device busy share of one pattern-sharded count ------------------------
    from torch.profiler import ProfilerActivity, profile

    count_matches_pattern_sharded(big, P, Ls, mesh1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        count_matches_pattern_sharded(big, P, Ls, mesh1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy(prof)
    if busy:
        print(f"pattern-sharded count under torch.profiler: {wall:.4f} s wall, device busy "
              f"{busy['busy_ms']:.4f} ms (kernels {busy['kernel_ms']:.4f} ms, copies "
              f"{busy['copy_ms']:.4f} ms, {busy['events']} events): busy share "
              f"{busy['busy_ms'] / 1e3 / wall:.4f} [{card}]")
    else:
        print(f"pattern-sharded count under torch.profiler: {wall:.4f} s wall; the trace holds "
              "no device events: busy share not measured")
    print(f"phase 7: {time.perf_counter() - t_phase:.3f} s")

    tsrc = "multithreading_string_matching_tpu_torch/csrc/table_count.cu"
    tref = "multithreading_string_matching_tpu/ops/pallas_table.py"
    return [{"name": f"shard_{form}_count_{kind}", "route": "cuda", "source": tsrc,
             "replaces": f"{tref}:{line}", "launches": launches[f"shard_{form}_count_{kind}"],
             "max_abs_err": max_err[f"shard_{form}_count_{kind}"], "ms": times[form][kind],
             "device_ms": times[form][f"dev_{kind}"],
             "plain_ms": times[form][f"plain_{kind}"], "library_ms": None,
             **head_bounds[(form, kind)]}
            for form in ("filter", "table") for kind, line in (("totals", 474), ("rows", 501))]


def flow_phase(dev, card: str, patterns, pat_file, cw, ct):
    """Phase 6; returns the kernel record entry of ``window_count_halo`` and
    the flow capture's counts."""
    import torch

    from multithreading_string_matching_tpu_torch import cli
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.flows import extract_flows
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
    from multithreading_string_matching_tpu_torch.io.synth import synth_tcp_flows_pcap
    from multithreading_string_matching_tpu_torch.ops.window import window_count_halo_plain
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher

    max_err = 0

    def compare(got, want, name):
        nonlocal max_err
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"window_count_halo {name}: shape {tuple(got.shape)}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        check(err == 0, f"window_count_halo disagrees with the plain version on {name}")

    # -- the halo kernel against its plain version ------------------------
    rs = [b"rs%06d" % i for i in range(RULES)]
    for name, pats, seed, n, C, alphabet in (
        ("random-fills", [b"ab", b"bca", b"aaaa", b"abcab"], 61, 256, 64, b"abc"),
        ("nul", [b"a\x00b", b"\x00c", b"ca", b"\x00\x00\x01"], 62, 256, 96, b"abc\x00\x01"),
        ("rows-wider-than-a-segment", [b"ab", b"abcdefgh", b"b"], 63, 16, 5000, b"abcdefgh"),
        ("standin-sub-lanes", patterns, 64, 1024, 2048, ALNUM + b" /:."),
        ("rs3072", rs, 65, 128, 256, b"rs0123"),
        ("four-probe-masks", [b"a", b"ab", b"abc", b"abcd", b"bcab"], 66, 256, 300, b"abc"),
        ("one-probe-key-3072", [b"HTTP/1.%04d" % i for i in range(RULES)], 67, 64, 400,
         b"HTP/1.0123456789"),
    ):
        wp, H, x, eff, ms = halo_lanes(pats, seed, n, C, alphabet)
        tabs = wp.tables(dev)
        tx, te, tm = (torch.from_numpy(a).to(dev) for a in (x, eff, ms))
        want = window_count_halo_plain(tx, te, tm, H, tabs)
        compare(cw.window_count_halo(tx, te, tm, *tabs, H), want, name)
        print(f"halo kernel check {name}: U={len(wp.unique_patterns)} R={n} W={H + C} "
              f"totals={int(want.sum())}: equal")

    # -- the main flow path ----------------------------------------------
    cap = flow_capture(patterns, SEED)
    pcap = read_pcap(cap)
    slices = [slice_pcap(pcap, s, s + FLOW_SLICE, copy=False)
              for s in range(0, pcap.num_packets, FLOW_SLICE)]
    matcher = Matcher(patterns, device=dev)

    def stream(m, **kw):
        fs = FlowStreamMatcher(m, "tcp", engine="window", **kw)
        t0 = time.perf_counter()
        for sl in slices:
            fs.feed_pcap_slice(sl)
        fs.flush()
        counts = fs.counts()
        return fs, counts, time.perf_counter() - t0

    stream(matcher)  # builds nothing new; warms the allocator and the tables
    largest = {}
    kern = matcher.halo_kernels
    orig_halo = kern.count_tile_halo

    def recording(x, eff, ms):
        if x.numel() > largest.get("numel", 0):
            largest.update(numel=x.numel(), args=(x, eff, ms))
        return orig_halo(x, eff, ms)

    kern.count_tile_halo = recording
    torch.cuda.synchronize()
    reset_launches(cw, ct)
    fs, counts, wall = stream(matcher)
    launches = {**cw.LAUNCHES, **ct.LAUNCHES}
    kern.count_tile_halo = orig_halo
    rounds = fs._round
    print(f"flow path: {pcap.num_packets} packets, {fs.flows_seen} flows, {fs.packets_seen} "
          f"segments, {fs.bytes_seen} stream bytes, {rounds} rounds, {wall:.3f} s, "
          f"launches {launches}, {int(counts.sum())} matches")
    check(launches["window_count_halo"] >= rounds > 0,
          f"window_count_halo launched {launches['window_count_halo']} times in {rounds} rounds")
    check(not any(v for k, v in launches.items() if k != "window_count_halo"),
          f"the flow stream launched other kernels {launches}")
    check(counts.shape == (len(patterns),) and int(counts.sum()) > 0, "flow counts")

    fb = extract_flows(pcap, "tcp")
    check(fb.num_flows == FLOWS and fb.total_payload_bytes == fs.bytes_seen, "flow batch")
    oneshot = matcher.count(fb.payloads, fb.lengths)
    _, plain_counts, plain_wall = stream(Matcher(patterns, engine="window", device=dev))
    streams = [fb.stream(f) for f in range(fb.num_flows)]
    t0 = time.perf_counter()
    want = oracle_counts(streams, patterns)
    py_s = time.perf_counter() - t0
    per_packet = matcher.count_pcap(cap, "tcp")
    check(np.array_equal(counts, oneshot), "flow stream differs from one-shot extract_flows + count")
    check(np.array_equal(counts, plain_counts), "flow stream differs from the plain version's stream")
    check(np.array_equal(counts, want), "flow stream differs from the pure-Python count")
    check(int(per_packet.sum()) < int(counts.sum()),
          "the per-packet count is not below the reassembled count")
    print(f"flow path: stream = one-shot = plain stream ({plain_wall:.3f} s) = pure Python "
          f"({py_s:.3f} s): {int(counts.sum())} matches; per packet {int(per_packet.sum())}")

    # -- reorder, NUL + nocase, the chunk loop, a forced drain ------------
    rflows, rp = reorder_capture(patterns)
    before = cw.LAUNCHES["window_count_halo"]
    rcounts = reorder_stream(matcher, rp)
    rfb = extract_flows(rp, "tcp", reorder=True)
    rwant = oracle_counts([p for _, p in rflows], patterns)
    check(cw.LAUNCHES["window_count_halo"] > before, "the reorder stream launched no halo kernel")
    check(np.array_equal(rcounts, matcher.count(rfb.payloads, rfb.lengths))
          and np.array_equal(rcounts, rwant), "reorder stream differs")
    print(f"reorder: {rp.num_packets} packets, {int(rcounts.sum())} matches = "
          "extract_flows(reorder=True) + count = pure Python over the true streams")

    key_a, key_b = ("10.0.0.1", "10.0.0.2", 1111, 80), ("10.0.0.3", "10.0.0.2", 2222, 80)
    p1 = pathlib.Path(tempfile.gettempdir()) / f"msm_torch_nul1_{os.getpid()}.pcap"
    p2 = p1.with_name(f"msm_torch_nul2_{os.getpid()}.pcap")
    synth_tcp_flows_pcap(p1, [(key_a, b"xxE\x00", [4])])
    synth_tcp_flows_pcap(p2, [(key_a, b"Fyy", [3]), (key_b, b"qAb", [3])])
    nfs = FlowStreamMatcher(Matcher([b"E\x00F", b"ab"], case_insensitive=True, device=dev),
                            "tcp", engine="window", scan_bytes=1, width=4, min_lanes=4)
    before = cw.LAUNCHES["window_count_halo"]
    for pth in (p1, p2):
        nfs.feed_pcap_slice(read_pcap(pth))
        nfs.flush()
        pth.unlink()
    check(nfs.counts().tolist() == [1, 1], f"NUL + nocase flow counts {nfs.counts().tolist()}")
    check(cw.LAUNCHES["window_count_halo"] >= before + 2, "the NUL + nocase rounds launched no kernel")
    print("NUL + nocase across rounds: [1, 1]")

    head = slices[:2]
    ref_fs = FlowStreamMatcher(matcher, "tcp", engine="window")
    for sl in head:
        ref_fs.feed_pcap_slice(sl)
    ref_fs.flush()
    old_budget = FlowStreamMatcher.ROUND_BUDGET_BYTES
    FlowStreamMatcher.ROUND_BUDGET_BYTES = 1
    loop_fs = FlowStreamMatcher(matcher, "tcp", engine="window")
    before = cw.LAUNCHES["window_count_halo"]
    for sl in head:
        loop_fs.feed_pcap_slice(sl)
    loop_fs.flush()
    FlowStreamMatcher.ROUND_BUDGET_BYTES = old_budget
    loop_launches = cw.LAUNCHES["window_count_halo"] - before
    drain_fs = FlowStreamMatcher(matcher, "tcp", engine="window")
    acc = drain_fs._acc_device

    def acc_and_drain(c, *, positions):
        acc(c, positions=positions)
        drain_fs._drain_device()

    drain_fs._acc_device = acc_and_drain
    before = cw.LAUNCHES["window_count_halo"]
    for sl in head:
        drain_fs.feed_pcap_slice(sl)
    drain_fs.flush()
    check(cw.LAUNCHES["window_count_halo"] - before >= drain_fs._round > 0,
          "the drained stream did not launch the halo kernel every round")
    check(loop_launches > loop_fs._round, f"the chunk loop launched {loop_launches} kernels")
    check(np.array_equal(loop_fs.counts(), ref_fs.counts())
          and np.array_equal(drain_fs.counts(), ref_fs.counts()),
          "chunk-loop or drained counts differ")
    print(f"chunk loop ({loop_launches} launches in {loop_fs._round} rounds) and forced drain: "
          f"{int(ref_fs.counts().sum())} matches, equal")

    # -- times --------------------------------------------------------------
    walls = []
    for _ in range(STREAM_RUNS):
        f_, c_, w_ = stream(matcher)
        check(np.array_equal(c_, counts), "a timed stream run differs")
        walls.append(w_)
    med = statistics.median(walls)
    print(f"flow stream: median {med:.4f} s of {STREAM_RUNS} "
          f"({', '.join(f'{w:.4f}' for w in walls)}) = {fs.bytes_seen / med:.6e} stream B/s, "
          f"{rounds} rounds [{card}]")

    # Where a stream's wall time goes: the scan rounds (synchronised at
    # their end) against the rest, which is the host feed.
    split = {"round": 0.0, "scan": 0.0}
    tfs = FlowStreamMatcher(matcher, "tcp", engine="window")
    scan_impl, window_round = tfs._scan_impl, tfs._window_round

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return out
        return wrapper

    tfs._scan_impl, tfs._window_round = timed("scan", scan_impl), timed("round", window_round)
    t0 = time.perf_counter()
    for sl in slices:
        tfs.feed_pcap_slice(sl)
    tfs.flush()
    tfs.counts()
    total = time.perf_counter() - t0
    print(f"flow stream split: total {total:.4f} s = feed {total - split['scan']:.4f} s "
          f"+ scan {split['scan']:.4f} s (round buffers {split['scan'] - split['round']:.4f} s, "
          f"sub-lane re-layout + copy + kernel {split['round']:.4f} s) [{card}]")

    x, eff, ms = largest["args"]
    words, masks, lens = kern.words, kern.masks, kern.lens
    H = kern.halo_width
    want_tile = window_count_halo_plain(x, eff, ms, H, (words, masks, lens))
    compare(cw.window_count_halo(x, eff, ms, words, masks, lens, H), want_tile, "largest round tile")
    halo_ms = cuda_ms(lambda: cw.window_count_halo(x, eff, ms, words, masks, lens, H), SCAN_RUNS)
    halo_dev = device_ms(lambda: cw.window_count_halo(x, eff, ms, words, masks, lens, H))
    plain_ms = cuda_ms(lambda: window_count_halo_plain(x, eff, ms, H, (words, masks, lens)),
                       PLAIN_RUNS)
    tile_bytes = int(eff.clamp(min=0).sum())
    positions = int((eff - ms.clamp(min=0)).clamp(min=0).sum())  # those the kernel scans
    print(f"halo kernel, largest round tile {tuple(x.shape)} ({tile_bytes} valid bytes incl. "
          f"halos): {halo_ms:.4f} ms = {tile_bytes / halo_ms * 1e3:.6e} B/s (median of "
          f"{SCAN_RUNS}), device time {fmt_ms(halo_dev)}; plain {plain_ms:.4f} ms (median of "
          f"{PLAIN_RUNS}) [{card}]")

    for flags in (["--flows", "--stream"], ["--flows"]):
        out = io.StringIO()
        halo_before = cw.LAUNCHES["window_count_halo"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["match", "--pcap", str(cap), "--patterns", str(pat_file), "--mode",
                           "tcp", "--json", *flags])
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"match {' '.join(flags)} exited {rc}")
        blob = json.loads(out.getvalue().splitlines()[-1])
        halo_launches = cw.LAUNCHES["window_count_halo"] - halo_before
        check(blob["counts"] == counts.tolist() and blob["flows"] == FLOWS,
              f"match {' '.join(flags)} counts differ")
        check((halo_launches > 0) == ("--stream" in flags),
              f"match {' '.join(flags)} launched window_count_halo {halo_launches} times")
        print(f"match {' '.join(flags)} --json: {cli_s:.4f} s wall, phases {blob['phases']}, "
              f"window_count_halo launches {halo_launches} [{card}]")

    return {"name": "window_count_halo", "route": "cuda",
            "source": "multithreading_string_matching_tpu_torch/csrc/window_count.cu",
            "replaces": "multithreading_string_matching_tpu/ops/pallas_window.py:473",
            "launches": launches["window_count_halo"], "max_abs_err": max_err,
            "ms": halo_ms, "device_ms": halo_dev, "plain_ms": plain_ms, "library_ms": None,
            **window_bound(kern.wp, position_words([(x, eff, ms.clamp(min=0))]), positions,
                           kern.num_unique, label="window_count_halo")}, counts


# Patterns of 8, 20 and 33 bytes (C = 264: three groups of k-steps).
MXU_BOUNDARY_PATS = [b"abcdefgh", b"xy" * 10, b"q" + b"r" * 31 + b"q"]
STANDIN_FILE = (pathlib.Path(__file__).resolve().parent
                / "multithreading_string_matching_tpu_torch/data/strings_standin.txt")


def boundary_rows(pats, seg: int = 64, L: int = 2 * 2048 + 37):
    """Rows of ``z`` with one pattern each, at every offset that touches or
    straddles a ``seg``-position boundary (the mxu kernel's 64-position
    M-tiles, where its units and their alternating ring slots may start,
    and its 2,048-position unit limit inside a row); rows are full width."""
    rows = []
    for pat in pats:
        for b in range(seg, L, seg):
            for o in range(max(0, b - len(pat) - 1), min(b + 2, L - len(pat) + 1)):
                row = np.full(L, ord("z"), np.uint8)
                row[o : o + len(pat)] = np.frombuffer(pat, np.uint8)
                rows.append(row)
    return np.stack(rows), np.full(len(rows), L, np.int32)


def sass_mix(lib_path: str, key: str = "mxu") -> str:
    """Tensor-core opcodes of the functions named ``*key*`` in a built
    library, from ``cuobjdump -sass``: warpgroup MMA (``*GMMA``) against
    ``mma.sync`` (``IMMA``/``HMMA``); "not available" without cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "not available"
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        return "not available"
    mix, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if key in m.group(1) else None
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*MMA)\b", line) if fn else None
        if m:
            kind = "GMMA" if m.group(1).endswith("GMMA") else "mma.sync"
            mix.setdefault(fn, {}).setdefault(f"{kind}:{m.group(1)}", 0)
            mix[fn][f"{kind}:{m.group(1)}"] += 1
    return json.dumps(mix) if mix else "no tensor-core opcodes found"


def mxu_cases(rng, dev):
    """(name, patterns, payload uint8[n, L] on ``dev``) cases for the
    tensor-core kernel; rows hold planted patterns and are zero past random
    lengths, as staged tiles are."""
    import torch

    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns

    def tile(pats, n, L, alphabet):
        letters = np.frombuffer(alphabet, np.uint8)
        x = letters[rng.integers(0, len(letters), size=(n, L))]
        for _ in range(2 * n):
            p = pats[int(rng.integers(0, len(pats)))]
            if len(p) <= L:
                r, o = int(rng.integers(0, n)), int(rng.integers(0, L - len(p) + 1))
                x[r, o : o + len(p)] = np.frombuffer(p, np.uint8)
        ln = rng.integers(0, L + 1, size=n)
        x[np.arange(L)[None, :] >= ln[:, None]] = 0
        return x, ln.astype(np.int32)

    x_ = [b"x%03d" % i for i in range(257)]
    long_ = [b"a", b"ab" * 49 + b"a", b"b" * 99, b"ba", b"b"]
    rs = [b"rs%06d" % i for i in range(RULES)]
    pt = [b"pt%06d" % i for i in range(RULES)]
    std = list(dict.fromkeys(load_patterns(STANDIN_FILE)))
    cases = [
        ("width-1000-rows-37", [b"GET /", b"a", b"Host: "], *tile([b"GET /", b"a", b"Host: "],
                                                                  37, 1000, ALNUM + b" /:")),
        ("width-13-rows-9", [b"ab", b"b", b"abcdefgh"], *tile([b"ab", b"b", b"abcdefgh"], 9, 13, b"abc")),
        ("u1-width-300", [b"abc"], *tile([b"abc"], 50, 300, b"abc")),
        ("u127", x_[:127], *tile(x_[:127], 41, 260, b"x0123")),
        ("u128", x_[:128], *tile(x_[:128], 41, 260, b"x0123")),
        ("u129", x_[:129], *tile(x_[:129], 41, 260, b"x0123")),
        ("u3072", rs, *tile(rs, 97, 517, b"rs0123")),
        ("one-byte-and-m-max-99", long_, *tile(long_, 23, 777, b"ab")),
        ("zero-rows", [b"ab"], np.zeros((0, 64), np.uint8), np.zeros(0, np.int32)),
        # the wgmma tiling's edges: N-tile widths, pt x 3,072 at C = 64,
        # rows shorter than, equal to and past one 64-position M-tile, more
        # row segments than the persistent grid has blocks, and planted
        # patterns straddling every 64-position boundary (where units start)
        *[(f"u{u}", x_[:u], *tile(x_[:u], 41, 260, b"x0123")) for u in (88, 96, 256, 257)],
        ("pt3072-c64", pt, *tile(pt, 97, 517, b"pt0123")),
        *[(f"width-{L}", [b"ab", b"bab", b"a" * 20], *tile([b"ab", b"bab", b"a" * 20], 300, L, b"ab"))
          for L in (1, 63, 65)],
        ("segments-past-grid", std, *tile(std, 3000, 1100, ALNUM + b" /:")),
        *[(name, pats, *tile(pats, 200, 700, pats[0][:1] + b"0123456789"))
          for name, pats in (("u90-k4", [b"k%014d" % i for i in range(90)]),
                             ("u60-k4", [b"q%015d" % i for i in range(60)]))],
        ("segment-boundaries", MXU_BOUNDARY_PATS, *boundary_rows(MXU_BOUNDARY_PATS)),
    ]
    pk, pl = tile([b"abc", b"cab", b"b"], 300, 90, b"abc")
    prep = Matcher([b"abc", b"cab", b"b"], device="cpu").prepare(pk, pl, packed=True,
                                                                 pack_width=1000)
    check(prep.packed, "the packed case did not pack")
    cases.append(("packed-0x00-separators", [b"abc", b"cab", b"b"], prep.tiles[0][0].numpy(),
                  prep.tiles[0][1].numpy()))
    return [(name, pats, torch.from_numpy(np.ascontiguousarray(x)).to(dev))
            for name, pats, x, _ in cases]


def mxu_phase(dev, card: str, mx, matcher, prep, std_counts, head_p, head_l) -> dict:
    """Phase 8; returns the kernel record entry of ``mxu_count``."""
    import torch

    from multithreading_string_matching_tpu_torch.ops.cuda_table import CudaTableMatcher
    from multithreading_string_matching_tpu_torch.tools import mxu_match

    t_phase = time.perf_counter()
    max_err = 0

    def compare(got, want, name):
        nonlocal max_err
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"mxu_count {name}: shape {tuple(got.shape)}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        check(err == 0, f"mxu_count disagrees with the plain version on {name}")

    # -- the kernel against its plain version -------------------------------
    for name, pats, x in mxu_cases(np.random.default_rng(SEED + 8), dev):
        P, tgt, m_max = mx.bit_tables(pats)
        P, tgt = torch.from_numpy(P).to(dev), torch.from_numpy(tgt).to(dev)
        want = mx.mxu_count_plain(P, tgt, m_max, x)
        for reps in (1, 3):
            compare(mx.mxu_count(x, P, tgt, reps=reps), reps * want, f"{name}, reps={reps}")
            compare(mx.mxu_count(x, P, tgt, reps=reps, live=len(pats)), reps * want,
                    f"{name}, reps={reps}, live={len(pats)}")
        width = mx.tile_shape(len(pats), -(-P.shape[1] // mx.K_STEP) * mx.K_STEP)[0]
        print(f"mxu kernel check {name}: U={len(pats)} m_max={m_max} n={x.shape[0]} "
              f"L={x.shape[1]} wgmma N={width} totals={int(want.sum())}: equal (reps 1 and 3, "
              "all slots and live)")
    print(f"mxu_count instruction mix (cuobjdump -sass): {sass_mix(mx.BUILD_INFO['path'])}")

    # -- the measurement path, launches counted --------------------------------
    uniq = list(matcher.window.unique_patterns)
    mxm = mx.MxuMatcher(uniq, dev)
    table = CudaTableMatcher(matcher.window, dev, assume_zero_padded=True)
    batch = mxu_match.corpus()
    torch.cuda.synchronize()
    reset_launches(mx)
    rows, expected = [], 0
    for name, pats in mxu_match.pattern_sets():
        row = mxu_match.measure(batch, name, pats, dev)
        expected += (1 + mxu_match.WARMUP + mxu_match.RUNS) * row["tiles"]
        rows.append(row)
    got = mxm.count_tiles(prep.tiles)
    expected += sum(1 for p, _ in prep.tiles if p.numel())
    launches = dict(mx.LAUNCHES)
    print(f"mxu path: launches {launches}, expected {expected} mxu_count")
    check(launches == {"mxu_count": expected, "mxu_count_repeated": 0},
          f"mxu path launched {launches}, not {expected} x mxu_count")
    for row in rows:
        print(f"tools.mxu_match {json.dumps(row)}")
    check(rows[1]["matches"] == rows[2]["matches"] > 0, "pt sets' matches differ")
    check(np.array_equal(got.cpu().numpy()[matcher.window.dup_map], std_counts),
          "mxu totals over phase 3's tiles differ from the window kernel's counts")
    check(torch.equal(got, table.count_tiles(prep.tiles, expand_duplicates=False)),
          "mxu totals over phase 3's tiles differ from the table kernel's")
    first = matcher.prepare(head_p[:200], head_l[:200])
    want_py = [sum(overlapping(head_p[r, : head_l[r]].tobytes(), p) for r in range(200))
               for p in uniq]
    check(mxm.count_tiles(first.tiles).tolist() == want_py,
          "mxu totals on the first 200 rows differ from the pure-Python count")
    print(f"mxu over phase 3's {len(prep.tiles)} tiles: {int(got.sum())} matches = window kernel "
          "= table kernel; first 200 rows = pure Python")

    # -- times ------------------------------------------------------------------
    nbytes = prep.total_payload_bytes
    ms = cuda_ms(lambda: mxm.count_tiles(prep.tiles), SCAN_RUNS)
    dev_ms, clean = queued_ms(lambda: mxm.count_tiles(prep.tiles))
    P, tgt = mxm._P, mxm._tgt
    plain_tiles = []

    def plain_all():
        plain_tiles[:] = [mx.mxu_count_plain(P, tgt, mxm.m_max, p) for p, _ in prep.tiles]

    _, plain_ms = timed_once(plain_all)
    for i, ((p, _), want) in enumerate(zip(prep.tiles, plain_tiles)):
        compare(mx.mxu_count(p, P, tgt), want, f"phase 3 tile {i}")
    width, wgs, smem = mx.tile_shape(mxm.num_unique, P.shape[1])
    print(f"mxu kernel launch shape, stand-in set: wgmma N={width}, {wgs} warpgroups a block, "
          f"{smem} bytes of shared memory a block")
    print(f"mxu kernel, stand-in set over phase 3's resident tiles (wgmma N={width}): {ms:.4f} ms = "
          f"{nbytes / ms * 1e3:.6e} payload B/s (median of {SCAN_RUNS}); device {fmt_ms(dev_ms)} "
          f"({'queued alone' if clean else 'upper bound: the host fell behind'}); plain "
          f"{plain_ms:.4f} ms (1 run), equal on every tile [{card}]")
    x = prep.tiles[0][0][:1024].contiguous()
    planes = mx._planes(x, P.shape[1] // 8).to(torch.int8).reshape(-1, P.shape[1])
    lib_counts = (torch._int_mm(planes, P.t()) == tgt).sum(dim=0, dtype=torch.int32)
    compare(mx.mxu_count(x, P, tgt), lib_counts, "the first 1,024 rows")
    lib_ms = cuda_ms(lambda: torch._int_mm(planes, P.t()), SCAN_RUNS)
    rows_ms = cuda_ms(lambda: mx.mxu_count(x, P, tgt), SCAN_RUNS)
    print(f"torch._int_mm, the score product alone (no bit-plane build, no epilogue), first "
          f"1,024 rows of tile 0 {tuple(x.shape)}: {lib_ms:.4f} ms; mxu_count on the same rows: "
          f"{rows_ms:.4f} ms (medians of {SCAN_RUNS}) [{card}]")

    # The stand-in set over phase 3's tiles: the tensor-core kernel against
    # the table and window kernels, alternated (A B C, then C B A) so drift
    # within the call falls on all three alike.
    rivals = [("mxu", lambda: mxm.count_tiles(prep.tiles)),
              ("table", lambda: table.count_tiles(prep.tiles, expand_duplicates=False)),
              ("window", lambda: matcher.kernels.count_tiles(prep.tiles))]
    alt = {name: [] for name, _ in rivals}
    for r in range(ALT_ROUNDS):
        for name, fn in rivals if r % 2 == 0 else rivals[::-1]:
            alt[name].append(cuda_ms(fn, SCAN_RUNS))
    for name, times in alt.items():
        print(f"alternated, stand-in set over phase 3's tiles, {name} kernel: median "
              f"{statistics.median(times):.4f} ms of {ALT_ROUNDS} rounds "
              f"({', '.join(f'{t:.4f}' for t in times)}; each a median of {SCAN_RUNS}) [{card}]")
    print(f"phase 8: {time.perf_counter() - t_phase:.3f} s")
    ops = mxu_match.mxu_ops(nbytes, mxm.num_unique, mxm.m_max)
    rec_bound = bound(nbytes + 4 * mxm.num_unique, ops, mxu_match.INT8_TENSOR_OPS_PER_S)
    print(f"mxu kernel: {rec_bound['bound_ms']:.4f} ms bound / {ms:.4f} ms = "
          f"{rec_bound['bound_ms'] / ms:.4f} of its bound [{card}]")
    return {"name": "mxu_count", "route": "cuda",
            "source": "multithreading_string_matching_tpu_torch/csrc/mxu_count.cu",
            "replaces": "bench/mxu_match.py:125", "launches": launches["mxu_count"],
            "max_abs_err": max_err, "ms": ms, "device_ms": dev_ms if clean else None,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_covers": "torch._int_mm score product only, first 1,024 rows of tile 0",
            "ms_library_rows": rows_ms, "wgmma_n": width, **rec_bound,
            "bound_share": rec_bound["bound_ms"] / ms}


def parse_report(text: str):
    """``({pattern: count}, elapsed seconds)`` of one printed report."""
    lines = text.splitlines()
    check(len(lines) > 2 and lines[-1].startswith("Elapsed time = "), f"no report: {text[-500:]!r}")
    reported = {}
    for line in lines[1:-1]:
        name, _, rest = line.rpartition(": ")
        reported.setdefault(name, int(rest.split()[0]))
    return reported, float(lines[-1].split()[3])


def report_of(cli, argv):
    """``({pattern: count}, exit code, wall seconds)`` of one command whose
    stdout is the reference's report (nonzero counts, first line a header,
    last the elapsed time)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    wall = time.perf_counter() - t0
    return parse_report(out.getvalue())[0], rc, wall


def nonzero(patterns, counts) -> dict:
    return {p.decode("latin-1"): int(c) for p, c in zip(patterns, counts) if c}


STREAM_TILE = (4096, 2048)   # count_pcap_streamed's default tile
STREAM_BATCH = 8192          # and its ingest batch
TASK_BATCH = 100             # count_pcap_pipelined's batch


def split_pass(card: str, cw, matcher, cap, counts, tiles: int) -> dict:
    """Where one streamed pass spends its time, by the program's own spans
    (``utils.timing.span``): one ``count_pcap_streamed`` call under
    torch.profiler; prints each ``msm`` range's count, seconds and self
    seconds (less the union of the other ``msm`` ranges inside it) from the
    Chrome trace, and the trace's copy and kernel device milliseconds.
    ``key_averages`` is not used: it reads no self time for a range that
    encloses device work.  Counts must equal ``counts``, with one window
    launch and one ``msm.stage.dispatch`` span a tile.  Returns the self
    seconds by range."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multithreading_string_matching_tpu_torch.parallel import pipeline as pp

    pp.count_pcap_streamed(matcher, cap, "udp")  # warm
    torch.cuda.synchronize()
    reset_launches(cw)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = pp.count_pcap_streamed(matcher, cap, "udp")
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    check(np.array_equal(got, counts) and cw.LAUNCHES["window_count_totals"] == tiles,
          f"split pass: counts equal {np.array_equal(got, counts)}, launches {dict(cw.LAUNCHES)}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith("msm")]
    n, total, own = {}, {}, {}
    for i, (name, a, b) in enumerate(ranges):
        covered, end = 0.0, a
        for c, d in sorted((c, d) for j, (_, c, d) in enumerate(ranges)
                           if j != i and a <= c and d <= b):
            covered += max(0.0, d - max(c, end))
            end = max(end, d)
        n[name] = n.get(name, 0) + 1
        total[name] = total.get(name, 0.0) + (b - a) / 1e6
        own[name] = own.get(name, 0.0) + (b - a - covered) / 1e6
    check(n.get("msm.stage.dispatch") == tiles,
          f"split pass: {n.get('msm.stage.dispatch')} msm.stage.dispatch spans, {tiles} tiles")
    dev_ms = {cat: sum(float(e["dur"]) for e in events if e.get("cat") == cat) / 1e3
              for cat in ("gpu_memcpy", "kernel")}
    print(f"one streamed pass, profiled: {wall:.4f} s wall; by range (count, seconds, self "
          f"seconds): " + ", ".join(f"{k} {n[k]} {total[k]:.4f} {own[k]:.4f}" for k in sorted(
              own, key=lambda k: -own[k])) + f"; self sum {sum(own.values()):.4f} s; device: "
          f"copies {dev_ms['gpu_memcpy']:.4f} ms, kernels {dev_ms['kernel']:.4f} ms over {tiles} "
          f"tiles [{card}]")
    return own


def stream_phase(dev, card: str, cw, ct, matcher, patterns, pat_file, cap, counts, big, rules,
                 cap2, big_counts) -> dict:
    """Phase 9, the streamed packet path; returns the launches of one
    streamed pass by kernel name (for the kernel records)."""
    import torch

    from multithreading_string_matching_tpu_torch import cli
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.ops.bucketing import pack_rows
    from multithreading_string_matching_tpu_torch.parallel import pipeline as pp

    t_phase = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    rows, width = STREAM_TILE

    def drive(label, fn, want, expect) -> float:
        """One run with the launch counters reset just before: its counts
        must equal ``want`` and its launches ``expect`` (no other kernel);
        returns its wall seconds."""
        torch.cuda.synchronize()
        reset_launches(cw, ct)
        t0 = time.perf_counter()
        got = fn()
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in {**cw.LAUNCHES, **ct.LAUNCHES}.items() if v}
        check(np.array_equal(np.asarray(got), want), f"{label}: counts differ")
        check(launched == expect, f"{label}: launches {launched}, expected {expect}")
        return wall

    def host_pass(path, n_workers: int):
        """``(payload bytes / s, packed rows)`` of the streamed path's host
        stages alone (ingest, extract, pack; bench.py:291-318)."""
        n_bytes = packed = 0
        t0 = time.perf_counter()
        for _c, b in pp._iter_extracted(path, "udp", STREAM_BATCH, False, False, False,
                                        n_workers):
            n_bytes += b.total_payload_bytes
            lens = b.lengths.astype(np.int64)
            rows_c, fill = pack_rows(b.payloads, np.where(lens > width, 0, lens), width=width)
            packed += rows_c.shape[0] if fill.any() else 0
        return n_bytes / (time.perf_counter() - t0), packed

    host_bps = {}
    for w in (0, workers):
        runs = [host_pass(cap, w) for _ in range(3)]
        host_bps[w], packed = max(r[0] for r in runs), runs[0][1]
    tiles, small_tiles = -(-packed // rows), -(-packed // 64)
    print(f"host stages alone (ingest + extract + pack, best of 3): host_workers=0 "
          f"{host_bps[0]:.6e} B/s, host_workers={workers} {host_bps[workers]:.6e} B/s; "
          f"{packed} packed rows = {tiles} tiles of {rows} x {width} [{card}]")

    # The stand-in capture: async and sync schedules, host workers, a forced
    # drain, small tiles.
    std = {"window_count_totals": tiles}
    stats = {}
    pp.count_pcap_streamed(matcher, cap, "udp")  # warm
    walls = {}
    for label, kw in (("async", {}), ("sync", {"sync_dispatch": True})):
        walls[label] = [drive(f"streamed {label}", lambda: pp.count_pcap_streamed(
            matcher, cap, "udp", stats=stats, **kw), counts, std) for _ in range(STREAM_RUNS)]
    nbytes = stats["payload_bytes"]
    e2e = {k: nbytes / statistics.median(v) for k, v in walls.items()}
    print(f"streamed count_pcap_streamed, {nbytes} payload bytes, {tiles} tiles: async median "
          f"{statistics.median(walls['async']):.4f} s = {e2e['async']:.6e} B/s "
          f"({', '.join(f'{s:.4f}' for s in walls['async'])}); sync median "
          f"{statistics.median(walls['sync']):.4f} s = {e2e['sync']:.6e} B/s "
          f"({', '.join(f'{s:.4f}' for s in walls['sync'])}); async/sync ratio "
          f"{e2e['async'] / e2e['sync']:.4f} [{card}]")
    for w in (0, workers):
        s = drive(f"host_workers={w}", lambda: pp.count_pcap_streamed(
            matcher, cap, "udp", host_workers=w), counts, std)
        print(f"streamed, host_workers={w}: {s:.4f} s = {nbytes / s:.6e} B/s [{card}]")
    s = drive("tile_rows=64", lambda: pp.count_pcap_streamed(matcher, cap, "udp", tile_rows=64),
              counts, {"window_count_totals": small_tiles})
    print(f"streamed, tile_rows=64: {small_tiles} tiles through 3 slots, {s:.4f} s [{card}]")
    drains = []
    real_drain, real_positions = pp.PackedTileCounter._drain, pp.DRAIN_POSITIONS

    def counted_drain(self):
        drains.append(self._total is not None)
        real_drain(self)

    pp.PackedTileCounter._drain, pp.DRAIN_POSITIONS = counted_drain, rows * width
    try:
        drive("forced drain", lambda: pp.count_pcap_streamed(matcher, cap, "udp"), counts, std)
    finally:
        pp.PackedTileCounter._drain, pp.DRAIN_POSITIONS = real_drain, real_positions
    check(sum(drains) == tiles, f"forced drain: {sum(drains)} drains of {tiles} tiles")
    print(f"forced drain after every tile: {sum(drains)} drains, counts equal")

    split_pass(card, cw, matcher, cap, counts, tiles)

    # The task pipeline: one window_count_totals launch per 100-packet batch.
    batches = -(-MAIN_PACKETS // TASK_BATCH)
    s = drive("count_pcap_pipelined", lambda: pp.count_pcap_pipelined(matcher, cap, "udp"),
              counts, {"window_count_totals": batches})
    print(f"count_pcap_pipelined (batch {TASK_BATCH}): {s:.4f} s = {nbytes / s:.6e} B/s, "
          f"{batches} launches [{card}]")

    # The 3,072 rules: filter kernels (8 class launches a tile), the table
    # kernels with MSM_PALLAS_FILTER=0, and the pattern axis on one card.
    packed2 = host_pass(cap2, 0)[1]
    tiles2 = -(-packed2 // rows)
    n_cls = len(big.kernels.classes)
    launches = {"window_count_totals": tiles, "filter_count_totals": n_cls * tiles2,
                "shard_filter_count_totals": tiles2}
    s = drive("3,072 rules streamed", lambda: pp.count_pcap_streamed(big, cap2, "udp"), big_counts,
              {"filter_count_totals": launches["filter_count_totals"]})
    print(f"3,072 rules streamed: {s:.4f} s, {tiles2} tiles x {n_cls} classes [{card}]")
    s = drive("3,072 rules pattern-sharded stream", lambda: pp.count_pcap_streamed(
        big, cap2, "udp", sharded=True, shard_axis="patterns"), big_counts,
        {"shard_filter_count_totals": tiles2})
    print(f"3,072 rules streamed, --shard-axis patterns (one shard): {s:.4f} s [{card}]")

    # NUL sets: the per-row fallback (rows kernels, one launch per chunk and
    # class), held against their one-shot counts.
    chunks = -(-MAIN_PACKETS // STREAM_BATCH)
    nul = Matcher(patterns + [b"\x00\x00"], device=dev)
    want = nul.count_pcap(cap, "udp")
    check(np.array_equal(want[:-1], counts) and want[-1] > 0, "NUL set one-shot")
    route_walls = {"stand-in + NUL": drive("NUL set streamed", lambda: pp.count_pcap_streamed(
        nul, cap, "udp"), want, {"window_count_rows": chunks})}
    launches["window_count_rows"] = chunks
    big_nul = Matcher(rules + [b"\x00\x00"], device=dev)
    want2 = big_nul.count_pcap(cap2, "udp")
    check(np.array_equal(want2[:-1], big_counts) and want2[-1] > 0, "NUL rule set one-shot")
    n_cls_nul = len(big_nul.kernels.classes)
    launches["filter_count_rows"] = n_cls_nul * chunks
    route_walls["3,072 rules + NUL"] = drive(
        "NUL rule set streamed", lambda: pp.count_pcap_streamed(big_nul, cap2, "udp"), want2,
        {"filter_count_rows": launches["filter_count_rows"]})
    os.environ["MSM_PALLAS_FILTER"] = "0"
    try:
        tab = Matcher(rules, device=dev)
        launches["table_count_totals"] = len(tab.kernels.classes) * tiles2
        route_walls["3,072 rules, table kernels"] = drive(
            "3,072 rules streamed, table kernels", lambda: pp.count_pcap_streamed(tab, cap2, "udp"),
            big_counts, {"table_count_totals": launches["table_count_totals"]})
        tab_nul = Matcher(rules + [b"\x00\x00"], device=dev)
        launches["table_count_rows"] = len(tab_nul.kernels.classes) * chunks
        route_walls["3,072 rules + NUL, table kernels"] = drive(
            "NUL rule set streamed, table kernels", lambda: pp.count_pcap_streamed(
                tab_nul, cap2, "udp"), want2, {"table_count_rows": launches["table_count_rows"]})
    finally:
        del os.environ["MSM_PALLAS_FILTER"]
    print(f"NUL sets streamed = their one-shot counts: stand-in + NUL {chunks} rows launches, "
          f"3,072 rules + NUL {launches['filter_count_rows']} ({n_cls_nul} classes x {chunks} "
          f"chunks); walls " + ", ".join(f"{k} {v:.4f} s" for k, v in route_walls.items())
          + f" [{card}]")

    # The commands, held against serial's counts (phase 4 checked serial).
    want_rep = nonzero(patterns, counts)
    for name in ("data", "task"):
        torch.cuda.synchronize()
        reset_launches(cw, ct)
        rep, rc, s = report_of(cli, [name, cap, pat_file, "4", "udp"])
        check(rc == 0 and rep == want_rep, f"{name} 4 udp differs from serial")
        launched = {k: v for k, v in {**cw.LAUNCHES, **ct.LAUNCHES}.items() if v}
        if name == "task":
            check(launched == {"window_count_totals": batches}, f"task launches {launched}")
        print(f"{name} <cap> <strings> 4 udp: {s:.4f} s wall, launches {launched} [{card}]")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["match", "--pcap", str(cap), "--patterns", str(pat_file), "--stream",
                       "--host-workers", str(workers), "--json"])
    blob = json.loads(out.getvalue().splitlines()[-1])
    check(rc == 0 and blob["counts"] == counts.tolist()
          and blob["execution"]["engine_resolved"] == "pallas", "match --stream --json")
    print(f"match --stream --host-workers {workers} --json: serial's counts, phases "
          f"{blob['phases']} [{card}]")
    print(f"phase 9: {time.perf_counter() - t_phase:.3f} s")
    return launches


WALL_ROUNDS = 3


def cli_json(cli, argv):
    """``(blob, wall seconds)`` of one ``--json`` command run in process."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    wall = time.perf_counter() - t0
    check(rc == 0, f"{' '.join(map(str, argv))} exited {rc}: {err.getvalue()[-2000:]}")
    return json.loads(out.getvalue().splitlines()[-1]), wall


def check_triples(label, rows, wp, counts, payloads, lengths, row_ids) -> None:
    """Hold ``(id, start, unique pattern)`` triples exact without the plain
    version: their bincount (through ``dup_map``) equals ``counts``, no
    triple repeats, and every triple's bytes, read on the host from its
    row (``row_ids[r]`` is row r's id), equal its pattern and fit the row's
    length."""
    rows = np.asarray(rows, np.int64).reshape(-1, 3)
    U = len(wp.unique_patterns)
    check(np.array_equal(np.bincount(rows[:, 2], minlength=U)[wp.dup_map], np.asarray(counts)),
          f"{label}: the triples' bincount differs from the counts")
    check(np.unique(rows, axis=0).shape[0] == len(rows), f"{label}: a triple repeats")
    r = np.minimum(np.searchsorted(row_ids, rows[:, 0]), len(row_ids) - 1)
    check(np.array_equal(row_ids[r], rows[:, 0]), f"{label}: a triple names a row without bytes")
    m = np.array([len(q) for q in wp.unique_patterns], np.int64)[rows[:, 2]]
    check(bool(((rows[:, 1] >= 0) & (rows[:, 1] + m <= lengths[r])).all()),
          f"{label}: a triple runs past its payload")
    for ln in np.unique(m):
        sel = m == ln
        got = payloads[r[sel][:, None], rows[sel, 1][:, None] + np.arange(ln)[None, :]]
        want = np.frombuffer(b"".join(wp.unique_patterns[u] for u in rows[sel, 2]),
                             np.uint8).reshape(-1, ln)
        check(np.array_equal(got, want), f"{label}: a triple's bytes differ from its pattern")
    print(f"{label}: {len(rows)} triples, unique, bincount = counts, every triple's bytes = "
          "its pattern (host check)")


def find_traps():
    """(name, patterns, payloads, lengths) of ``window_find``'s traps, each
    over many of the kernel's 16,384-position tiles (its 3-stage ring turns)."""
    rng = np.random.default_rng(SEED + 12)
    nul = [b"\x00", b"A\x00", b"\x00\x00", b"AA\x00\x00", b"A\x00\x00\x00\x00"]
    dense = np.full((700, 131), ord("A"), np.uint8)
    dense[::3, 100:] = 0
    L = 45
    edge = rng.integers(ord("a"), ord("f"), size=(3000, L)).astype(np.uint8)
    for r in range(2999):
        k = 1 + r % 3
        edge[r, L - k:] = np.frombuffer(b"wxyz"[:k], np.uint8)
        edge[r + 1, : 4 - k] = np.frombuffer(b"wxyz"[k:], np.uint8)
    edge[::97, 10:14] = np.frombuffer(b"wxyz", np.uint8)
    past = rng.choice(np.frombuffer(b"A\x00", np.uint8), size=(4000, 37)).astype(np.uint8)
    past[:, 0] = ord("A")
    zero = rng.choice(np.frombuffer(b"ab\x00", np.uint8), size=(2500, 77)).astype(np.uint8)
    zlens = rng.integers(0, 78, 2500).astype(np.int32)
    zlens[::2] = 0
    zlens[1::10] = -5
    narrow = rng.choice(np.frombuffer(b"ab\x00", np.uint8), size=(20000, 5)).astype(np.uint8)
    chunked = rng.choice(np.frombuffer(b"c0123456789", np.uint8), size=(300, 300)).astype(np.uint8)
    for r in range(300):
        chunked[r, r % 290 : r % 290 + 6] = np.frombuffer(b"c%05d" % (r * 29 % 9000), np.uint8)
    return [
        ("dense A, A/AA/AAA + NUL tails", [b"A", b"AA", b"AAA"] + nul, dense,
         rng.integers(0, 140, 700).astype(np.int32)),
        ("a pattern across every row boundary", [b"wxyz", b"vwxyz1", b"z1", b"yz"], edge,
         np.full(3000, L, np.int32)),
        ("lengths past the width, NUL tails", nul, past,
         rng.integers(35, 46, 4000).astype(np.int32)),
        ("rows of length 0 and below", [b"ab", b"\x00", b"b\x00a", b"abab"], zero, zlens),
        ("rows of 5 bytes", [b"a", b"ab", b"\x00", b"a\x00", b"ba", b"\x00\x00a"], narrow,
         rng.integers(-1, 9, 20000).astype(np.int32)),
        ("9,004 patterns, three chunks at one start",
         [b"c%05d" % i for i in range(9000)] + [b"c", b"c0", b"c00", b"c000"], chunked,
         rng.integers(0, 301, 300).astype(np.int32)),
    ]


def find_checks(dev, compare, cw) -> None:
    """Phase 2's ``window_find`` checks: each trap equals the plain version,
    also with a first capacity of 1 row (one counted rerun) and in row
    slices whose bases are not 16-byte aligned."""
    import torch

    from multithreading_string_matching_tpu_torch.ops.window import WindowProgram, window_find_plain

    for name, pats, payloads, lengths in find_traps():
        words, masks, lens = WindowProgram.build(pats).tables(dev)
        p, ln = torch.from_numpy(payloads).to(dev), torch.from_numpy(lengths).to(dev)
        want = window_find_plain(words, masks, lens, p, ln)
        compare("window_find", cw.window_find(p, ln, words, masks, lens), want, name)
        reruns = cw.LAUNCHES["window_find_rerun"]
        compare("window_find", cw.window_find(p, ln, words, masks, lens, cap=1), want,
                f"{name}, first capacity 1")
        check(cw.LAUNCHES["window_find_rerun"] == reruns + 1 and len(want) > 1,
              f"window_find {name}: a capacity of 1 did not rerun once")
        for s0 in (1, 3, 7):
            s1 = s0 + payloads.shape[0] // 2
            compare("window_find", cw.window_find(p[s0:s1], ln[s0:s1], words, masks, lens),
                    window_find_plain(words, masks, lens, p[s0:s1], ln[s0:s1]),
                    f"{name}, rows {s0}:{s1} (base {p[s0:s1].data_ptr() % 16} mod 16)")
        print(f"window_find check {name}: n={payloads.shape[0]} L={payloads.shape[1]} "
              f"({-(-payloads.size // 16384)} tiles), {len(want)} triples: equal, with a rerun "
              "from capacity 1 and in unaligned row slices")


def attribution_phase(dev, card: str, cw, ct, matcher, pat_file, cap, batch, counts, big,
                      rules_file, cap2, batch2, big_counts, flow_cap, flow_counts) -> dict:
    """Phase 10, match attribution at full width; returns the kernel record
    of ``window_find``."""
    import torch

    from multithreading_string_matching_tpu_torch import cli
    from multithreading_string_matching_tpu_torch.io.flows import extract_flows, key_tuple_bytes
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
    from multithreading_string_matching_tpu_torch.ops.window import window_find_plain
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher

    t_phase = time.perf_counter()
    max_err = 0

    def head_vs_plain(label, m, b, rows):
        """The first ROWS_PER_PACKET_RUN rows: window_find equals the plain
        version on the card, and so do the command's triples of those rows."""
        nonlocal max_err
        kern = m.halo_kernels
        tabs = (kern.words, kern.masks, kern.lens)
        hp = torch.from_numpy(b.payloads[:ROWS_PER_PACKET_RUN]).to(dev)
        hl = torch.from_numpy(b.lengths[:ROWS_PER_PACKET_RUN]).to(dev)
        got = cw.window_find(hp, hl, *tabs)
        want, plain_once = timed_once(lambda: window_find_plain(*tabs, hp, hl))
        check(got.shape == want.shape, f"window_find {label}: {tuple(got.shape)} triples, plain "
              f"{tuple(want.shape)}")
        err = int((got - want).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        check(err == 0, f"window_find disagrees with the plain version on {label}")
        valid = np.flatnonzero(b.valid)
        head = rows[rows[:, 0] <= valid[min(ROWS_PER_PACKET_RUN, len(valid)) - 1]].copy()
        head[:, 0] = np.searchsorted(valid, head[:, 0])
        check(np.array_equal(head, want.cpu().numpy()),
              f"{label}: match --offsets differs from the plain version on the first rows")
        print(f"window_find {label}, first {hp.shape[0]} rows: {len(want)} triples = plain "
              f"version ({plain_once:.4f} ms once) and = the command's")
        return hp, hl, tabs

    # -- the main path: match --offsets on phase 3's capture --------------
    base = ["match", "--pcap", cap, "--patterns", pat_file, "--json"]
    valid = np.flatnonzero(batch.valid)
    torch.cuda.synchronize()
    reset_launches(cw, ct)
    blob, off_s = cli_json(cli, base + ["--offsets"])
    launches = {k: v for k, v in {**cw.LAUNCHES, **ct.LAUNCHES}.items() if v}
    print(f"match --offsets --json (stand-in): {off_s:.4f} s wall, launches {launches}, "
          f"{len(blob['offsets'])} triples [{card}]")
    check(set(launches) <= {"window_find", "window_find_rerun"}
          and launches.get("window_find", 0) >= 1
          and launches.get("window_find_rerun", 0) <= launches["window_find"],
          f"match --offsets launched {launches}: one window_find a row slice (and at most "
          "one rerun each), no window_count_totals")
    check(blob["counts"] == counts.tolist(), "match --offsets counts differ from phase 3's")
    rows = np.asarray(blob["offsets"], np.int64).reshape(-1, 3)
    check(len(rows) > 1000, f"only {len(rows)} triples")
    check_triples("stand-in match --offsets", rows, matcher.window, counts, batch.payloads,
                  batch.lengths, valid)
    hp, hl, tabs = head_vs_plain("stand-in", matcher, batch, rows)

    # -- times of window_find ---------------------------------------------
    fp = torch.from_numpy(batch.payloads).to(dev)
    fl = torch.from_numpy(batch.lengths).to(dev)
    full = cw.window_find(fp, fl, *tabs)
    mapped = rows.copy()
    mapped[:, 0] = np.searchsorted(valid, rows[:, 0])
    check(np.array_equal(full.cpu().numpy(), mapped), "window_find on the staged batch differs "
          "from match --offsets")
    M = int(full.shape[0])
    find_ms = cuda_ms(lambda: cw.window_find(fp, fl, *tabs), SCAN_RUNS)
    head_ms = cuda_ms(lambda: cw.window_find(hp, hl, *tabs), SCAN_RUNS)
    plain_ms = cuda_ms(lambda: window_find_plain(*tabs, hp, hl), PLAIN_RUNS)
    # Device time: the one launch through the C entry point (which clears
    # its flags first) queued alone, and the clear alone; the wrapper itself
    # waits for M.
    n, L = fp.shape
    U, K = tabs[0].shape
    size = ctypes.c_longlong()
    cw.FIND_LIBRARY.call("msm_window_find_scratch", n, L, ctypes.byref(size))
    out = torch.empty((M, 3), dtype=torch.int64, device=dev)
    scratch = torch.empty(size.value, dtype=torch.int64, device=dev)

    def launch():
        cw.FIND_LIBRARY.call("msm_window_find", fp.data_ptr(), fl.data_ptr(), tabs[0].data_ptr(),
                             tabs[1].data_ptr(), tabs[2].data_ptr(), out.data_ptr(), M,
                             scratch.data_ptr(), n, L, U, K, dev.index or 0,
                             torch.cuda.current_stream().cuda_stream)

    steps = {"launch with its flag clear": device_ms(launch),
             "flag clear alone": device_ms(scratch.zero_)}
    launch()
    check(int(scratch[1]) == M and torch.equal(out, full), "the launch alone differs")
    find_dev = steps["launch with its flag clear"]
    nbytes = batch.total_payload_bytes
    bnd = window_bound(matcher.window, position_words([(fp, fl)]), nbytes, 6 * M,
                       label="window_find (one pass)")
    print(f"window_find, stand-in batch {tuple(fp.shape)} ({nbytes} payload bytes, {M} "
          f"triples, {size.value - 2} tiles): {find_ms:.4f} ms (median of {SCAN_RUNS}; one "
          f"launch, one host sync) = {nbytes / find_ms * 1e3:.6e} payload B/s; device "
          + ", ".join(f"{k} {fmt_ms(v)}" for k, v in steps.items())
          + f"; first {hp.shape[0]} rows: kernel {head_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of {PLAIN_RUNS}); bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}), share of ms {bnd['bound_ms'] / find_ms:.4f}, of device ms "
          + (f"{bnd['bound_ms'] / find_dev:.4f}" if find_dev else "not measured") + f" [{card}]")
    del fp, fl, full

    # -- --dump-matches, --stream, and the walls ----------------------------
    dump = pathlib.Path(tempfile.gettempdir()) / f"msm_torch_dump_{os.getpid()}.pcap"
    dump2 = dump.with_suffix(".stream.pcap")
    hit_packets = np.unique(rows[:, 0])
    variants = {"match": [], "match --offsets": ["--offsets"],
                "match --dump-matches": ["--dump-matches", dump], "match --stream": ["--stream"],
                "match --stream --offsets": ["--stream", "--offsets"]}
    walls = {k: [] for k in variants}
    for _ in range(WALL_ROUNDS):
        for k, flags in variants.items():
            b, s = cli_json(cli, base + flags)
            check(b["counts"] == counts.tolist(), f"{k} counts differ from phase 3's")
            if "--offsets" in flags:
                check(b["offsets"] == blob["offsets"], f"{k} triples differ from match --offsets")
            if "--dump-matches" in flags:
                check(b["dumped_packets"] == len(hit_packets),
                      f"{k} dumped {b['dumped_packets']} packets, {len(hit_packets)} hit")
            walls[k].append(s)
    print("walls, stand-in capture (median of " + f"{WALL_ROUNDS}, in turns): " + ", ".join(
        f"{k} {statistics.median(v):.4f} s ({', '.join(f'{x:.4f}' for x in v)})"
        for k, v in walls.items()) + f" [{card}]")
    dumped = read_pcap(dump)
    check(dumped.num_packets == len(hit_packets), "the dump does not hold the hit packets")
    check(np.array_equal(matcher.count_pcap(dump, "udp"), counts),
          "the dump's re-count differs from phase 3's counts")
    reset_launches(cw, ct)
    b, s = cli_json(cli, base + ["--stream", "--offsets", "--dump-matches", dump2])
    st_launches = {k: v for k, v in {**cw.LAUNCHES, **ct.LAUNCHES}.items() if v}
    check(b["counts"] == counts.tolist() and b["offsets"] == blob["offsets"]
          and b["dumped_packets"] == len(hit_packets), "match --stream --offsets --dump-matches")
    check(dump2.read_bytes() == dump.read_bytes(), "the streamed dump differs from the one-shot")
    check(st_launches.get("window_find", 0) > 0 and st_launches.get("window_count_rows", 0) > 0,
          f"match --stream --offsets launched {st_launches}")
    print(f"--dump-matches: {dumped.num_packets} packets = the hit packets; re-counted = phase "
          f"3's counts; match --stream --offsets --dump-matches ({s:.4f} s, launches "
          f"{st_launches}) = one-shot triples and dump bytes [{card}]")
    dump.unlink()
    dump2.unlink()

    # -- the 3,072 rules -------------------------------------------------------
    reset_launches(cw, ct)
    blob2, s = cli_json(cli, ["match", "--pcap", cap2, "--patterns", rules_file, "--json",
                              "--offsets"])
    launches2 = {k: v for k, v in {**cw.LAUNCHES, **ct.LAUNCHES}.items() if v}
    check(set(launches2) <= {"window_find", "window_find_rerun"} and launches2.get("window_find"),
          f"match --offsets (3,072 rules) launched {launches2}")
    check(blob2["counts"] == big_counts.tolist(), "3,072-rule triples' counts differ from phase 5")
    rows2 = np.asarray(blob2["offsets"], np.int64).reshape(-1, 3)
    print(f"match --offsets --json (3,072 rules): {s:.4f} s wall, launches {launches2} [{card}]")
    check_triples("3,072 rules match --offsets", rows2, big.window, big_counts, batch2.payloads,
                  batch2.lengths, np.flatnonzero(batch2.valid))
    head_vs_plain("3,072 rules", big, batch2, rows2)

    # -- flows ------------------------------------------------------------------
    fb = extract_flows(read_pcap(flow_cap), "tcp")
    fbase = ["match", "--pcap", flow_cap, "--patterns", pat_file, "--mode", "tcp", "--flows",
             "--json", "--offsets"]
    reset_launches(cw, ct)
    one, s1 = cli_json(cli, fbase)
    fl1 = {k: v for k, v in cw.LAUNCHES.items() if v}
    reset_launches(cw, ct)
    st, s2 = cli_json(cli, fbase + ["--stream"])
    fl2 = {k: v for k, v in cw.LAUNCHES.items() if v}
    check(one["counts"] == st["counts"] == flow_counts.tolist(),
          "--flows [--stream] --offsets counts differ from phase 6's")
    frows = np.asarray([r[:3] for r in one["offsets"]], np.int64).reshape(-1, 3)
    check_triples("flows match --flows --offsets", frows, matcher.window, flow_counts,
                  fb.payloads, fb.lengths, np.arange(fb.num_flows))
    keyed = sorted((tuple(one["flow_keys"][f]), o, u) for f, o, u, _ in one["offsets"])
    check(sorted((tuple(r[:4]), r[4], r[5]) for r in st["offsets"]) == keyed,
          "--flows --stream --offsets triples differ from --flows --offsets")
    check(fl1.get("window_find", 0) > 0 and fl2.get("window_find", 0) > 0
          and fl2.get("window_count_halo", 0) > 0, f"flow launches {fl1}, {fl2}")
    print(f"match --flows --offsets ({s1:.4f} s, launches {fl1}) and --flows --stream --offsets "
          f"({s2:.4f} s, launches {fl2}): the same {len(keyed)} triples, phase 6's counts "
          f"[{card}]")
    # Where --flows --stream --offsets spends more than the counts-only
    # stream: the per-round find pass (its find_matches calls inside it,
    # synchronised) and the CLI's rendering of the triples.
    pcap = read_pcap(flow_cap)
    slices = [slice_pcap(pcap, i, i + FLOW_SLICE, copy=False)
              for i in range(0, pcap.num_packets, FLOW_SLICE)]
    split = {"find pass": 0.0, "find_matches": 0.0}

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return out
        return wrapper

    walls = {}
    for collect in (False, True, False, True):
        fs = FlowStreamMatcher(matcher, "tcp", engine="window", collect_offsets=collect)
        if collect:
            split.update({"find pass": 0.0, "find_matches": 0.0})
            fs._collect_round_offsets = timed("find pass", fs._collect_round_offsets)
            fs.matcher = copy.copy(matcher)
            fs.matcher.find_matches = timed("find_matches", matcher.find_matches)
        t0 = time.perf_counter()
        for sl in slices:
            fs.feed_pcap_slice(sl)
        fs.flush()
        got_counts, drained = fs.counts(), fs.drain_offsets()
        walls.setdefault(collect, []).append(time.perf_counter() - t0)
        check(np.array_equal(got_counts, flow_counts) and len(drained) == len(keyed) * collect,
              "the timed flow streams differ")
    render_s = {}
    for label, name in (("a key a triple", key_tuple_bytes),
                        ("a key a flow (the CLI's)",
                         functools.lru_cache(maxsize=1 << 16)(key_tuple_bytes))):
        t0 = time.perf_counter()
        rendered = [[*name(k), int(o), int(u)] for k, o, u in drained]
        render_s[label] = time.perf_counter() - t0
        check(len(rendered) == len(keyed), "rendered triples")
    print(f"flow stream, {len(slices)} slices (in turns): counts only "
          f"{', '.join(f'{w:.4f}' for w in walls[False])} s, collect_offsets "
          f"{', '.join(f'{w:.4f}' for w in walls[True])} s; last offsets run: find pass "
          f"{split['find pass']:.4f} s, of which find_matches {split['find_matches']:.4f} s; "
          f"rendering {len(drained)} triples' keys: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in render_s.items()) + f" [{card}]")
    print(f"phase 10: {time.perf_counter() - t_phase:.3f} s")
    return {"name": "window_find", "route": "cuda",
            "source": "multithreading_string_matching_tpu_torch/csrc/window_find.cu",
            "replaces": "multithreading_string_matching_tpu/ops/window.py:217",
            "replaces_note": "no pl.pallas_call: the XLA bitmap _window_bitmap_group and the "
                             "host np.nonzero of find_matches (:230)",
            "launches": launches["window_find"],
            "reruns": launches.get("window_find_rerun", 0), "max_abs_err": max_err, "ms": find_ms,
            "device_ms": find_dev, "device_steps_ms": steps, "plain_ms": plain_ms,
            "plain_covers": f"first {ROWS_PER_PACKET_RUN} rows", "ms_plain_rows": head_ms,
            "library_ms": None, "matches": M, **bnd, "bound_share": bnd["bound_ms"] / find_ms,
            "bound_share_device": bnd["bound_ms"] / find_dev if find_dev else None}

# -- the DFA scans (phases 2 and 11) -------------------------------------------

# Integer operations the bounds count: ac_scan, per scanned byte, the table
# index (shift, or), the mask that drops the emit bit and its test (the
# segments' warm-up bytes are the kernel's own cost, not the function's);
# kmp_scan, per byte and pattern, the index and the accept compare-and-add.  Loads are
# not operations; the table's bytes are counted once, as an input.
AC_OPS_PER_BYTE = 4
KMP_OPS_PER_BYTE = 3
SCAN_SRC = "multithreading_string_matching_tpu_torch/csrc/scan.cu"
SCAN_REF = "multithreading_string_matching_tpu/ops/scan.py"
DUPS = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"abcdefgh", b"abcde"]
NULS = [b"a\x00b", b"\x00\x00", b"ab", b"\x00", b"b\x00"]


BOUNDARY = [b"abcdefghij", b"hij", b"cdefg", b"a", b"jab", b"defghijabc", b"ab" * 20]


def boundary_scan_tile(rng, L: int, seg: int):
    """Rows that plant the 40-byte and 10-byte patterns of ``BOUNDARY`` across
    every ``seg``-byte segment boundary, at offsets -D .. +D from it (D = 40,
    the automaton's depth), and lengths -8 .. L + 8."""
    letters = np.frombuffer(b"abcdefghij", np.uint8)
    n = 2 * 40 + 1
    p = letters[rng.integers(0, len(letters), size=(n, L))]
    for r in range(n):
        for b in range(seg, L, seg):
            for pat, start in ((BOUNDARY[-1], b - 40 + r), (BOUNDARY[0], b - 10 + r % 21)):
                if 0 <= start and start + len(pat) <= L:
                    p[r, start:start + len(pat)] = np.frombuffer(pat, np.uint8)
    return p, rng.integers(-8, L + 9, size=n).astype(np.int32)


def scan_cases(rng, patterns):
    """(name, patterns, payload, lengths, force_int32, segment sizes): rows
    not zero past their lengths, lengths from -8 to 8 past the width.  The
    segment sizes are those ``ac_scan`` runs the case at besides its own
    (None): small ones put warm-ups across every boundary and make patterns
    longer than a segment."""
    long_states = [bytes(rng.integers(97, 123, size=256).tolist()) for _ in range(300)]
    mid = rule_set(SEED + 7, 400, lo=8, hi=24)
    out = []
    for name, pats, n, L, alphabet, force, segs in (
        ("dups", DUPS, 64, 200, b"abc\x00", False, (16, 23)),
        ("nul", NULS, 48, 61, b"ab\x00", False, (16,)),
        ("unaligned-width-13", DUPS, 33, 13, b"abc", False, (5,)),
        ("standin-uint16-shared", patterns, 1024, 1280, ALNUM + b" /:.", False, (16, 48)),
        ("uint16-device-memory", mid, 256, 600, ALNUM, False, (32,)),
        ("int32-shared", DUPS, 64, 300, b"abc", True, (16,)),
        ("int32-65536-plus-states", long_states, 64, 600, b"abcdefghijklmnopqrstuvwxyz", False,
         (64,)),
        ("many-lanes", DUPS, 20000, 40, b"abc", False, (16,)),
        ("99-byte", [b"ab" * 49 + b"c", b"abab", b"c", b"abab"], 40, 400, b"abc", False, (32,)),
        ("kmp-int32-300-byte", [b"x" * 300, b"xy", b"y"], 24, 700, b"xy", False, (64,)),
    ):
        p, ln = planted_tile(rng, pats, n, L, alphabet)
        ln = (ln.astype(np.int64) + rng.integers(-8, 9, size=n)).astype(np.int32)
        out.append((name, pats, p, ln, force, segs))
    for seg in (16, 64):
        p, ln = boundary_scan_tile(rng, 600, seg)
        out.append((f"segment-boundaries-{seg}", BOUNDARY, p, ln, False, (seg,)))
    return out


def scan_checks(dev, compare, sc) -> None:
    """Phase 2's DFA part: ac_scan (totals, rows, final states; from the root
    and from carried in-table states with dead lanes, at its own segment
    size and at small ones) and kmp_scan (totals, rows; at the fewest
    pattern groups and at one pattern a group) against their plain versions
    on the same CUDA tensors, one tile and as a list of tiles in one launch;
    and the refusal of start states outside the table."""
    import torch

    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
    from multithreading_string_matching_tpu_torch.models.aho_corasick import AhoCorasick
    from multithreading_string_matching_tpu_torch.models.kmp import stack_kmp_dfas

    rng = np.random.default_rng(SEED + 8)
    patterns = load_patterns(pathlib.Path(__file__).resolve().parent / (
        "multithreading_string_matching_tpu_torch/data/strings_standin.txt"))
    for name, pats, payload, lengths, force, segs in scan_cases(rng, patterns):
        p = torch.from_numpy(payload).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        n = p.shape[0]
        t0 = time.perf_counter()
        ac = AhoCorasick.build(pats)
        saved = sc.UINT16_STATES
        if force:
            sc.UINT16_STATES = 4  # this small set's table as int32
        try:
            cac = sc.CompiledAC.from_automaton(ac, dev)
        finally:
            sc.UINT16_STATES = saved
        built = time.perf_counter() - t0
        # Carried states drawn from the table, the dead state among them (a
        # dead lane spans every segment of its row).
        states = rng.integers(0, cac.dead + 1, size=n).astype(np.int32)
        states[::5] = cac.dead
        found = 0
        for label, init in (("root", np.zeros(n, np.int32)), ("carried", states)):
            st = torch.from_numpy(init).to(dev)
            for per_packet in (False, True):
                want, want_st = sc.ac_scan_plain(cac, p, ln, st, per_packet=per_packet)
                found = max(found, int(want.sum()))
                for seg in (None, *segs):
                    got, got_st = sc.ac_scan(cac, p, ln, st, per_packet=per_packet,
                                             seg_bytes=seg)
                    what = f"{name} {label} per_packet={per_packet} segments={seg}"
                    compare("ac_scan", got, want, what)
                    compare("ac_scan", got_st, want_st, f"{what} states")
        check(found > 0, f"ac_scan case {name} counted nothing")
        check(cac.table.dtype == (torch.int32 if force or ac.goto.shape[0] > 65536
                                  else torch.int16), f"{name}: table {cac.table.dtype}")
        # A list of three tiles of other widths, in one launch.
        cut = [0, n // 3, n // 2, n]
        tiles = [(p[a:b, : max(1, p.shape[1] - 5 * k)].contiguous(), ln[a:b].contiguous())
                 for k, (a, b) in enumerate(zip(cut[:-1], cut[1:]))]
        tstates = [torch.from_numpy(states[a:b]).to(dev) for a, b in zip(cut[:-1], cut[1:])]
        for per_packet in (False, True):
            before = sc.LAUNCHES["ac_scan"]
            got, got_st = sc.ac_scan_tiles(cac, tiles, per_packet=per_packet, states=tstates)
            check(sc.LAUNCHES["ac_scan"] == before + 1, f"{name}: the tile list took "
                  f"{sc.LAUNCHES['ac_scan'] - before} launches")
            want = [sc.ac_scan_plain(cac, tp, tl, ts, per_packet=per_packet)
                    for (tp, tl), ts in zip(tiles, tstates)]
            compare("ac_scan", got, torch.cat([w[0] for w in want]) if per_packet
                    else sum(w[0] for w in want), f"{name} tile list per_packet={per_packet}")
            for g, w in zip(got_st, want):
                compare("ac_scan", g, w[1], f"{name} tile list states")
        # States outside the table: refused, nothing launched.
        for bad in (cac.num_states, cac.num_states + 7, -1, -5):
            wrong = states.copy()
            wrong[n // 2] = bad
            wst = torch.from_numpy(wrong).to(dev)
            before = sc.LAUNCHES["ac_scan"]
            for label, call in (
                ("ac_scan", lambda: sc.ac_scan(cac, p, ln, wst)),
                ("ac_scan_tiles", lambda: sc.ac_scan_tiles(cac, [(p, ln)], states=[wst])),
                ("count_matches_ac", lambda: sc.count_matches_ac(cac, p, ln, initial_states=wst)),
            ):
                try:
                    call()
                except ValueError:
                    pass
                else:
                    check(False, f"{name}: {label} took start state {bad}")
            check(sc.LAUNCHES["ac_scan"] == before, f"{name}: a refused state launched")
        dfas, accept = stack_kmp_dfas(pats)
        kmp = sc.CompiledKMP.from_numpy(dfas, accept, dev)
        want_rows = sc.kmp_scan_plain(kmp, p, ln, per_packet=True)
        want_tiles = torch.cat([sc.kmp_scan_plain(kmp, tp, tl, per_packet=True)
                                for tp, tl in tiles])
        saved = sc.KMP_FILL_LANES
        try:
            for fill in (1, 10**9):  # the fewest groups; one pattern a group
                sc.KMP_FILL_LANES = fill
                for per_packet in (False, True):
                    want = want_rows if per_packet else want_rows.sum(0, dtype=torch.int32)
                    compare("kmp_scan", sc.kmp_scan(kmp, p, ln, per_packet=per_packet), want,
                            f"{name} per_packet={per_packet} fill={fill}")
                    want = want_tiles if per_packet else want_tiles.sum(0, dtype=torch.int32)
                    compare("kmp_scan", sc.kmp_scan_tiles(kmp, tiles, per_packet=per_packet),
                            want, f"{name} tile list per_packet={per_packet} fill={fill}")
        finally:
            sc.KMP_FILL_LANES = saved
        table_bytes = cac.table.numel() * cac.table.element_size()
        groups = (sc.kmp_groups(kmp.accept_host[kmp.order_host], n)
                  if kmp.table.dtype == torch.uint8 else "one pattern a block")
        print(f"scan kernel check {name}: {ac.goto.shape[0]} states ({cac.table.dtype}, "
              f"{table_bytes} B table{', shared memory' if table_bytes <= 227 * 1024 else ''}, "
              f"emit bit in the table: {cac.kflag}, depth {cac.depth}, segments "
              f"{sc.ac_segment_bytes(cac.depth, payload.shape[1])} B and {segs}; built in "
              f"{built:.3f} s), KMP M={dfas.shape[1]} ({kmp.table.dtype}, groups/slots/smem "
              f"{groups}), n={n} L={payload.shape[1]}, totals {found}: ac_scan and kmp_scan "
              f"equal, one tile and a list of 3 in one launch; states outside the table refused")
    unreached_depth_check(dev, compare, sc, AhoCorasick)


def unreached_depth_check(dev, compare, sc, AhoCorasick) -> None:
    """The input ``tools/differential.py`` found (seed 1, case 22): an
    automaton of 37 patterns over two symbols with one more state that the
    root does not reach (``CompiledAC.depth`` None), carried start states
    (that state among them), 53-byte segments asked for, a [163 x 1009]
    tile.  A row must be one segment: segments started from the root
    without a warm-up counted 129 matches too few."""
    import torch

    rng = np.random.default_rng(SEED + 9)
    sym = np.array([0xB5, 0xE5], np.uint8)
    pats = [bytes(rng.choice(sym, size=int(rng.integers(1, 40)))) for _ in range(37)]
    ac = AhoCorasick.build(pats)
    S = ac.dead_state
    goto = np.empty((S + 2, 256), np.int32)
    goto[:S] = ac.goto[:S]
    goto[S] = rng.integers(0, S + 1, size=256)
    goto[S + 1] = S + 1
    emit = np.zeros((S + 2, ac.emit.shape[1]), np.int32)
    emit[:S] = ac.emit[:S]
    emit[S] = rng.random(ac.emit.shape[1]) < 0.5
    cac = sc.CompiledAC.from_numpy(goto, emit, ac.dup_map, device=dev)
    check(cac.depth is None, "the extra state leaves the table without a depth")
    p = torch.from_numpy(sym[rng.integers(0, 2, size=(163, 1009))]).to(dev)
    ln = torch.from_numpy(rng.integers(-8, 1017, size=163).astype(np.int32)).to(dev)
    states = rng.integers(0, cac.dead + 1, size=163).astype(np.int32)
    states[::7] = S
    st = torch.from_numpy(states).to(dev)
    for per_packet in (False, True):
        want, want_st = sc.ac_scan_plain(cac, p, ln, st, per_packet=per_packet)
        for seg in (None, 53, 16):
            got, got_st = sc.ac_scan(cac, p, ln, st, per_packet=per_packet, seg_bytes=seg)
            what = f"no depth, per_packet={per_packet} segments={seg}"
            compare("ac_scan", got, want, what)
            compare("ac_scan", got_st, want_st, f"{what} states")
    print(f"scan kernel check no-depth: {S + 2} states, one unreached, 53- and 16-byte "
          f"segments asked for, totals {int(want.sum())}: ac_scan equal")


def scan_bound(nbytes: int, row_bytes: int, table_bytes: int, out_ints: int, ops: float) -> dict:
    """Bytes: the real payload bytes, the table, ``row_bytes`` of lengths
    (and states in and out), the counts out; operations as
    ``AC_OPS_PER_BYTE`` / ``KMP_OPS_PER_BYTE`` say, at the int32 rate."""
    return bound(nbytes + table_bytes + row_bytes + 4 * out_ints, ops, int32_ops_per_s())


def dfa_phase(dev, card: str, sc, cw, ct, matcher, patterns, pat_file, cap, batch, counts,
              per_row, prep, rules, big, cap2, batch2, big_counts, big_rows, prep2, flow_cap,
              flow_counts, compare, max_err) -> list:
    """Phase 11, the DFA scans at full width; returns the kernel records of
    ``ac_scan`` and ``kmp_scan``."""
    import torch

    from multithreading_string_matching_tpu_torch import cli
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.flows import count_flows_chunked, extract_flows
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher
    from multithreading_string_matching_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    mods = (cw, ct, sc)

    def reset():
        torch.cuda.synchronize()
        reset_launches(*mods)

    def only(kname, label) -> int:
        got = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
        check(set(got) == {kname}, f"{label} launched {got}, not {kname} alone")
        return got[kname]

    n_head = ROWS_PER_PACKET_RUN
    head_p, head_l = batch.payloads[:n_head], batch.lengths[:n_head]
    hp, hl = torch.from_numpy(head_p).to(dev), torch.from_numpy(head_l).to(dev)
    hz = torch.zeros(n_head, dtype=torch.int32, device=dev)
    eng = {e: Matcher(patterns, engine=e, device=dev) for e in ("ac", "kmp")}
    t0 = time.perf_counter()
    cac, kmp = eng["ac"].cac, eng["kmp"].kmp
    print(f"stand-in tables: {cac.num_states} AC states ({cac.table.dtype}, "
          f"{cac.table.numel() * cac.table.element_size()} B), KMP {tuple(kmp.table.shape)} "
          f"({kmp.table.dtype}), built in {time.perf_counter() - t0:.3f} s")

    # -- 1. count_pcap, each engine; per packet on the first rows ---------------
    launches, plain_ms, plain_out = {}, {}, {}
    for e, m in eng.items():
        reset()
        t0 = time.perf_counter()
        c = m.count_pcap(cap, "udp")
        wall = time.perf_counter() - t0
        launches[f"{e}_scan"] = only(f"{e}_scan", f"count_pcap engine={e}")
        check(np.array_equal(c, counts), f"engine={e} count_pcap differs from phase 3's counts")
        check(launches[f"{e}_scan"] == 1, f"count_pcap engine={e} took "
              f"{launches[f'{e}_scan']} launches, not one over every bucket tile")
        reset()
        c = m.count_prepared(prep)
        n_res = only(f"{e}_scan", f"count_prepared engine={e}")
        check(np.array_equal(c, counts) and n_res == 1,
              f"count_prepared engine={e}: {n_res} launches over phase 3's {len(prep.tiles)} "
              f"resident tiles, counts equal: {np.array_equal(c, counts)}")
        reset()
        r = m.count(head_p, head_l, per_packet=True)
        check(only(f"{e}_scan", f"engine={e} per packet") == 1, f"engine={e} per packet: "
              "not one launch")
        check(np.array_equal(r, per_row), f"engine={e} per-packet rows differ from phase 3's")
        if e == "ac":
            got, _ = sc.ac_scan(cac, hp, hl, hz, per_packet=True)
            (want, _), plain_ms[e] = timed_once(
                lambda: sc.ac_scan_plain(cac, hp, hl, hz, per_packet=True))
            want = want[:, torch.from_numpy(m.ac.dup_map).to(dev).long()]
            got = got[:, torch.from_numpy(m.ac.dup_map).to(dev).long()]
        else:
            got = sc.kmp_scan(kmp, hp, hl, per_packet=True)
            want, plain_ms[e] = timed_once(lambda: sc.kmp_scan_plain(kmp, hp, hl, per_packet=True))
        compare(f"{e}_scan", got, want, "phase 3's first 8,192 rows")
        check(np.array_equal(want.cpu().numpy(), r), f"engine={e}: plain rows differ")
        for row in range(min(100, n_head)):
            text = head_p[row, : head_l[row]].tobytes()
            check(list(r[row]) == [overlapping(text, q) for q in patterns],
                  f"engine={e} row {row} differs from the pure-Python count")
        print(f"engine={e}: count_pcap {wall:.3f} s, {launches[f'{e}_scan']} {e}_scan launch = "
              f"phase 3's counts; count_prepared over the {len(prep.tiles)} resident tiles: 1 "
              f"launch = phase 3's counts; per packet on {n_head} rows (1 launch) = phase 3's "
              f"rows = plain on the card = pure Python (100 rows) [{card}]")

    # -- 2. carried states over phase 3's rows ----------------------------------
    m = eng["ac"]
    L = batch.payloads.shape[1]
    for width in (2048, 512):
        reset()
        states = m.streaming_state(batch.payloads.shape[0])
        total = np.zeros(len(patterns), np.int64)
        for c0 in range(0, L, width):
            cc, states = m.count_chunk(batch.payloads[:, c0:c0 + width], batch.lengths - c0,
                                       states)
            total += cc
        n_launch = only("ac_scan", f"count_chunk width {width}")
        check(np.array_equal(total, counts), f"count_chunk in {width}-byte chunks differs")
        print(f"count_chunk over phase 3's rows ({L} wide) in {width}-byte chunks: "
              f"{n_launch} launches = phase 3's counts")

    # -- 3. the 3,072 rules -----------------------------------------------------
    t0 = time.perf_counter()
    mb = Matcher(rules, engine="ac", device=dev)
    bcac = mb.cac
    b_build = time.perf_counter() - t0
    reset()
    t0 = time.perf_counter()
    c = mb.count_pcap(cap2, "udp")
    wall = time.perf_counter() - t0
    n_launch = only("ac_scan", "3,072 rules engine=ac")
    check(np.array_equal(c, big_counts), "engine=ac on the 3,072 rules differs from phase 5's")
    check(n_launch == 1, f"engine=ac on the 3,072 rules took {n_launch} launches, not one")
    reset()
    check(np.array_equal(mb.count_prepared(prep2), big_counts)
          and only("ac_scan", "3,072 rules count_prepared") == 1,
          "engine=ac count_prepared on phase 5's tiles: not phase 5's counts in one launch")
    head2_p, head2_l = batch2.payloads[:n_head], batch2.lengths[:n_head]
    reset()
    r = mb.count(head2_p, head2_l, per_packet=True)
    only("ac_scan", "3,072 rules engine=ac per packet")
    check(np.array_equal(r, big_rows), "engine=ac rows on the 3,072 rules differ from phase 5's")
    t0 = time.perf_counter()
    mk = Matcher(rules, engine="kmp", device=dev)
    bkmp = mk.kmp
    k_build = time.perf_counter() - t0
    reset()
    _, kmp_rules_ms = timed_once(lambda: mk.count(head2_p, head2_l, per_packet=True))
    r = mk.count(head2_p, head2_l, per_packet=True)
    only("kmp_scan", "3,072 rules engine=kmp per packet")
    check(np.array_equal(r, big_rows), "engine=kmp rows on the 3,072 rules differ from phase 5's")
    h2p, h2l = torch.from_numpy(head2_p).to(dev), torch.from_numpy(head2_l).to(dev)
    (want, _), ac_rules_plain_ms = timed_once(
        lambda: sc.ac_scan_plain(bcac, h2p, h2l, hz, per_packet=True))
    compare("ac_scan", sc.ac_scan(bcac, h2p, h2l, hz, per_packet=True)[0], want,
            "3,072 rules, phase 5's first 8,192 rows")
    print(f"3,072 rules: {bcac.num_states} AC states ({bcac.table.dtype}, "
          f"{bcac.table.numel() * bcac.table.element_size()} B, device memory; automaton and "
          f"tables {b_build:.3f} s), KMP {tuple(bkmp.table.shape)} {bkmp.table.dtype} "
          f"({k_build:.3f} s); engine=ac count_pcap {wall:.3f} s, {n_launch} launches = phase "
          f"5's counts; ac and kmp rows on {n_head} rows = phase 5's rows (kmp with the host "
          f"copy-back {kmp_rules_ms:.4f} ms); ac plain on those rows {ac_rules_plain_ms:.4f} ms "
          f"(1 run) [{card}]")

    # -- 4. the command line ------------------------------------------------------
    jax_keys = {"engine_requested", "engine_resolved", "patterns", "unique_patterns",
                "total_pattern_words", "max_pattern_len", "case_insensitive", "bucketed",
                "nul_patterns"}
    for e in ("ac", "kmp"):
        for flags in ([], ["--stream"], ["--sharded", "--shard-axis", "packets"]):
            reset()
            blob, wall = cli_json(cli, ["match", "--pcap", cap, "--patterns", pat_file, "--json",
                                        "--engine", e, *flags])
            sharded = "--sharded" in flags
            runs = "ac" if sharded else e
            n_launch = only(f"{runs}_scan", f"match --engine {e} {' '.join(flags)}")
            check(bool(flags) or n_launch == 1, f"match --engine {e} took {n_launch} launches")
            ex = blob["execution"]
            want_keys = jax_keys | {"device"} | ({"shard_axis"} if sharded else set()) | (
                {"sharded_remap"} if sharded and e == "kmp" else set())
            check(blob["counts"] == counts.tolist(), f"match --engine {e} {flags} counts differ")
            check(set(ex) == want_keys and ex["engine_resolved"] == runs
                  and ex.get("sharded_remap", "kmp->ac") == "kmp->ac",
                  f"match --engine {e} {flags} execution {ex}")
            print(f"match --engine {e} {' '.join(flags)} --json: phase 3's counts, "
                  f"{n_launch} {runs}_scan launches, execution keys = the JAX CLI's + device, "
                  f"{wall:.4f} s")

    # -- 5. flows ----------------------------------------------------------------
    fm = Matcher(patterns, engine="ac", device=dev)
    pcap = read_pcap(flow_cap)
    slices = [slice_pcap(pcap, s, s + FLOW_SLICE, copy=False)
              for s in range(0, pcap.num_packets, FLOW_SLICE)]
    split = {"round": 0.0}

    def stream(**kw):
        fs = FlowStreamMatcher(fm, "tcp", engine="ac", **kw)
        ac_round = fs._ac_round

        def timed_round(*a):
            t0 = time.perf_counter()
            ac_round(*a)
            torch.cuda.synchronize()
            split["round"] += time.perf_counter() - t0

        fs._ac_round = timed_round
        t0 = time.perf_counter()
        for sl in slices:
            fs.feed_pcap_slice(sl)
        fs.flush()
        out = fs.counts()
        return fs, out, time.perf_counter() - t0

    stream()  # warm
    walls, rounds_s = [], []
    for i in range(STREAM_RUNS):
        split["round"] = 0.0
        reset()
        fs, c, wall = stream()
        n_launch = only("ac_scan", "the AC flow stream")
        check(np.array_equal(c, flow_counts), "the AC flow stream differs from phase 6's counts")
        walls.append(wall)
        rounds_s.append(split["round"])
    check(fs._round > 1, "the AC flow stream ran one round: no flow was revived")
    med = statistics.median(walls)
    print(f"AC flow stream: {fs.flows_seen} flows revived over {fs._round} rounds from their "
          f"stored states, {n_launch} ac_scan launches = phase 6's counts; median {med:.4f} s of "
          f"{STREAM_RUNS} = {fs.bytes_seen / med:.6e} stream B/s; rounds (chunk loop, copies, "
          f"kernels, synchronised) median {statistics.median(rounds_s):.4f} s = "
          f"{statistics.median(rounds_s) / fs._round * 1e3:.4f} ms a round [{card}]")
    reset()
    blob, wall = cli_json(cli, ["match", "--pcap", flow_cap, "--patterns", pat_file, "--mode",
                                "tcp", "--json", "--flows", "--stream", "--engine", "ac"])
    n_launch = only("ac_scan", "match --flows --stream --engine ac")
    check(blob["counts"] == flow_counts.tolist() and blob["execution"]["engine_resolved"] == "ac",
          "match --flows --stream --engine ac differs from phase 6's")
    print(f"match --flows --stream --engine ac --json: phase 6's counts, {n_launch} launches, "
          f"{wall:.4f} s wall [{card}]")
    fb = extract_flows(pcap, "tcp")
    reset()
    t0 = time.perf_counter()
    c = count_flows_chunked(fm, fb)
    wall = time.perf_counter() - t0
    n_launch = only("ac_scan", "count_flows_chunked")
    check(np.array_equal(c, flow_counts), "count_flows_chunked differs from phase 6's counts")
    print(f"count_flows_chunked ({fb.num_flows} flows x {fb.payloads.shape[1]} B, 2,048-byte "
          f"chunks): {n_launch} launches = phase 6's counts, {wall:.4f} s")
    reset()
    fs, c, wall = stream(sharded=True, mesh=make_mesh([dev, dev]))
    n_launch = only("ac_scan", "the 2-shard AC flow stream")
    check(np.array_equal(c, flow_counts), "the 2-shard AC flow stream differs from phase 6's")
    print(f"AC flow stream on a 2-shard lane mesh (one card twice): {n_launch} launches = "
          f"phase 6's counts, {wall:.4f} s")
    rflows, rp = reorder_capture(patterns)
    want = oracle_counts([pay for _, pay in rflows], patterns)
    reset()
    fs = FlowStreamMatcher(fm, "tcp", engine="ac", reorder=True, scan_bytes=1 << 40)
    for s0 in range(0, rp.num_packets, 1000):
        fs.feed_pcap_slice(slice_pcap(rp, s0, s0 + 1000, copy=False))
    fs.flush()
    only("ac_scan", "the reordered AC flow stream")
    check(np.array_equal(fs.counts(), want), "the reordered AC flow stream differs from the "
          "pure-Python count")
    check(np.array_equal(fs.counts(), reorder_stream(Matcher(patterns, device=dev), rp)),
          "the reordered AC flow stream differs from the window engine's")
    print(f"reordered capture ({len(rflows)} flows): AC stream = window stream = pure Python "
          f"({int(want.sum())} matches)")

    # -- times ------------------------------------------------------------------
    def pass_fn(fn, tiles):
        zs = [torch.zeros(p.shape[0], dtype=torch.int32, device=dev) for p, _ in tiles]
        return lambda: [fn(p, l, z) for (p, l), z in zip(tiles, zs)]

    # A pass as count_prepared runs it (one launch over the tile list) and,
    # beside it, one launch a tile.
    passes = {
        "ac": lambda: sc.ac_scan_tiles(cac, prep.tiles),
        "kmp": lambda: sc.kmp_scan_tiles(kmp, prep.tiles),
        # check=False: the zero states need no check, which would wait for
        # the card once a tile.
        "ac per tile": pass_fn(lambda p, l, z: sc.ac_scan(cac, p, l, z, check=False),
                               prep.tiles),
        "kmp per tile": pass_fn(lambda p, l, z: sc.kmp_scan(kmp, p, l), prep.tiles),
    }
    std_filter = ct.CudaTableMatcher(matcher.window, dev, filtered=True)
    nbytes = prep.total_payload_bytes
    rows = sum(int(p.shape[0]) for p, _ in prep.tiles)
    t, dev_ms = {}, {}
    for name, fn in passes.items():
        _, once = timed_once(fn)
        runs = SCAN_RUNS if once < 200 else PLAIN_RUNS
        t[name] = cuda_ms(fn, runs)
        dev_ms[name] = device_ms(fn)
        print(f"stand-in set over phase 3's {len(prep.tiles)} tiles, {name}: {t[name]:.4f} ms "
              f"(median of {runs}) = {nbytes / t[name] * 1e3:.6e} payload B/s; device time "
              f"queued alone {fmt_ms(dev_ms[name])} [{card}]")
    check(np.array_equal(passes["ac"]()[torch.from_numpy(eng["ac"].ac.dup_map).to(dev).long()].cpu()
                         .numpy(), counts)
          and np.array_equal(passes["kmp"]().cpu().numpy(), counts),
          "the timed tile-list passes differ from phase 3's counts")
    ac_rows_dev = device_ms(lambda: sc.ac_scan_tiles(cac, prep.tiles, per_packet=True))
    print(f"ac_scan per packet over phase 3's {len(prep.tiles)} tiles, one launch: device time "
          f"queued alone {fmt_ms(ac_rows_dev)} [{card}]")
    # kmp_scan's groups against the lanes a launch should fill
    # (ops/scan.KMP_FILL_LANES): rows x groups.
    saved = sc.KMP_FILL_LANES
    try:
        for fill in (16384, 65536, 262144, 1 << 20):
            sc.KMP_FILL_LANES = fill
            g_all = sc.kmp_groups(kmp.accept_host[kmp.order_host], rows)
            g_one = sc.kmp_groups(kmp.accept_host[kmp.order_host], int(prep.tiles[0][0].shape[0]))
            print(f"kmp_scan groups at {fill} fill lanes: one launch {g_all[:2]} "
                  f"{fmt_ms(device_ms(passes['kmp']))} device, one a tile {g_one[:2]} (first "
                  f"tile) {fmt_ms(device_ms(passes['kmp per tile']))} device [{card}]")
    finally:
        sc.KMP_FILL_LANES = saved
    t["window"] = cuda_ms(lambda: matcher.kernels.count_tiles(prep.tiles), SCAN_RUNS)
    t["filter"] = cuda_ms(lambda: std_filter.count_tiles(prep.tiles), SCAN_RUNS)
    for e in ("window", "filter"):
        print(f"stand-in set over phase 3's {len(prep.tiles)} tiles, {e} kernel: {t[e]:.4f} ms = "
              f"{nbytes / t[e] * 1e3:.6e} payload B/s (median of {SCAN_RUNS}) [{card}]")
    rows_ms = {"ac": cuda_ms(lambda: sc.ac_scan(cac, hp, hl, hz, per_packet=True, check=False),
                             SCAN_RUNS),
               "kmp": cuda_ms(lambda: sc.kmp_scan(kmp, hp, hl, per_packet=True), SCAN_RUNS)}
    hbytes = int(np.clip(head_l, 0, None).sum())
    for e in ("ac", "kmp"):
        print(f"{e}_scan: first {n_head} rows ({hbytes} B), per packet: kernel "
              f"{rows_ms[e]:.4f} ms, plain {plain_ms[e]:.4f} ms (1 run) [{card}]")
    big_passes = {"ac": lambda: sc.ac_scan_tiles(bcac, prep2.tiles),
                  "ac per tile": pass_fn(lambda p, l, z: sc.ac_scan(bcac, p, l, z, check=False),
                                         prep2.tiles)}
    t2 = {k: cuda_ms(fn, SCAN_RUNS) for k, fn in big_passes.items()}
    ac2_dev = {k: device_ms(fn) for k, fn in big_passes.items()}
    t2["filter"] = cuda_ms(lambda: big.kernels.count_tiles(prep2.tiles), SCAN_RUNS)
    t2["window"] = cuda_ms(lambda: cw.CudaWindowMatcher(big.window, dev).count_tiles(prep2.tiles),
                           SCAN_RUNS)
    for e, ms in t2.items():
        print(f"3,072 rules over phase 5's {len(prep2.tiles)} tiles, {e}: {ms:.4f} ms = "
              f"{prep2.total_payload_bytes / ms * 1e3:.6e} payload B/s (median of {SCAN_RUNS})"
              f"{'; device time queued alone ' + fmt_ms(ac2_dev[e]) if e in ac2_dev else ''} "
              f"[{card}]")

    # The commands' walls, in turns.
    walls = {}
    for _ in range(WALL_ROUNDS):
        for e in ("pallas", "ac", "kmp"):
            for flags in ([], ["--stream"]):
                blob, wall = cli_json(cli, ["match", "--pcap", cap, "--patterns", pat_file,
                                            "--json", "--engine", e, *flags])
                check(blob["counts"] == counts.tolist(), f"match --engine {e} {flags}")
                walls.setdefault((e, " ".join(flags)), []).append(wall)
    for (e, flags), w in walls.items():
        print(f"match --engine {e} {flags} --json wall: median {statistics.median(w):.4f} s of "
              f"{len(w)} ({', '.join(f'{x:.4f}' for x in w)}) [{card}]")

    U = cac.num_unique
    P = len(patterns)
    recs = []
    rules_bound = scan_bound(prep2.total_payload_bytes,
                             4 * sum(int(p.shape[0]) for p, _ in prep2.tiles),
                             bcac.ktable.numel() * bcac.ktable.element_size(), bcac.num_unique,
                             AC_OPS_PER_BYTE * prep2.total_payload_bytes)
    for e, line, ops, out_ints, table, row_bytes in (
        ("ac", 71, AC_OPS_PER_BYTE * nbytes, U, cac.ktable, 4 * rows),
        ("kmp", 174, KMP_OPS_PER_BYTE * P * nbytes, P, kmp.table, 4 * rows),
    ):
        b = scan_bound(nbytes, row_bytes, table.numel() * table.element_size(), out_ints, ops)
        tile_ms = t[f"{e} per tile"]
        print(f"{e}_scan bound: {b['bound_ms']:.4f} ms ({b['bound_by']}); one launch over the "
              f"tiles {t[e]:.4f} ms = {b['bound_ms'] / t[e]:.4f} of its bound (device "
              f"{fmt_ms(dev_ms[e])}), one launch a tile {tile_ms:.4f} ms = "
              f"{b['bound_ms'] / tile_ms:.4f} (device {fmt_ms(dev_ms[e + ' per tile'])}) [{card}]")
        rec = {"name": f"{e}_scan", "route": "cuda", "source": SCAN_SRC,
               "replaces": f"{SCAN_REF}:{line}", "launches": launches[f"{e}_scan"],
               "max_abs_err": max_err[f"{e}_scan"], "ms": t[e], "device_ms": dev_ms[e],
               "ms_one_launch_a_tile": tile_ms,
               "device_ms_one_launch_a_tile": dev_ms[f"{e} per tile"],
               "plain_ms": plain_ms[e], "plain_rows": n_head, "rows_ms": rows_ms[e],
               "library_ms": None, **b, "bound_share": b["bound_ms"] / t[e]}
        if e == "ac":
            rec.update({"rules_ms": t2["ac"], "rules_device_ms": ac2_dev["ac"],
                        "rules_ms_one_launch_a_tile": t2["ac per tile"],
                        "rules_device_ms_one_launch_a_tile": ac2_dev["ac per tile"],
                        "rules_bound_ms": rules_bound["bound_ms"],
                        "rules_bound_share": rules_bound["bound_ms"] / t2["ac"]})
            print(f"ac_scan at 3,072 rules: bound {rules_bound['bound_ms']:.4f} ms "
                  f"({rules_bound['bound_by']}), {rules_bound['bound_ms'] / t2['ac']:.4f} of it "
                  f"in one launch, {rules_bound['bound_ms'] / t2['ac per tile']:.4f} in one a "
                  f"tile [{card}]")
        recs.append(rec)
    print(f"phase 11: {time.perf_counter() - t_phase:.3f} s")
    return recs


# -- the live path and the new inputs (phase 12) -------------------------------

LIVE_RUNS = 3
LONG_PACKETS = 3000


def pcapng_of(pcap, path: pathlib.Path) -> pathlib.Path:
    """Re-encode a classic capture as pcapng: one section (SHB), one
    interface (IDB, microsecond ticks), an EPB per packet."""
    def block(btype: int, body: bytes) -> bytes:
        pad = (-len(body)) % 4
        blen = 12 + len(body) + pad
        return struct.pack("<II", btype, blen) + body + b"\x00" * pad + struct.pack("<I", blen)

    parts = [block(0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1)),
             block(0x00000001, struct.pack("<HHI", pcap.linktype, 0, pcap.snaplen))]
    for i in range(pcap.num_packets):
        data = pcap.packet(i).tobytes()
        ticks = int(pcap.ts_sec[i]) * 1_000_000 + int(pcap.ts_frac[i])
        parts.append(block(0x00000006, struct.pack(
            "<IIIII", 0, ticks >> 32, ticks & 0xFFFFFFFF, len(data), int(pcap.origlens[i])) + data))
    path.write_bytes(b"".join(parts))
    return path


def live_run(cli, argv):
    """``({pattern: count}, sniffed, exit code, wall seconds, stderr)`` of one
    ``live`` command run in process."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    wall = time.perf_counter() - t0
    text = out.getvalue()
    check(text.startswith("\nWork in progress...\nPress ctrl+c to stop sniffing procedure\n"),
          f"live banner: {text[:200]!r}")
    found = re.search(r"\n\n(\d+) packet sniffed\n\n", text)
    check(found is not None, "live printed no sniffed line")
    reported = {}
    for line in text.splitlines():
        if line.endswith(" times!"):
            name, _, rest = line.rpartition(": ")
            reported.setdefault(name, int(rest.split()[0]))
    return reported, int(found[1]), rc, wall, err.getvalue()


def launches_of(*modules) -> dict:
    return {k: v for m in modules for k, v in m.LAUNCHES.items() if v}


def live_phase(dev, card: str, cli, cw, ct, sc, matcher, patterns, pat_file, cap, counts, rules,
               big, rules_file, cap2, big_counts, flow_cap, flow_counts, compare) -> dict:
    """Phase 12; returns the launches of its main runs per kernel.  The
    3,072 rules replay phase 5's capture (planted with them), the other
    sets phase 3's."""
    import torch

    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.decode import (
        bpf_protocol_mask,
        extract_payloads,
    )
    from multithreading_string_matching_tpu_torch.io.live import FileReplaySource
    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
    from multithreading_string_matching_tpu_torch.io.pcap import iter_pcap, read_pcap
    from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap
    from multithreading_string_matching_tpu_torch.ops.bucketing import pack_rows
    from multithreading_string_matching_tpu_torch.ops.scan import ac_scan_plain
    from multithreading_string_matching_tpu_torch.ops.table import filter_count
    from multithreading_string_matching_tpu_torch.ops.window import (
        window_count,
        window_count_halo_plain,
    )
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher
    from multithreading_string_matching_tpu_torch.parallel.stream import StreamMatcher

    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="msm_torch_live_"))
    pc = read_pcap(cap)
    replays = {}
    for c in (cap, cap2):
        bs = list(FileReplaySource(c))
        replays[c] = (bs, int(bpf_protocol_mask(read_pcap(c), "udp").sum()),
                      sum(1 for b in bs if bpf_protocol_mask(b, "udp").any()))
    batches, sniff_want, udp_batches = replays[cap]
    nul_pats = patterns + [b"a\x00b"]
    nul_file = tmp / "nul.txt"
    nul_file.write_bytes(b"\n".join(nul_pats) + b"\n")
    check(load_patterns(nul_file) == nul_pats, "the NUL rules file does not load back")
    nul = Matcher(nul_pats, device=dev)
    sets = {
        "stand-in": (pat_file, patterns, matcher, counts, cap),
        "3,072 rules": (rules_file, rules, big, big_counts, cap2),
        "stand-in + NUL": (nul_file, nul_pats, nul, nul.count_pcap(cap, "udp"), cap),
    }
    for c, (bs, sn, ub) in replays.items():
        print(f"live capture {c.name}: {c.stat().st_size} bytes, {sn} packets pass the udp "
              f"filter, {len(bs)} batches of 10 ({ub} with a udp packet)")

    # -- the kernels against their plain versions at this path's shapes -----
    first = extract_payloads(pc, "udp", keep_invalid=True)
    keep = bpf_protocol_mask(pc, "udp")[: first.payloads.shape[0]]
    rows_p, rows_f = pack_rows(first.payloads[: pc.num_packets][keep][:4000],
                               first.lengths[: pc.num_packets][keep][:4000].astype(np.int64),
                               width=2048)
    tile_p = torch.from_numpy(np.ascontiguousarray(rows_p[:1024])).to(dev)
    tile_f = torch.from_numpy(np.ascontiguousarray(rows_f[:1024])).to(dev)
    words, masks, lens = matcher.window.tables(dev)
    compare("window_count_totals", cw.window_count_totals(tile_p, tile_f, words, masks, lens),
            window_count(words, masks, lens, tile_p, tile_f), "a live packed tile [1024 x 2048]")
    for c, tabs in zip(big.kernels.classes, big.kernels._tables):
        compare("filter_count_totals", ct.filter_count_totals(tile_p, tile_f, *tabs, c.K),
                filter_count(*tabs, tile_p, tile_f, c.K), f"a live packed tile, class K={c.K}")
    dump_p = torch.from_numpy(np.ascontiguousarray(first.payloads[:1024])).to(dev)
    dump_l = torch.from_numpy(np.ascontiguousarray(first.lengths[:1024])).to(dev)
    compare("window_count_rows", cw.window_count_rows(dump_p, dump_l, words, masks, lens),
            window_count(words, masks, lens, dump_p, dump_l, per_packet=True),
            "a dump scan's rows [1024 x width]")
    for c, tabs in zip(big.kernels.classes, big.kernels._tables):
        compare("filter_count_rows", ct.filter_count_rows(dump_p, dump_l, *tabs, c.K),
                filter_count(*tabs, dump_p, dump_l, c.K, per_row=True),
                f"a dump scan's rows, class K={c.K}")

    # -- the main runs: a StreamMatcher driven directly, launches counted ----
    live_launches: dict = {}
    walls = {}
    for name, (pfile, pats, m, want, capture) in sets.items():
        batches, sniff_want, udp_batches = replays[capture]
        torch.cuda.synchronize()
        reset_launches(cw, ct, sc)
        t0 = time.perf_counter()
        s = StreamMatcher(m)
        for b in batches:
            s.feed_pcap_slice(b, "udp", bpf_filter=True)
        got = s.counts()
        direct_s = time.perf_counter() - t0
        launched = launches_of(cw, ct, sc)
        for k, v in launched.items():
            live_launches[k] = live_launches.get(k, 0) + v
        check(np.array_equal(got, want), f"live {name}: counts differ from serial's")
        check(s.packets_seen == sniff_want, f"live {name}: {s.packets_seen} packets seen, "
              f"{sniff_want} pass the filter")
        if name == "stand-in":
            expect = {"window_count_totals": s.tiles_dispatched}
        elif name == "3,072 rules":
            expect = {"filter_count_totals": s.tiles_dispatched * len(m.kernels.classes)}
        else:
            expect = {"window_count_totals": udp_batches}
            check(s.tiles_dispatched == 0, "the NUL set was packed")
        check(launched == expect, f"live {name}: launches {launched}, expected {expect}")
        check(name == "stand-in + NUL" or 0 < s.tiles_dispatched < udp_batches // 10,
              f"live {name}: {s.tiles_dispatched} tiles for {udp_batches} batches")
        # The command, median of LIVE_RUNS walls, each report checked.
        runs = []
        for _ in range(LIVE_RUNS):
            reset_launches(cw, ct, sc)
            reported, sniffed, rc, wall, err = live_run(cli, ["live", capture, pfile, "4", "udp"])
            check(rc == 0, f"live {name} exited {rc}: {err[-2000:]}")
            check(reported == nonzero(pats, want), f"live {name}: report differs from serial's")
            check(sniffed == sniff_want, f"live {name}: {sniffed} packet sniffed")
            check(launches_of(cw, ct, sc) == expect,
                  f"live {name} command: launches {launches_of(cw, ct, sc)}, expected {expect}")
            runs.append(wall)
        walls[name] = statistics.median(runs)
        print(f"live {name} ({len(pats)} patterns, {m.explain().get('pallas_kernel')}): command "
              f"wall median {walls[name]:.4f} s of {LIVE_RUNS} ({', '.join(f'{w:.4f}' for w in runs)}); "
              f"StreamMatcher driven directly {direct_s:.4f} s; {s.tiles_dispatched} tiles for "
              f"{len(batches)} batches; launches {launched}; {int(got.sum())} matches = serial's "
              f"[{card}]")
    batches, sniff_want, udp_batches = replays[cap]
    # The same command without [threads] (no prefetch thread), once.
    reported, _, rc, wall, _ = live_run(cli, ["live", cap, pat_file, "udp"])
    check(rc == 0 and reported == nonzero(patterns, counts), "live without threads")
    print(f"live stand-in without [threads]: {wall:.4f} s (with 4: median "
          f"{walls['stand-in']:.4f} s) [{card}]")

    # -- the device's busy share of one live replay --------------------------
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reported, _, rc, _, _ = live_run(cli, ["live", cap, pat_file, "4", "udp"])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    check(rc == 0 and reported == nonzero(patterns, counts), "profiled live run")
    busy = device_busy(prof)
    check(busy.get("kernel_ms", 0) > 0, f"the profiled live run shows no device time: {busy}")
    print(f"live stand-in under torch.profiler: wall {prof_wall:.4f} s, device busy "
          f"{busy['busy_ms']:.4f} ms (kernels {busy['kernel_ms']:.4f}, copies "
          f"{busy['copy_ms']:.4f}, {busy['events']} events) = busy share "
          f"{busy['busy_ms'] / (prof_wall * 1e3):.6f} [{card}]")

    # -- --dump-matches: the live dump is match's dump ------------------------
    for name, key in (("stand-in", "window_count_rows"), ("3,072 rules", "filter_count_rows")):
        pfile, capture = sets[name][0], sets[name][4]
        live_dump, match_dump = tmp / "live.pcap", tmp / "match.pcap"
        reset_launches(cw, ct, sc)
        _, _, rc, wall, err = live_run(cli, ["live", capture, pfile, "udp", "--dump-matches",
                                             live_dump])
        check(rc == 0, f"live --dump-matches exited {rc}: {err[-2000:]}")
        rows_launched = launches_of(cw, ct, sc)
        check(rows_launched.get(key, 0) > 0, f"live --dump-matches ({name}): {rows_launched}")
        live_launches[key] = live_launches.get(key, 0) + rows_launched[key]
        cli_json(cli, ["match", "--pcap", capture, "--patterns", pfile, "--json",
                       "--dump-matches", match_dump])
        check(live_dump.read_bytes() == match_dump.read_bytes(),
              f"live --dump-matches ({name}) differs from match --dump-matches")
        print(f"live --dump-matches ({name}): {read_pcap(live_dump).num_packets} packets, "
              f"byte-equal to match --dump-matches; {wall:.4f} s, launches {rows_launched} "
              f"[{card}]")

    # -- long payloads: the halo kernel and ac_scan with carried states -------
    long_cap = tmp / "long.pcap"
    synth_udp_pcap(long_cap, LONG_PACKETS, payload_len=6000, payload_len_jitter=1500,
                   patterns=patterns, plant_rate=0.5, seed=SEED + 12)
    long_want = Matcher(patterns, device=dev).count_pcap(long_cap, "udp")
    long_plain = Matcher(patterns, engine="window", device=dev).count_pcap(long_cap, "udp")
    check(np.array_equal(long_want, long_plain), "long payloads: one-shot kernels != plain")
    long_batches = list(FileReplaySource(long_cap))
    lb = extract_payloads(long_batches[0], "udp", keep_invalid=True)
    H = max(int(matcher.window.max_len) - 1, 1)
    x = np.zeros((lb.payloads.shape[0], H + 2048), np.uint8)
    x[:, :H] = lb.payloads[:, 2048 - H : 2048]  # the halo before the second chunk
    x[:, H:] = lb.payloads[:, 2048:4096]
    xt = torch.from_numpy(x).to(dev)
    eff = torch.from_numpy(np.clip(lb.lengths.astype(np.int64) - 2048 + H, 0, H + 2048)
                           .astype(np.int32)).to(dev)
    ms = torch.zeros(x.shape[0], dtype=torch.int32, device=dev)
    compare("window_count_halo", cw.window_count_halo(xt, eff, ms, words, masks, lens, H),
            window_count_halo_plain(xt, eff, ms, H, (words, masks, lens)),
            f"a long batch's second chunk [{x.shape[0]} x {H + 2048}]")
    chunk = torch.from_numpy(np.ascontiguousarray(lb.payloads[:, 2048:4096])).to(dev)
    rel = torch.from_numpy(np.clip(lb.lengths.astype(np.int64) - 2048, 0, 2048)
                           .astype(np.int32)).to(dev)
    cac = matcher.cac
    states = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cac.dead + 1, size=x.shape[0]).astype(np.int32)).to(dev)
    got_c, got_s = sc.ac_scan(cac, chunk, rel, states)
    want_c, want_s = ac_scan_plain(cac, chunk, rel, states)
    compare("ac_scan", got_c, want_c, "a long batch's chunk from carried states")
    compare("ac_scan", got_s, want_s, "a long batch's chunk's states")
    for engine, key in (("window", "window_count_halo"), ("ac", "ac_scan")):
        torch.cuda.synchronize()
        reset_launches(cw, ct, sc)
        t0 = time.perf_counter()
        s = StreamMatcher(matcher, packed=False, engine=engine)
        for b in long_batches:
            s.feed_pcap_slice(b, "udp", bpf_filter=True)
        got = s.counts()
        wall = time.perf_counter() - t0
        launched = launches_of(cw, ct, sc)
        check(np.array_equal(got, long_want), f"long payloads, engine={engine}: counts differ")
        check(set(launched) == {key}, f"long payloads, engine={engine}: launches {launched}")
        live_launches[key] = live_launches.get(key, 0) + launched[key]
        print(f"long payloads ({LONG_PACKETS} packets of ~6,000 bytes), StreamMatcher "
              f"engine={engine}: {launched} = count_pcap's and the plain version's counts "
              f"({int(got.sum())} matches), {wall:.4f} s [{card}]")

    # -- checkpoints ----------------------------------------------------------
    half = len(batches) // 2
    s = StreamMatcher(matcher)
    for b in batches[:half]:
        s.feed_pcap_slice(b, "udp", bpf_filter=True)
    ckpt = s.save(tmp / "stream")
    resumed = StreamMatcher(matcher)
    resumed.load(ckpt)
    for b in batches[half:]:
        resumed.feed_pcap_slice(b, "udp", bpf_filter=True)
    check(np.array_equal(resumed.counts(), counts) and resumed.packets_seen == sniff_want,
          "a StreamMatcher resumed from its checkpoint differs from the uninterrupted run")
    fm = Matcher(patterns, device=dev)
    chunks = list(iter_pcap(flow_cap, batch_packets=8192))
    for engine, key in (("window", "window_count_halo"), ("ac", "ac_scan")):
        fs = FlowStreamMatcher(fm, "tcp", engine=engine)
        for c in chunks[: len(chunks) // 2]:
            fs.feed_pcap_slice(c)
        ckpt = fs.save(tmp / f"flows_{engine}")
        reset_launches(cw, ct, sc)
        fs2 = FlowStreamMatcher(fm, "tcp", engine=engine)
        fs2.load(ckpt)
        for c in chunks[len(chunks) // 2 :]:
            fs2.feed_pcap_slice(c)
        fs2.flush()
        check(np.array_equal(fs2.counts(), flow_counts),
              f"the {engine} flow stream resumed from its checkpoint differs from phase 6's")
        check(launches_of(cw, ct, sc).get(key, 0) > 0, f"resumed {engine} flow stream: {key}")
        print(f"checkpoints: flow stream ({engine}) saved after {len(chunks) // 2} of "
              f"{len(chunks)} chunks ({os.path.getsize(ckpt)} bytes), resumed = phase 6's "
              f"counts, launches {launches_of(cw, ct, sc)}")
    print(f"checkpoints: StreamMatcher saved after {half} of {len(batches)} batches, resumed "
          f"= the uninterrupted run")

    # -- pcapng ------------------------------------------------------------
    t0 = time.perf_counter()
    ng = pcapng_of(pc, tmp / "mega.pcapng")
    enc_s = time.perf_counter() - t0
    ingest = {}
    for label, path in (("classic", cap), ("pcapng", ng)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got_pc = read_pcap(path)
            times.append(time.perf_counter() - t0)
        check(got_pc.num_packets == pc.num_packets, f"{label} read {got_pc.num_packets} packets")
        ingest[label] = statistics.median(times)
    for flags in ([], ["--stream"], ["--engine", "ac"]):
        blob, wall = cli_json(cli, ["match", "--pcap", ng, "--patterns", pat_file, "--json",
                                    *flags])
        check(blob["counts"] == counts.tolist(), f"match {' '.join(flags)} on pcapng differs")
        print(f"match {' '.join(flags) or '(one-shot)'} on the pcapng copy: phase 3's counts, "
              f"{wall:.4f} s [{card}]")
    print(f"pcapng ({ng.stat().st_size} bytes, encoded in {enc_s:.3f} s): read_pcap median "
          f"{ingest['pcapng']:.4f} s of 3, classic {ingest['classic']:.4f} s [{card}]")

    # -- match --profile ------------------------------------------------------
    prof_dir = tmp / "profile"
    blob, wall = cli_json(cli, ["match", "--pcap", cap, "--patterns", pat_file, "--json",
                                "--profile", prof_dir])
    check(blob["counts"] == counts.tolist(), "match --profile counts differ")
    traces = list(prof_dir.glob("*.json"))
    check(len(traces) == 1, f"match --profile wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    named = [e for e in events if "window_count" in str(e.get("name", ""))]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(named and kernels, f"the trace names no window_count launch ({len(events)} events)")
    print(f"match --profile: {traces[0].name}, {len(events)} events, {len(named)} name a "
          f"window_count launch, {len(kernels)} device kernels; {wall:.4f} s")

    shutil.rmtree(tmp)
    print(f"phase 12: {time.perf_counter() - t_phase:.3f} s; launches {live_launches}")
    return live_launches


# -- 13. the multi-process path ---------------------------------------------------

PKG = "multithreading_string_matching_tpu_torch"
RANKS = 2
RANK_TIMEOUT_S = 300
MESH_RUNS = 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv, n: int):
    """``([(stdout, stderr)] by rank, wall seconds)`` of ``n`` processes of
    ``python argv`` on this card, joined through ``MSM_COORDINATOR`` on a
    fresh port (one process without a coordinator when ``n`` is 1).  A
    rank's nonzero exit or traceback fails the run; no rank outlives it."""
    root = pathlib.Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("MSM_COORDINATOR", "MSM_NUM_PROCESSES", "MSM_PROCESS_ID")}
    env.update(MSM_DEVICE="cuda", PYTHONPATH=str(root))
    coord = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, *map(str, argv)], cwd=root, text=True,
        env={**env, **({"MSM_COORDINATOR": coord, "MSM_NUM_PROCESSES": str(n),
                        "MSM_PROCESS_ID": str(r)} if n > 1 else {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(n)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, (_, se)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and "Traceback" not in se,
              f"rank {r} of {n} ({' '.join(map(str, argv))}) exited {p.returncode}: {se[-3000:]}")
    return outs, wall


def distributed_rank(out_pattern, cap, pat_file, cap2, rules_file) -> int:
    """One rank of phase 13's rank script (``chip_smoke.py --distributed-rank
    ...``): the distributed entry points on this card with the launch
    counters reset just before each, and the device's busy share of one
    one-shot count, written to ``out_pattern % rank``."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
    from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
    from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
    from multithreading_string_matching_tpu_torch.ops import scan as sc
    from multithreading_string_matching_tpu_torch.parallel.distributed import (
        count_pcap_distributed,
        count_pcap_streamed_distributed,
        initialize_from_env,
    )

    check(initialize_from_env() and dist.get_world_size() == RANKS, "the rank joined no group")
    rank = dist.get_rank()
    dev = torch.device("cuda")
    matcher = Matcher(load_patterns(pat_file), device=dev)
    big = Matcher(load_patterns(rules_file), device=dev)
    out = {}
    stats: dict = {}
    for name, fn in (
        ("pallas", lambda: count_pcap_distributed(matcher, cap, engine="pallas")),
        ("ac", lambda: count_pcap_distributed(matcher, cap, engine="ac")),
        ("streamed", lambda: count_pcap_streamed_distributed(matcher, cap, stats=stats)),
        ("rules", lambda: count_pcap_distributed(big, cap2, engine="pallas")),
    ):
        torch.cuda.synchronize()
        reset_launches(cw, ct, sc)
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
        out[name] = {"counts": res.counts.tolist(), "local_packets": res.local_packets,
                     "local_payload_bytes": res.local_payload_bytes,
                     "elapsed_max_s": res.elapsed_max_s, "wall_s": wall,
                     "launches": launches_of(cw, ct, sc)}
    out["streamed"]["stats"] = stats
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        count_pcap_distributed(matcher, cap, engine="pallas")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["busy"] = {**device_busy(prof), "wall_ms": wall * 1e3}
    pathlib.Path(out_pattern % rank).write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def distributed_phase(dev, card: str, cli, cw, ct, sc, matcher, patterns, pat_file, cap, counts,
                      big, rules, rules_file, cap2, big_counts, compare) -> dict:
    """Phase 13; returns the launches of the rank script's runs per kernel,
    summed over its ranks."""
    import torch

    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
    from multithreading_string_matching_tpu_torch.ops.table import filter_count
    from multithreading_string_matching_tpu_torch.ops.window import window_count

    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="msm_torch_dist_"))

    # -- mesh: one process and two ranks, in turns ----------------------------
    walls = {1: [], RANKS: []}
    elapsed = {1: [], RANKS: []}
    for _ in range(MESH_RUNS):
        for n in (1, RANKS):
            outs, wall = run_ranks(["-m", PKG, "mesh", cap, pat_file, "udp"], n)
            reported, el = parse_report(outs[0][0])
            check(reported == nonzero(patterns, counts),
                  f"mesh with {n} process(es): counts differ from phase 3's")
            check(all(so == "" for so, _ in outs[1:]), "a rank other than 0 printed")
            walls[n].append(wall)
            elapsed[n].append(el)
    for n in (1, RANKS):
        print(f"mesh, {n} process(es), phase 3's capture: wall median "
              f"{statistics.median(walls[n]):.4f} s of {MESH_RUNS} "
              f"({', '.join(f'{w:.4f}' for w in walls[n])}), rank 0's elapsed_max_s "
              f"{', '.join(f'{e:.4f}' for e in elapsed[n])} [{card}]")
    outs, wall = run_ranks(["-m", PKG, "mesh", cap2, rules_file, "udp"], RANKS)
    check(parse_report(outs[0][0])[0] == nonzero(rules, big_counts) and outs[1][0] == "",
          "mesh with 2 ranks on the 3,072 rules: counts differ from phase 5's")
    print(f"mesh, {RANKS} ranks, 3,072 rules: phase 5's counts, wall {wall:.4f} s, elapsed_max_s "
          f"{parse_report(outs[0][0])[1]:.4f} [{card}]")

    # -- match --stream --distributed ------------------------------------------
    match = ["match", "--pcap", cap, "--patterns", pat_file, "--stream", "--json"]
    single, single_s = cli_json(cli, match)
    outs, wall = run_ranks(["-m", PKG, *match, "--distributed"], RANKS)
    blob = json.loads(outs[0][0].splitlines()[-1])
    check(outs[1][0] == "", "match --distributed: rank 1 printed")
    check(single["counts"] == counts.tolist(), "match --stream differs from phase 3's counts")
    for key in ("counts", "packets", "valid_payloads", "payload_bytes"):
        check(blob[key] == single[key], f"match --stream --distributed: {key} differs")
    print(f"match --stream --distributed --json, {RANKS} ranks: the single process's counts and "
          f"stats, wall {wall:.4f} s (one process in process: {single_s:.4f} s) [{card}]")

    # -- the rank script: the entry points, launches counted per rank ------------
    outs, wall = run_ranks([pathlib.Path(__file__).resolve(), "--distributed-rank",
                            tmp / "rank%d.json", cap, pat_file, cap2, rules_file], RANKS)
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(RANKS)]
    n_pkts = read_pcap(cap).num_packets
    share = -(-n_pkts // RANKS)
    launches: dict = {}
    for r, got in enumerate(ranks):
        for name in ("pallas", "ac", "streamed"):
            check(got[name]["counts"] == counts.tolist(), f"rank {r} {name}: not phase 3's counts")
        check(got["rules"]["counts"] == big_counts.tolist(), f"rank {r} rules: not phase 5's counts")
        check(got["pallas"]["local_packets"] == min(n_pkts, (r + 1) * share) - r * share,
              f"rank {r} counted {got['pallas']['local_packets']} packets")
        check(got["streamed"]["stats"]["packets"] == n_pkts, "streamed stats are not the capture's")
        expect = {"pallas": {"window_count_totals"}, "ac": {"ac_scan"},
                  "streamed": {"window_count_totals"}, "rules": {"filter_count_totals"}}
        for name, kernels in expect.items():
            got_l = got[name]["launches"]
            check(set(got_l) == kernels and all(v > 0 for v in got_l.values()),
                  f"rank {r} {name} launched {got_l}, expected {kernels}")
            for k, v in got_l.items():
                launches[k] = launches.get(k, 0) + v
        print(f"rank {r}: " + "; ".join(
            f"{name} {got[name]['local_packets']} packets, {got[name]['wall_s']:.4f} s, "
            f"elapsed_max_s {got[name]['elapsed_max_s']:.4f}, launches {got[name]['launches']}"
            for name in ("pallas", "ac", "streamed", "rules")) + f" [{card}]")
        busy = got["busy"]
        check(busy.get("events", 0) > 0, f"rank {r}: the profiled count shows no device time")
        print(f"rank {r}, one profiled count_pcap_distributed (pallas): device busy "
              f"{busy['busy_ms']:.4f} ms (kernels {busy['kernel_ms']:.4f}, copies "
              f"{busy['copy_ms']:.4f}) of {busy['wall_ms']:.4f} ms: busy share "
              f"{busy['busy_ms'] / busy['wall_ms']:.6f} [{card}]")
    print(f"rank script, {RANKS} ranks: wall {wall:.4f} s; launches over both ranks {launches}")

    # -- the kernels against their plain versions at a rank's shard shape --------
    def rank0_shard(capture):
        """Rank 0's rows of ``capture`` padded to the ranks' common width."""
        pc = read_pcap(capture)
        half = -(-pc.num_packets // RANKS)
        parts = [extract_payloads(slice_pcap(pc, r * half, (r + 1) * half), "udp",
                                  keep_invalid=True) for r in range(RANKS)]
        width = -(-max(b.payloads.shape[1] for b in parts) // 128) * 128
        p = np.pad(parts[0].payloads, ((0, half - parts[0].payloads.shape[0]),
                                       (0, width - parts[0].payloads.shape[1])))
        ln = np.pad(parts[0].lengths, (0, half - parts[0].lengths.shape[0]))
        return torch.from_numpy(p).to(dev), torch.from_numpy(ln.astype(np.int32)).to(dev)

    p0, l0 = rank0_shard(cap)
    words, masks, lens = matcher.window.tables(dev)
    compare("window_count_totals", cw.window_count_totals(p0, l0, words, masks, lens),
            window_count(words, masks, lens, p0, l0), f"rank 0's shard {list(p0.shape)}")
    head_p, head_l = p0[:1024].contiguous(), l0[:1024].contiguous()
    zeros = torch.zeros(head_p.shape[0], dtype=torch.int32, device=dev)
    compare("ac_scan", sc.ac_scan(matcher.cac, head_p, head_l, zeros)[0],
            sc.ac_scan_plain(matcher.cac, head_p, head_l, zeros)[0],
            f"rank 0's shard, first 1,024 rows x {p0.shape[1]}")
    q0, m0 = rank0_shard(cap2)
    q0, m0 = q0[:1024].contiguous(), m0[:1024].contiguous()
    for c, tabs in zip(big.kernels.classes, big.kernels._tables):
        compare("filter_count_totals", ct.filter_count_totals(q0, m0, *tabs, c.K),
                filter_count(*tabs, q0, m0, c.K),
                f"rank 0's 3,072-rule shard, first 1,024 rows, class K={c.K}")
    print(f"kernels = plain at rank 0's shard shape: window_count_totals {list(p0.shape)}; "
          f"ac_scan and {len(big.kernels.classes)} filter classes on its first 1,024 rows")
    shutil.rmtree(tmp)
    print(f"phase 13: {time.perf_counter() - t_phase:.3f} s; launches {launches}")
    return launches


def demo_flow_capture(patterns, path: pathlib.Path) -> pathlib.Path:
    """``DEMO_FLOWS`` seeded TCP flows of ``DEMO_FLOW_BYTES`` printable bytes,
    each planted with 4 patterns at random offsets and 2 across a segment
    boundary, in ``DEMO_SEGMENT``-byte segments, interleaved."""
    from multithreading_string_matching_tpu_torch.io.synth import synth_tcp_flows_pcap

    rng = np.random.default_rng(SEED + 40)
    flows = []
    for i in range(DEMO_FLOWS):
        pay = rng.integers(0x20, 0x7F, size=DEMO_FLOW_BYTES, dtype=np.uint8)
        for _ in range(4):
            p = patterns[int(rng.integers(0, len(patterns)))]
            o = int(rng.integers(0, DEMO_FLOW_BYTES - len(p)))
            pay[o : o + len(p)] = np.frombuffer(p, np.uint8)
        for _ in range(2):
            p = patterns[int(rng.integers(0, len(patterns)))]
            if len(p) > 1:
                edge = DEMO_SEGMENT * int(rng.integers(1, DEMO_FLOW_BYTES // DEMO_SEGMENT))
                o = edge - int(rng.integers(1, len(p)))
                pay[o : o + len(p)] = np.frombuffer(p, np.uint8)
        flows.append(((f"10.7.{i // 200}.{i % 200 + 1}", "10.7.255.1", 2000 + i, 80),
                      pay.tobytes(), [DEMO_SEGMENT] * (-(-DEMO_FLOW_BYTES // DEMO_SEGMENT))))
    synth_tcp_flows_pcap(path, flows, interleave_seed=SEED)
    return path


def demo_output(main_fn, argv, **env) -> str:
    """A demo's stdout from ``main_fn(argv)`` run in this process, with
    ``env`` set around it; a non-zero return fails the run."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main_fn(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(rc == 0, f"demo {main_fn.__module__} {argv} returned {rc}")
    return out.getvalue()


def alerts_by_signature(text: str, prefix: str) -> dict:
    """``{signature bytes: lines}`` of a demo's lines that start with
    ``prefix`` and end in ``...: 'sig'`` or ``signature='sig'``."""
    out = {}
    for line in text.splitlines():
        if line.startswith(prefix):
            sig = ast.literal_eval(re.search(r"(?:signature=|: )('.*')$", line)[1])
            key = sig.encode("latin-1")
            out[key] = out.get(key, 0) + 1
    return out


def soak_phase(dev, card: str, cap, pat_file, patterns, counts) -> dict:
    """Phase 14: the differential soak, the fuzz soak and both demos on the
    card.  Returns ``{kernel record name: soak cases}``."""
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.examples import flow_ids_demo, ids_demo
    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.flows import extract_flows
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
    from multithreading_string_matching_tpu_torch.tools import differential, fuzz_soak

    t_phase = time.perf_counter()
    seed = int.from_bytes(os.urandom(4), "little")
    print(f"soak seed: {seed} [{card}]")
    out = pathlib.Path(tempfile.mkdtemp(prefix="msm_soak_"))
    t0 = time.perf_counter()
    stats = differential.soak(seed, device=dev, out=out)
    diff_s = time.perf_counter() - t0
    for line in differential.summary_lines(stats, seed, "cuda", card):
        print(line)
    short = [t for t in differential.TARGETS if stats[t]["cases"] < differential.DEFAULT_CASES]
    check(not short, f"differential: entry points under {differential.DEFAULT_CASES} cases: {short}")

    t0 = time.perf_counter()
    fuzz_cases, ran = fuzz_soak.soak(SOAK_FUZZ_MINUTES, seed, dev)
    fuzz_s = time.perf_counter() - t0
    check(fuzz_cases > 0 and all(ran.get(k) for k in ("per_packet", "table", "find", "streamed",
                                                       "flows")),
          f"fuzz soak: {fuzz_cases} cases, sub-checks {ran}")
    print(f"fuzz soak clean: {fuzz_cases} cases, seed={seed}, {ran} in {fuzz_s:.3f} s [{card}]")

    t0 = time.perf_counter()
    uniq_counts = {}
    for p, c in zip(patterns, counts.tolist()):
        if c:
            uniq_counts[p] = c
    dump = out / "ids_hits.pcap"
    text = demo_output(ids_demo.main, [str(cap), str(pat_file), "udp"], MSM_DUMP=str(dump))
    alerts = alerts_by_signature(text, "ALERT packet=")
    check(alerts == uniq_counts, "ids_demo: alerts by signature differ from phase 3's counts")
    check(f"# {int(counts.sum())} matches in " in text, "ids_demo: total differs from phase 3's")
    hit_packets = {int(m) for m in re.findall(r"(?m)^ALERT packet=(\d+) ", text)}
    check(f"# wrote {len(hit_packets)} matching packets" in text and
          read_pcap(dump).num_packets == len(hit_packets), "ids_demo: MSM_DUMP")
    ids_alerts = sum(alerts.values())

    text = demo_output(flow_ids_demo.main, [])
    check(text.count("\nALERT flow") == 3 and text.count("STREAM-ALERT") == 3,
          f"flow_ids_demo (no arguments):\n{text}")
    flow_cap = demo_flow_capture(patterns, out / "demo_flows.pcap")
    text = demo_output(flow_ids_demo.main, [str(flow_cap), str(pat_file), "tcp"])
    pcap = read_pcap(flow_cap)
    fb = extract_flows(pcap, "tcp")
    m = Matcher(patterns, device=dev)
    check(m.explain()["pallas_kernel"] == "cuda-window", "the stand-in set takes the window kernel")
    flow_counts = m.count(fb.payloads, fb.lengths)
    want = {}
    for p, c in zip(patterns, flow_counts.tolist()):
        if c:
            want[p] = c
    check(alerts_by_signature(text, "ALERT flow") == want,
          "flow_ids_demo: alerts differ from the window kernel's counts over the flows")
    check(alerts_by_signature(text, "STREAM-ALERT") == want,
          "flow_ids_demo: streamed alerts differ from the window kernel's counts")
    missed = flow_counts - m.count_batch(extract_payloads(pcap, "tcp", strict=True))
    want_missed = {p: int(d) for p, d in zip(patterns, missed.tolist()) if d > 0}
    got_missed = {}
    for d, sig in re.findall(r"(?m)^# per-packet scanning would have MISSED (\d+) x (.*) \(split",
                             text):
        got_missed[ast.literal_eval(sig).encode("latin-1")] = int(d)
    check(want_missed and got_missed == want_missed, "flow_ids_demo: misses")
    demo_s = time.perf_counter() - t0
    shutil.rmtree(out)
    print(f"demos on the card: ids_demo {ids_alerts} alerts = phase 3's counts; flow_ids_demo "
          f"{sum(want.values())} alerts over {fb.num_flows} flows = the window kernel's, "
          f"{sum(want_missed.values())} missed per packet [{card}]")
    print(f"phase 14: {time.perf_counter() - t_phase:.3f} s wall (differential {diff_s:.3f} s, "
          f"fuzz soak {fuzz_s:.3f} s, demos {demo_s:.3f} s) [{card}]")
    by_record = {
        "window_count_totals": ["window_count_totals"],
        "window_count_rows": ["window_count_rows"],
        "window_count_totals_repeated": ["window_count_totals_repeated"],
        "window_count_halo": ["window_count_halo"],
        "table_filter_count_totals": ["table_count_totals", "filter_count_totals"],
        "table_filter_count_rows": ["table_count_rows", "filter_count_rows"],
        "shard_table_kernel_counts": ["shard_table_count_totals", "shard_filter_count_totals"],
        "shard_table_kernel_rows": ["shard_table_count_rows", "shard_filter_count_rows"],
        "mxu_count": ["mxu_count"], "window_find": ["window_find"],
        "ac_scan": ["ac_scan"], "kmp_scan": ["kmp_scan"],
    }
    return {name: stats[t]["cases"] for t, names in by_record.items() for name in names}


def audit_phase(dev, card: str) -> None:
    """Phase 15: compute-sanitizer's four tools over every kernel entry
    point (``tools/sanitize.py``, ``AUDIT_CASES`` random cases an entry
    point and tool, and its planted-overrun self-test), then the cases at
    the 2^31 position limit (``tools/edges.py``).  A sanitizer error, a
    failed tool run, an unreported self-test, an edge result that differs
    or a shape that is not refused fails the run; a sanitizer that is
    missing or refuses the card is printed as "not available", never as
    clean."""
    import torch

    from multithreading_string_matching_tpu_torch.tools import edges, sanitize

    t_phase = time.perf_counter()
    seed = int.from_bytes(os.urandom(4), "little")
    records = sanitize.audit(AUDIT_CASES, seed, timeout=AUDIT_TOOL_TIMEOUT_S)
    for rec in records:
        print(f"sanitize record: {json.dumps(rec)}")
    verdict = sanitize.verdict(records)
    check(verdict != 1, "compute-sanitizer: " + "; ".join(
        f"{r['tool']}: {r['status']}" for r in records))
    san_s = time.perf_counter() - t_phase
    print(f"sanitize: {'clean' if verdict == 0 else 'not available: nothing checked'} "
          f"in {san_s:.3f} s [{card}]")

    t0 = time.perf_counter()
    results = edges.run_edges(dev, log=lambda line: print(f"{line} [{card}]"))
    cases = [r for r in results if "result" in r]
    check(len(cases) == EDGE_CASES, f"edges: {len(cases)} cases, expected {EDGE_CASES}")
    check(results[-1]["bytes"] < EDGE_MEMORY_BYTES,
          f"edges: {results[-1]['bytes']} bytes of device memory at the peak")
    edge_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"edges clean: {len(cases)} cases ({sum(r['result'] == 'refused' for r in cases)} "
          f"refusals), {edge_s:.3f} s [{card}]")
    print(f"phase 15: {wall:.3f} s wall (sanitize {san_s:.3f} s, edges {edge_s:.3f} s) [{card}]")
    check(wall <= AUDIT_BUDGET_S, f"phase 15 took {wall:.1f} s, over its {AUDIT_BUDGET_S} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--distributed-rank"]:
        return distributed_rank(*sys.argv[2:])
    return run(torch.device("cuda"))


def run(dev) -> int:
    import torch

    from multithreading_string_matching_tpu_torch import cli
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
    from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
    from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
    from multithreading_string_matching_tpu_torch.ops import mxu as mx
    from multithreading_string_matching_tpu_torch.ops import scan as sc
    from multithreading_string_matching_tpu_torch.ops.table import filter_count, partition, table_count
    from multithreading_string_matching_tpu_torch.ops.window import (
        WindowProgram,
        count_matches_window_tiles,
        window_count,
    )

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libraries = (cw.LIBRARY, cw.FIND_LIBRARY, ct.LIBRARY, mx.LIBRARY, sc.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as ex:
        for f in [ex.submit(lib.load, verbose_ptxas=True) for lib in libraries]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.3f} s wall for the {len(libraries)} libraries")
    for lib in libraries:
        info = lib.build_info
        print(f"build: nvcc {info['seconds']:.3f} s -> {info['path']}")
        functions, spilling, fn = 0, [], None
        for line in str(info["log"]).splitlines():
            if "registers" in line or "Compiling entry" in line or "Performance Loss" in line:
                print(f"ptxas: {line.strip()}")
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            fn = entry[1] if entry else fn
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if found:
                functions += 1
                if int(found[1]) or int(found[2]):
                    spilling.append(f"{fn} ({found[1]} B stored, {found[2]} B loaded)")
        print(f"ptxas spills, {pathlib.Path(info['path']).name}, {functions} functions: "
              f"{'; '.join(spilling) or 'none'}")

    # -- 2. kernels against the plain version -----------------------------
    rng = np.random.default_rng(SEED)
    max_err = {k: 0 for k in (*cw.LAUNCHES, *ct.LAUNCHES, *sc.LAUNCHES)}

    def compare(kname, got, want, name):
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{kname} {name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err[kname] = max(max_err[kname], err)
        check(err == 0, f"{kname} disagrees with the plain version on {name}")

    cases = kernel_cases(rng) + probe_cases(np.random.default_rng(SEED + 2))
    for name, pats, payload, lengths in cases:
        wp = WindowProgram.build(pats)
        words, masks, lens = wp.tables(dev)
        p = torch.from_numpy(payload).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        want = window_count(words, masks, lens, p, ln)
        compare("window_count_totals", cw.window_count_totals(p, ln, words, masks, lens), want, name)
        compare("window_count_totals_repeated",
                cw.window_count_totals(p, ln, words, masks, lens, reps=3), 3 * want, name)
        compare("window_count_rows", cw.window_count_rows(p, ln, words, masks, lens),
                window_count(words, masks, lens, p, ln, per_packet=True), name)
        print(f"kernel check {name}: U={len(wp.unique_patterns)} K={wp.pat_words.shape[1]} "
              f"n={payload.shape[0]} L={payload.shape[1]} totals={int(want.sum()) if want.numel() else 0}: equal")
    for name, pats, payload, lengths in cases + table_cases(rng):
        p = torch.from_numpy(payload).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        found = 0
        for form, plain in (("table", table_count), ("filter", filter_count)):
            classes = partition(WindowProgram.build(pats), form == "filter")[0]
            for c in classes:
                tabs = c.tables(dev)
                want = plain(*tabs, p, ln, c.K)
                totals = getattr(ct, f"{form}_count_totals")
                compare(f"{form}_count_totals", totals(p, ln, *tabs, c.K), want, name)
                compare(f"{form}_count_totals_repeated", totals(p, ln, *tabs, c.K, reps=3),
                        3 * want, name)
                compare(f"{form}_count_rows", getattr(ct, f"{form}_count_rows")(p, ln, *tabs, c.K),
                        plain(*tabs, p, ln, c.K, per_row=True), name)
                found += int(want.sum()) if form == "filter" else 0
        print(f"table kernel check {name}: U={len(set(pats))} classes K="
              f"{[c.K for c in classes]} n={payload.shape[0]} L={payload.shape[1]} "
              f"totals={found}: equal")
    # Nine probe masks: the wrappers refuse them; the C entry point puts the
    # ninth on the wildcard chain and stays exact.
    nine = [0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF, 0xFF00, 0xFF0000, 0xFF000000, 0x00FF00FF,
            0xFFFF0000]
    keys = [int.from_bytes(q, "little") & m for q, m in zip(
        (b"abcd", b"bcda", b"cdab", b"dabc", b"aabb", b"abab", b"dddd", b"acac", b"cdcd"), nine)]
    w9, m9 = (torch.from_numpy(np.array(v, np.uint32).view(np.int32)[:, None].copy()).to(dev)
              for v in (keys, nine))
    l9 = torch.full((9,), 4, dtype=torch.int32, device=dev)
    p9, n9 = (torch.from_numpy(a).to(dev) for a in planted_tile(rng, [b"abcdabab"], 64, 200, b"abcd"))
    for fn in (lambda: cw.window_count_totals(p9, n9, w9, m9, l9),
               lambda: ct.table_count_totals(p9, n9, w9, m9, l9, 1)):
        try:
            fn()
        except ValueError as e:
            check("9 distinct" in str(e), f"nine probe masks refused with {e}")
        else:
            check(False, "a table of nine probe masks was not refused")
    out9 = torch.zeros(9, dtype=torch.int32, device=dev)
    cw.LIBRARY.call("msm_window_count_totals", p9.data_ptr(), n9.data_ptr(), w9.data_ptr(),
                    m9.data_ptr(), l9.data_ptr(), out9.data_ptr(), 64, 200, 9, 1, 1, 0,
                    torch.cuda.current_stream().cuda_stream)
    compare("window_count_totals", out9, window_count(w9, m9, l9, p9, n9), "nine probe masks")
    print(f"nine probe masks: refused by the wrappers; the C entry point = plain "
          f"({int(out9.sum())} matches)")
    scan_checks(dev, compare, sc)
    find_checks(dev, compare, cw)

    # -- 3. the main path -------------------------------------------------
    pat_file = pathlib.Path(__file__).resolve().parent / (
        "multithreading_string_matching_tpu_torch/data/strings_standin.txt"
    )
    patterns = load_patterns(pat_file)
    cap = capture_for(patterns, SEED, "mega")

    matcher = Matcher(patterns, device=dev)
    check(matcher.explain()["pallas_kernel"] == "cuda-window", f"stand-in set routed {matcher.explain()}")
    batch = extract_payloads(read_pcap(cap), "udp", pad_n_to=128, pad_len_to=8)
    head_p = batch.payloads[:ROWS_PER_PACKET_RUN]
    head_l = batch.lengths[:ROWS_PER_PACKET_RUN]
    prep = matcher.prepare_batch(batch, packed="auto")
    torch.cuda.synchronize()
    reset_launches(cw, ct)
    t0 = time.perf_counter()
    counts = matcher.count_pcap(cap, "udp")
    main_s = time.perf_counter() - t0
    per_row = matcher.count(head_p, head_l, per_packet=True)
    rep3 = matcher.kernels.count_tiles_repeated(prep.tiles, 3).cpu().numpy()
    launches = dict(cw.LAUNCHES)
    check(not any(ct.LAUNCHES.values()), f"the stand-in set launched table kernels {ct.LAUNCHES}")
    print(f"main path: count_pcap {main_s:.3f} s, launches {launches}, "
          f"{batch.num_packets} packets, {int(batch.valid.sum())} valid, "
          f"{batch.total_payload_bytes} payload bytes, {int(counts.sum())} matches")
    for k, v in launches.items():
        # window_count_halo is the flow path's kernel (phase 6), window_find
        # attribution's (phase 10).
        if k not in ("window_count_halo", "window_find", "window_find_rerun"):
            check(v > 0, f"{k} was not launched by the main path")
    check(counts.shape == (len(patterns),) and counts.dtype == np.int32,
          f"counts shape/dtype {counts.shape} {counts.dtype}")
    check(per_row.shape == (head_p.shape[0], len(patterns)), f"per-row shape {per_row.shape}")
    check(int(counts.sum()) > 0, "the main path counted no matches")
    check(np.array_equal(rep3[matcher.window.dup_map], 3 * counts), "repeats differ from 3 x totals")

    plain = Matcher(patterns, engine="window", device=dev)
    want_counts = plain.count_batch(batch)
    want_rows = plain.count(head_p, head_l, per_packet=True)
    check(np.array_equal(counts, want_counts), "main-path totals differ from the plain version")
    check(np.array_equal(per_row, want_rows), "main-path per-row counts differ from the plain version")
    check(np.array_equal(per_row.sum(axis=0), Matcher(patterns, device=dev).count(head_p, head_l)),
          "per-row column sums differ from totals")
    for r in range(200):
        text = head_p[r, : head_l[r]].tobytes()
        want = [overlapping(text, p) for p in patterns]
        check(list(per_row[r]) == want, f"row {r} differs from the pure-Python count")
    print("main path: totals and per-row counts equal the plain version; "
          "first 200 rows equal the pure-Python count")

    # -- 4. times ---------------------------------------------------------
    rows_prep = matcher.prepare(head_p, head_l)
    nbytes = prep.total_payload_bytes
    kern = matcher.kernels
    tot_ms = cuda_ms(lambda: kern.count_tiles(prep.tiles), SCAN_RUNS)
    tot_plain_ms = cuda_ms(lambda: count_matches_window_tiles(matcher.window, prep.tiles), PLAIN_RUNS)
    rows_ms = cuda_ms(lambda: kern.count_tiles_per_row(rows_prep.tiles), SCAN_RUNS)
    rows_plain_ms = cuda_ms(
        lambda: count_matches_window_tiles(matcher.window, rows_prep.tiles, per_packet=True),
        PLAIN_RUNS,
    )
    rep_ms = cuda_ms(lambda: kern.count_tiles_repeated(prep.tiles, 3), SCAN_RUNS)
    rep_plain_ms = cuda_ms(
        lambda: 3 * count_matches_window_tiles(matcher.window, prep.tiles, expand_duplicates=False),
        PLAIN_RUNS,
    )
    kdev = {"window_count_totals": device_ms(lambda: kern.count_tiles(prep.tiles)),
            "window_count_rows": device_ms(
                lambda: kern.count_tiles_per_row(rows_prep.tiles)),
            "window_count_totals_repeated": device_ms(
                lambda: kern.count_tiles_repeated(prep.tiles, 3))}
    widths = sorted({int(p.shape[1]) for p, _ in prep.tiles})
    print(f"resident tiles: {len(prep.tiles)} tiles, packed={prep.packed}, widths {widths}, "
          f"{nbytes} payload bytes")
    print(f"scan totals kernel: {tot_ms:.4f} ms = {nbytes / tot_ms * 1e3:.6e} payload B/s "
          f"(median of {SCAN_RUNS}) [{card}]")
    print(f"scan totals plain : {tot_plain_ms:.4f} ms = {nbytes / tot_plain_ms * 1e3:.6e} payload B/s "
          f"(median of {PLAIN_RUNS}) [{card}]")
    rbytes = rows_prep.total_payload_bytes
    print(f"per-row kernel    : {rows_ms:.4f} ms = {rbytes / rows_ms * 1e3:.6e} payload B/s "
          f"over {head_p.shape[0]} rows [{card}]")
    print(f"per-row plain     : {rows_plain_ms:.4f} ms = {rbytes / rows_plain_ms * 1e3:.6e} payload B/s "
          f"[{card}]")
    print(f"repeats=3 kernel  : {rep_ms:.4f} ms = {3 * nbytes / rep_ms * 1e3:.6e} payload B/s "
          f"(median of {SCAN_RUNS}); plain x3: {rep_plain_ms:.4f} ms [{card}]")
    print(f"device time per pass, queued alone (median of {DEVICE_RUNS}): "
          + ", ".join(f"{k} {fmt_ms(v)}" for k, v in kdev.items()) + f" [{card}]")

    # Where one count_pcap's wall time goes, phase by phase.
    phases = {}
    t0 = time.perf_counter()
    pc = read_pcap(cap)
    phases["ingest"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = extract_payloads(pc, "udp", pad_n_to=128, pad_len_to=8)
    phases["extract"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = matcher.prepare_batch(b, packed="auto")
    torch.cuda.synchronize()
    phases["stage"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    matcher.count_prepared(staged)
    phases["scan"] = time.perf_counter() - t0
    print("count_pcap phases: " + ", ".join(f"{k} {v:.4f} s" for k, v in phases.items())
          + f" [{card}]")

    os.environ["MSM_DEVICE"] = dev.type
    serial_wall(cli, cap, pat_file, patterns, counts, card)

    # -- 5. the large-rule-set path ---------------------------------------
    rules = rule_set(SEED, RULES)
    check(len(rules) == RULES and not any(0 in r for r in rules), "rule set")
    cap2 = capture_for(rules, 2, "rules")
    big = Matcher(rules, device=dev)
    ex = big.explain()
    print(f"rule set: {ex['unique_patterns']} patterns of {min(map(len, rules))}-"
          f"{max(map(len, rules))} bytes, {ex['total_pattern_words']} words, classes "
          f"{[(c.K, c.num) for c in big.kernels.classes]} -> {ex['pallas_kernel']}")
    check(ex["pallas_kernel"] == "table+filter" and isinstance(big.kernels, ct.CudaTableMatcher)
          and big.kernels.filtered, f"the rule set routed {ex}")
    batch2 = extract_payloads(read_pcap(cap2), "udp", pad_n_to=128, pad_len_to=8)
    head2_p = batch2.payloads[:ROWS_PER_PACKET_RUN]
    head2_l = batch2.lengths[:ROWS_PER_PACKET_RUN]
    prep2 = big.prepare_batch(batch2, packed="auto")
    rows_prep2 = big.prepare(head2_p, head2_l)
    nbytes2 = prep2.total_payload_bytes
    dup2 = big.window.dup_map

    def drive(m):
        """The main path with the launch counters reset just before."""
        torch.cuda.synchronize()
        reset_launches(cw, ct)
        t0 = time.perf_counter()
        c = m.count_pcap(cap2, "udp")
        wall = time.perf_counter() - t0
        r = m.count(head2_p, head2_l, per_packet=True)
        rep = m.kernels.count_tiles_repeated(prep2.tiles, 3).cpu().numpy()
        got = {**cw.LAUNCHES, **ct.LAUNCHES}
        print(f"rule-set path ({m.explain()['pallas_kernel']}): count_pcap {wall:.3f} s, "
              f"launches {got}, {batch2.num_packets} packets, {batch2.total_payload_bytes} "
              f"payload bytes, {int(c.sum())} matches")
        check(c.shape == (RULES,) and c.dtype == np.int32, f"counts {c.shape} {c.dtype}")
        check(r.shape == (head2_p.shape[0], RULES), f"per-row shape {r.shape}")
        check(int(c.sum()) > 0, "the rule-set path counted no matches")
        check(np.array_equal(rep[dup2], 3 * c), "repeats differ from 3 x totals")
        check(not any(v for k, v in got.items() if k.startswith("window")),
              "the rule-set path launched window kernels")
        return c, r, got

    big_counts, big_rows, filt_launches = drive(big)
    for k in ("filter_count_totals", "filter_count_rows", "filter_count_totals_repeated"):
        check(filt_launches[k] > 0, f"{k} was not launched by the rule-set path")
    os.environ["MSM_PALLAS_FILTER"] = "0"
    tab = Matcher(rules, device=dev)
    check(tab.explain()["pallas_kernel"] == "table" and not tab.kernels.filtered,
          f"MSM_PALLAS_FILTER=0 routed {tab.explain()}")
    tab_counts, tab_rows, tab_launches = drive(tab)
    del os.environ["MSM_PALLAS_FILTER"]
    for k in ("table_count_totals", "table_count_rows", "table_count_totals_repeated"):
        check(tab_launches[k] > 0, f"{k} was not launched by the rule-set path")
    check(np.array_equal(tab_counts, big_counts) and np.array_equal(tab_rows, big_rows),
          "table and table+filter counts differ")

    win = cw.CudaWindowMatcher(big.window, dev)
    check(np.array_equal(win.count_tiles(prep2.tiles).cpu().numpy(), big_counts),
          "rule-set totals differ from the window kernel's")

    def plain_tiles(filtered, tiles, per_row=False):
        """The plain versions over every class of every tile, build order."""
        plain = filter_count if filtered else table_count
        classes, inv, _ = partition(big.window, filtered)
        tabs = [c.tables(dev) for c in classes]
        inv = torch.from_numpy(inv).to(dev)
        return [torch.cat([plain(*t, p, l, c.K, per_row=per_row) for c, t in zip(classes, tabs)],
                          dim=-1)[..., inv] for p, l in tiles]

    plain_ms, plain_rows_ms = {}, {}
    for form, m in (("filter", big), ("table", tab)):
        outs, plain_ms[form] = timed_once(lambda: plain_tiles(form == "filter", prep2.tiles))
        compare(f"{form}_count_totals", m.kernels.count_tiles(prep2.tiles, expand_duplicates=False),
                torch.stack(outs).sum(dim=0, dtype=torch.int32), "rule-set capture")
        outs, plain_rows_ms[form] = timed_once(
            lambda: plain_tiles(form == "filter", rows_prep2.tiles, per_row=True))
        for got, want in zip(m.kernels.count_tiles_per_row(rows_prep2.tiles, expand_duplicates=False),
                             outs):
            compare(f"{form}_count_rows", got, want, "rule-set capture rows")
    check(np.array_equal(big_rows.sum(axis=0), big.count(head2_p, head2_l)),
          "rule-set per-row column sums differ from totals")
    for r in range(200):
        text = head2_p[r, : head2_l[r]].tobytes()
        check(list(big_rows[r]) == [overlapping(text, p) for p in rules],
              f"rule-set row {r} differs from the pure-Python count")
    print("rule-set path: table+filter = table = window kernel = plain version (totals and "
          "per-row); first 200 rows equal the pure-Python count")

    filt_ms = cuda_ms(lambda: big.kernels.count_tiles(prep2.tiles), SCAN_RUNS)
    tab_ms = cuda_ms(lambda: tab.kernels.count_tiles(prep2.tiles), SCAN_RUNS)
    win_ms = cuda_ms(lambda: win.count_tiles(prep2.tiles), SCAN_RUNS)
    filt_rows_ms = cuda_ms(lambda: big.kernels.count_tiles_per_row(rows_prep2.tiles), SCAN_RUNS)
    tab_rows_ms = cuda_ms(lambda: tab.kernels.count_tiles_per_row(rows_prep2.tiles), SCAN_RUNS)
    kdev.update({
        "filter_count_totals": device_ms(lambda: big.kernels.count_tiles(prep2.tiles)),
        "table_count_totals": device_ms(lambda: tab.kernels.count_tiles(prep2.tiles)),
        "filter_count_rows": device_ms(
            lambda: big.kernels.count_tiles_per_row(rows_prep2.tiles)),
        "table_count_rows": device_ms(
            lambda: tab.kernels.count_tiles_per_row(rows_prep2.tiles)),
    })
    print(f"device time per pass, queued alone (median of {DEVICE_RUNS}): "
          + ", ".join(f"{k} {fmt_ms(kdev[k])}" for k in ("filter_count_totals", "table_count_totals",
                                                         "filter_count_rows", "table_count_rows"))
          + f" [{card}]")
    rbytes2 = rows_prep2.total_payload_bytes
    print(f"rule-set resident tiles: {len(prep2.tiles)} tiles, packed={prep2.packed}, "
          f"{nbytes2} payload bytes")
    for label, ms, b in (
        ("table+filter kernel", filt_ms, nbytes2), ("table kernel", tab_ms, nbytes2),
        ("window kernel", win_ms, nbytes2),
        ("filter plain (1 run)", plain_ms["filter"], nbytes2),
        ("table plain (1 run)", plain_ms["table"], nbytes2),
        ("filter rows kernel", filt_rows_ms, rbytes2), ("table rows kernel", tab_rows_ms, rbytes2),
        ("filter rows plain (1 run)", plain_rows_ms["filter"], rbytes2),
        ("table rows plain (1 run)", plain_rows_ms["table"], rbytes2),
    ):
        print(f"rule set {label}: {ms:.4f} ms = {b / ms * 1e3:.6e} payload B/s [{card}]")

    # The per-position lookup does not grow with U: the filter kernels of
    # the 87-pattern stand-in set and of the 3,072 rules over the same tiles.
    std_filter = ct.CudaTableMatcher(matcher.window, dev, filtered=True)
    check(torch.equal(std_filter.count_tiles(prep2.tiles), matcher.kernels.count_tiles(prep2.tiles)),
          "stand-in filter kernels differ from the window kernel over the rule-set tiles")
    std_filt_ms = cuda_ms(lambda: std_filter.count_tiles(prep2.tiles), SCAN_RUNS)
    std_filt_dev = device_ms(lambda: std_filter.count_tiles(prep2.tiles))
    print(f"filter kernels over the rule-set capture's {len(prep2.tiles)} tiles: "
          f"{std_filter.num_unique} patterns ({len(std_filter.classes)} classes) "
          f"{std_filt_ms:.4f} ms, {RULES} rules ({len(big.kernels.classes)} classes) "
          f"{filt_ms:.4f} ms (medians of {SCAN_RUNS}); device time "
          f"{fmt_ms(std_filt_dev)} and {fmt_ms(kdev['filter_count_totals'])} [{card}]")

    rs = [b"rs%06d" % i for i in range(RULES)]
    mrs = Matcher(rs, device=dev)
    check(mrs.explain()["pallas_kernel"] == "table+filter", f"rs set routed {mrs.explain()}")
    prs = mrs.prepare_batch(batch, packed="auto")
    rs_tab = ct.CudaTableMatcher(mrs.window, dev)
    rs_win = cw.CudaWindowMatcher(mrs.window, dev)
    rs_counts = mrs.kernels.count_tiles(prs.tiles)
    check(torch.equal(rs_counts, rs_tab.count_tiles(prs.tiles))
          and torch.equal(rs_counts, rs_win.count_tiles(prs.tiles)), "rs set kernels disagree")
    rs_ms = {name: cuda_ms(lambda: k.count_tiles(prs.tiles), SCAN_RUNS)
             for name, k in (("table+filter", mrs.kernels), ("table", rs_tab), ("window", rs_win))}
    for name, ms in rs_ms.items():
        print(f"rs%06d x {RULES} over the phase-3 capture, {name} kernel: {ms:.4f} ms = "
              f"{prs.total_payload_bytes / ms * 1e3:.6e} payload B/s "
              f"({int(rs_counts.sum())} matches) [{card}]")

    rules_file = pathlib.Path(tempfile.gettempdir()) / f"msm_torch_rules_{os.getpid()}.txt"
    rules_file.write_bytes(b"\n".join(rules) + b"\n")
    check(load_patterns(rules_file) == rules, "the rule file does not load back")
    serial_wall(cli, cap2, rules_file, rules, big_counts, card)

    # Bounds of the phase 3-5 records, from these runs' inputs: the class
    # route makes one pass (map test and lookups) per position per class
    # launch, a shard block one pass with the probe column of the whole set.
    U1, U2, n_head = matcher.kernels.num_unique, big.kernels.num_unique, head2_p.shape[0]
    w1, w1r = position_words(prep.tiles), position_words(rows_prep.tiles)
    bounds = {
        "window_count_totals": window_bound(matcher.window, w1, nbytes, U1,
                                            label="window_count_totals"),
        "window_count_rows": window_bound(matcher.window, w1r, rbytes,
                                          head_p.shape[0] * U1, label="window_count_rows"),
        "window_count_totals_repeated": window_bound(matcher.window, w1, nbytes, U1,
                                                     reps=3, label="window_count_totals reps=3"),
    }
    del w1, w1r
    w2, w2r = position_words(prep2.tiles), position_words(rows_prep2.tiles)
    head_bounds = {}
    for form in ("filter", "table"):
        filtered = form == "filter"
        cols = [(c.words[:, c.K if filtered else 0], c.masks[:, c.K if filtered else 0])
                for c in partition(big.window, filtered)[0]]
        whole = tuple(np.concatenate(parts) for parts in zip(*cols))
        full, head = probe_work(big.window, w2, filtered), probe_work(big.window, w2r, filtered)
        bounds[f"{form}_count_totals"] = probe_bound(
            f"{form}_count_totals", full, nbytes2, [lookups(w2, *c) for c in cols],
            nbytes2 + 4 * U2)
        per_class = [lookups(w2r, *c) for c in cols]
        bounds[f"{form}_count_rows"] = probe_bound(f"{form}_count_rows", head, rbytes2,
                                                   per_class, rbytes2 + 4 * n_head * U2)
        block = [lookups(w2r, *whole)]
        head_bounds[(form, "totals")] = probe_bound(f"shard_{form}_count_totals", head, rbytes2,
                                                    block, rbytes2 + 4 * U2)
        head_bounds[(form, "rows")] = probe_bound(f"shard_{form}_count_rows", head, rbytes2,
                                                  block, rbytes2 + 4 * n_head * U2)
    del w2, w2r

    # -- 6. the flow path ---------------------------------------------------
    halo_record, flow_counts = flow_phase(dev, card, patterns, pat_file, cw, ct)

    # -- 7. the sharded path --------------------------------------------------
    shard_records = shard_phase(dev, card, cw, ct, big, rules_file, cap2, batch2, big_counts,
                                big_rows, filt_ms, cap, pat_file, patterns, counts, head_bounds)

    # -- 8. the matrix-unit measurement path ----------------------------------
    mxu_record = mxu_phase(dev, card, mx, matcher, prep, counts, head_p, head_l)

    # -- 9. the streamed packet path ------------------------------------------
    stream_launches = stream_phase(dev, card, cw, ct, matcher, patterns, pat_file, cap, counts,
                                   big, rules, cap2, big_counts)

    # -- 10. match attribution ------------------------------------------------
    find_record = attribution_phase(dev, card, cw, ct, matcher, pat_file, cap, batch, counts, big,
                                    rules_file, cap2, batch2, big_counts,
                                    flow_capture(patterns, SEED), flow_counts)
    find_record["max_abs_err"] = max(find_record["max_abs_err"], max_err["window_find"])
    # Rows 1 and 4 build their probe table with the function window_find
    # shares (probe.cuh build_table): their device times beside the earlier
    # ones of PERF.md's kernel table (NVIDIA H100 80GB HBM3, 700.00 W).
    print(f"shared table build: window_count_totals device {fmt_ms(kdev['window_count_totals'])} "
          f"(earlier: 0.9010 ms), window_count_halo device {fmt_ms(halo_record['device_ms'])} "
          f"(earlier: 0.1135 ms) [{card}]")

    # -- 11. the DFA scans ------------------------------------------------------
    scan_records = dfa_phase(dev, card, sc, cw, ct, matcher, patterns, pat_file, cap, batch,
                             counts, per_row, prep, rules, big, cap2, batch2, big_counts,
                             big_rows, prep2, flow_capture(patterns, SEED), flow_counts,
                             compare, max_err)

    # -- 12. the live path and the new inputs -------------------------------------
    live_launches = live_phase(dev, card, cli, cw, ct, sc, matcher, patterns, pat_file, cap,
                               counts, rules, big, rules_file, cap2, big_counts,
                               flow_capture(patterns, SEED), flow_counts, compare)

    # -- 13. the multi-process path -------------------------------------------------
    distributed_launches = distributed_phase(dev, card, cli, cw, ct, sc, matcher, patterns,
                                             pat_file, cap, counts, big, rules, rules_file, cap2,
                                             big_counts, compare)
    rules_file.unlink()

    # -- 14. the verification harnesses and the demos -------------------------------
    soak_cases = soak_phase(dev, card, cap, pat_file, patterns, counts)

    # -- 15. the audits: compute-sanitizer and the 2^31 edges -----------------------
    audit_phase(dev, card)

    src = "multithreading_string_matching_tpu_torch/csrc/window_count.cu"
    ref = "multithreading_string_matching_tpu/ops/pallas_window.py"
    tsrc = "multithreading_string_matching_tpu_torch/csrc/table_count.cu"
    tref = "multithreading_string_matching_tpu/ops/pallas_table.py"
    record = {"kernels": [
        {"name": "window_count_totals", "route": "cuda", "source": src,
         "replaces": f"{ref}:402", "launches": launches["window_count_totals"],
         "max_abs_err": max_err["window_count_totals"], "ms": tot_ms, "plain_ms": tot_plain_ms,
         "device_ms": kdev["window_count_totals"],
         "library_ms": None, **bounds["window_count_totals"]},
        {"name": "window_count_rows", "route": "cuda", "source": src,
         "replaces": f"{ref}:450", "launches": launches["window_count_rows"],
         "max_abs_err": max_err["window_count_rows"], "ms": rows_ms, "plain_ms": rows_plain_ms,
         "device_ms": kdev["window_count_rows"],
         "library_ms": None, **bounds["window_count_rows"]},
        {"name": "window_count_totals_repeated", "route": "cuda", "source": src,
         "replaces": f"{ref}:417", "launches": launches["window_count_totals_repeated"],
         "max_abs_err": max_err["window_count_totals_repeated"], "ms": rep_ms,
         "plain_ms": rep_plain_ms,
         "device_ms": kdev["window_count_totals_repeated"],
         "library_ms": None, **bounds["window_count_totals_repeated"]},
        {"name": "table_count_totals", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:644", "launches": tab_launches["table_count_totals"],
         "max_abs_err": max(max_err["table_count_totals"], max_err["table_count_totals_repeated"]),
         "ms": tab_ms, "plain_ms": plain_ms["table"],
         "device_ms": kdev["table_count_totals"],
         "library_ms": None, **bounds["table_count_totals"]},
        {"name": "table_count_rows", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:704", "launches": tab_launches["table_count_rows"],
         "max_abs_err": max_err["table_count_rows"], "ms": tab_rows_ms,
         "plain_ms": plain_rows_ms["table"],
         "device_ms": kdev["table_count_rows"],
         "library_ms": None, **bounds["table_count_rows"]},
        {"name": "filter_count_totals", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:644", "launches": filt_launches["filter_count_totals"],
         "max_abs_err": max(max_err["filter_count_totals"], max_err["filter_count_totals_repeated"]),
         "ms": filt_ms, "plain_ms": plain_ms["filter"],
         "device_ms": kdev["filter_count_totals"],
         "library_ms": None, **bounds["filter_count_totals"]},
        {"name": "filter_count_rows", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:704", "launches": filt_launches["filter_count_rows"],
         "max_abs_err": max_err["filter_count_rows"], "ms": filt_rows_ms,
         "plain_ms": plain_rows_ms["filter"],
         "device_ms": kdev["filter_count_rows"],
         "library_ms": None, **bounds["filter_count_rows"]},
        halo_record,
        *shard_records,
        mxu_record,
        find_record,
        *scan_records,
    ]}
    # Launches of one streamed pass (phase 9), of phase 12's live runs and of
    # phase 13's ranks beside the records' own; later phases' comparisons
    # join max_abs_err.
    for rec in record["kernels"]:
        if rec["name"] in stream_launches:
            rec["stream_launches"] = stream_launches[rec["name"]]
        if rec["name"] in live_launches:
            rec["live_launches"] = live_launches[rec["name"]]
        if rec["name"] in distributed_launches:
            rec["distributed_launches"] = distributed_launches[rec["name"]]
        rec["soak_cases"] = soak_cases[rec["name"]]
        rec["max_abs_err"] = max(rec["max_abs_err"], max_err.get(rec["name"], 0))
    print(f"chip_smoke: {time.perf_counter() - t_start:.3f} s")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
