#!/usr/bin/env python3
"""Drive the torch port's main path once on one NVIDIA GPU, and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Print the card's name and power limit, build the CUDA kernels from
   ``multithreading_string_matching_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together) and print the build times.
2. Hold each kernel equal to its plain PyTorch version on the same CUDA
   tensors: the window kernels (``window_count_totals``, also with
   ``reps=3``, and ``window_count_rows``) and the table and filter kernels
   (``table_count_*``, ``filter_count_*``, totals also with ``reps=3``) on
   ragged widths, NUL patterns over rows that are not zero-filled, zero-row
   and zero-width tiles, patterns longer than the row, multi-segment rows,
   3072 ``rs%06d`` patterns (chunked shared-memory tables), a mixed set of
   word-count classes 1..8, a class of one pattern, a shared-prefix set and
   filter words present without their patterns.
3. The main path at a real size: a seeded 100,000-packet capture of
   ~1 KB payloads (~100 MB) with the 97-token stand-in pattern set, counted
   by ``Matcher(device="cuda").count_pcap``, per packet on its first 8,192
   rows and with ``count_tiles_repeated`` on its staged tiles, with the
   kernels' launch counters reset just before.  Counts must equal the plain
   version's on the card and, on the first rows, a pure-Python count.
4. Times, with the card's name and power limit beside each: the scan rate
   of the resident prepared tiles (median of 20 runs, CUDA events), the
   plain version's rate at the same shapes, and the wall time of the full
   ``serial`` path.
5. The large-rule-set path: 3,072 seeded patterns of 4-32 bytes over a
   second seeded 100,000-packet capture.  ``Matcher`` must choose the
   filter kernels (``explain()``), and ``count_pcap``, per-packet counts and
   repeats must launch them; with ``MSM_PALLAS_FILTER=0`` the table kernels.
   Totals equal the window kernel's, the plain version's and, on the first
   rows, a pure-Python count.  Times: table+filter, table and window kernels
   on the resident tiles, the plain versions, the bench's 3,072 ``rs%06d``
   set over the phase-3 capture, and ``serial`` with the large file.
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
   blocks.  ``match --sharded --shard-axis packets`` on the phase-3 files
   gives phase 3's counts through ``window_count_totals``; a sharded flow
   stream on a 2-shard mesh equals the unsharded one through
   ``window_count_halo``.  Times: the shard kernels on the resident
   [N, L_max] tile and on 8,192 rows against the class route and the plain
   versions, ``match --sharded --shard-axis patterns`` against unsharded
   ``match`` (median of 3), and the device busy share of one
   pattern-sharded count (torch.profiler).
8. The matrix-unit measurement path (``tools/mxu_match.py``, the port of
   ``bench/mxu_match.py``): ``mxu_count`` (int8 tensor cores) equals its
   plain version on ragged widths and row counts, U = 1, 127, 128, 129 and
   3,072, 1-byte patterns and m_max = 99, a packed tile, a zero-row tile and
   reps = 3.  With the launch counter reset just before, the tool's three
   pattern sets over its corpus and the stand-in set over phase 3's resident
   tiles must launch ``mxu_count`` once per tile and call, and give the
   table kernel's totals, phase 3's counts and, on the first rows, a
   pure-Python count.  Times: the kernel over phase 3's tiles (median of
   20) against the plain version (1 run), the tool's rows (mxu and table
   rates per set), ``torch._int_mm`` on the score product alone for the
   first 1,024 rows of one tile beside the kernel on the same rows, and
   the mxu, table and window kernels over phase 3's tiles alternated over
   ``ALT_ROUNDS`` rounds.

The line before the last is one JSON object with a record per kernel, each
with its bound (``bound_ms``: the larger of its bytes over 3.35 TB/s and its
operations over the peak rate for their type, ``bound_by`` which) and, where
one PyTorch call computes a yardstick, ``library_ms``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from multithreading_string_matching_tpu_torch.utils.timing import card_line, cuda_ms

SEED = 1
MAIN_PACKETS = 100_000
ROWS_PER_PACKET_RUN = 8192
SCAN_RUNS = 20
PLAIN_RUNS = 5
SERIAL_RUNS = 3
ALT_ROUNDS = 6
RULES = 3072
ALNUM = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def window_bound(wp, tiles, nbytes: int, out_ints: int, reps: int = 1) -> dict:
    """Window kernels over ``tiles`` (``nbytes`` real positions), ``reps``
    times: a pattern's chain stops at its first mismatched word, so the
    int32 operations are those of the table kernels' word-0 probe and
    chain (:func:`compare_ops`)."""
    ops = reps * compare_ops(wp, tiles, nbytes, filtered=False)
    return bound(nbytes + 4 * out_ints, ops, int32_ops_per_s())


def probe_hits(tiles, words: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Per pattern, the real payload positions of ``tiles`` whose 4-byte
    little-endian word (bytes past the row's width read as 0) equals its
    probe word under its mask.  A tile is ``(payload, lengths)``, its
    positions ``[0, lengths[r])``, or ``(payload, lengths, starts)``, its
    positions ``[starts[r], lengths[r])``."""
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
    w = torch.sort(torch.cat(vals)).values
    hits = np.zeros(len(words), np.int64)
    full = masks.astype(np.uint32) == 0xFFFFFFFF
    fw = torch.from_numpy(words[full].astype(np.int64)).to(w.device)
    hits[full] = (torch.searchsorted(w, fw, right=True) - torch.searchsorted(w, fw)).cpu().numpy()
    for u in np.flatnonzero(~full):
        hits[u] = int(((w & int(masks[u])) == int(words[u])).sum())
    return hits


def compare_ops(wp, tiles, nbytes: int, filtered: bool) -> int:
    """int32 operations of the compare kernels over ``tiles`` (``nbytes``
    real positions): one probe (a masked 32-bit compare, 2 ops) per (real
    position, pattern), then the verify chain on the probe hits these
    inputs have: the K words of the pattern after a filter-word hit, the
    K - 1 words after word 0 without the filter (the table and window
    kernels)."""
    from multithreading_string_matching_tpu_torch.ops.table import filter_words

    K = -(-wp.pat_lens.astype(np.int64) // 4)
    if filtered:
        hits = probe_hits(tiles, *filter_words(wp))
        chain = 2 * int((hits * K).sum())
    else:
        hits = probe_hits(tiles, wp.pat_words[:, 0], wp.pat_masks[:, 0])
        chain = 2 * int((hits * (K - 1)).sum())
    ops = 2 * nbytes * len(K) + chain
    print(f"{'filter-word' if filtered else 'word-0'} probe over {nbytes} B, {len(K)} patterns: "
          f"{int(hits.sum())} hits, {ops:.6e} int32 ops")
    return ops


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


def table_cases(rng):
    """(name, patterns, payload, lengths) cases aimed at the table kernels;
    every row holds a planted pattern where it fits."""

    def tile(pats, n, L, alphabet):
        letters = np.frombuffer(alphabet, np.uint8)
        p = letters[rng.integers(0, len(letters), size=(n, L))]
        for r in range(n):
            pat = pats[r % len(pats)]
            if len(pat) <= L:
                o = int(rng.integers(0, L - len(pat) + 1))
                p[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
        return p, rng.integers(0, L + 1, size=n).astype(np.int32)

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
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["serial", str(cap), str(pat_file), "udp"])
        serial_s.append(time.perf_counter() - t0)
        check(rc == 0, f"serial exited {rc}")
        reported = {}
        for line in out.getvalue().splitlines()[1:-1]:
            name, _, rest = line.rpartition(": ")
            reported.setdefault(name, int(rest.split()[0]))
        want = {p.decode("latin-1"): int(c) for p, c in zip(patterns, counts) if c}
        check(reported == want, f"serial report differs from the main-path counts ({pat_file})")
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
            "plain_totals": plain_t, "plain_rows": plain_r,
        }
        print(f"shard {form} kernels (K={plan.K}, S={plan.S}) = plain on {ROWS_PER_PACKET_RUN} "
              f"rows: totals {int(want_t.sum())}")
    # Five blocks with padded slots (C=615, S=640): kernels = plain per row.
    plan5 = build_pattern_shards(big.window, 5, filtered=True)
    kern5 = ct.ShardTableKernel(plan5.K, plan5.S, plan5.use_fit, True, dev)
    for d in range(5):
        tabs = block(plan5, d)
        want_r = filter_count(*tabs, hp, hl, plan5.K, per_row=True)
        compare("shard_filter_count_rows", kern5.rows(*tabs, hp, hl), want_r, f"block {d} of 5")
        compare("shard_filter_count_totals", kern5.counts(*tabs, hp, hl),
                want_r.sum(dim=0, dtype=torch.int32), f"block {d} of 5")
        check(not want_r[:, plan5.valid(d):].any(), f"padded slots of block {d} counted")
    print(f"shard kernels = plain on 5 padded blocks (C={plan5.C}, S={plan5.S})")
    class_same_ms = cuda_ms(lambda: big.kernels.count_tiles([(fp, fl)]), SCAN_RUNS)
    nb = int(batch2.total_payload_bytes)
    for form, t in times.items():
        print(f"shard {form} totals kernel, resident tile {tuple(fp.shape)}: {t['full']:.4f} ms = "
              f"{nb / t['full'] * 1e3:.6e} payload B/s (median of {SCAN_RUNS}) [{card}]")
    print(f"class-route filter kernels, same tile: {class_same_ms:.4f} ms; on phase 5's "
          f"bucketed tiles: {class_filter_ms:.4f} ms [{card}]")
    for form, t in times.items():
        print(f"shard {form} on {ROWS_PER_PACKET_RUN} rows: totals {t['totals']:.4f} ms, rows "
              f"{t['rows']:.4f} ms (median of {SCAN_RUNS}); plain totals {t['plain_totals']:.4f} "
              f"ms, rows {t['plain_rows']:.4f} ms (1 run) [{card}]")

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
             "plain_ms": times[form][f"plain_{kind}"], "library_ms": None,
             **head_bounds[(form, kind)]}
            for form in ("filter", "table") for kind, line in (("totals", 474), ("rows", 501))]


def flow_phase(dev, card: str, patterns, pat_file, cw, ct) -> dict:
    """Phase 6; returns the kernel record entry of ``window_count_halo``."""
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
    plain_ms = cuda_ms(lambda: window_count_halo_plain(x, eff, ms, H, (words, masks, lens)),
                       PLAIN_RUNS)
    tile_bytes = int(eff.clamp(min=0).sum())
    positions = int((eff - ms.clamp(min=0)).clamp(min=0).sum())  # those the kernel scans
    print(f"halo kernel, largest round tile {tuple(x.shape)} ({tile_bytes} valid bytes incl. "
          f"halos): {halo_ms:.4f} ms = {tile_bytes / halo_ms * 1e3:.6e} B/s (median of "
          f"{SCAN_RUNS}); plain {plain_ms:.4f} ms (median of {PLAIN_RUNS}) [{card}]")

    for flags in (["--flows", "--stream"], ["--flows"]):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["match", "--pcap", str(cap), "--patterns", str(pat_file), "--mode",
                           "tcp", "--json", *flags])
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"match {' '.join(flags)} exited {rc}")
        blob = json.loads(out.getvalue().splitlines()[-1])
        check(blob["counts"] == counts.tolist() and blob["flows"] == FLOWS,
              f"match {' '.join(flags)} counts differ")
        print(f"match {' '.join(flags)} --json: {cli_s:.4f} s wall, phases {blob['phases']}, "
              f"execution {blob['execution'].get('flow_rounds', blob['execution'].get('pallas_kernel'))} "
              f"[{card}]")

    return {"name": "window_count_halo", "route": "cuda",
            "source": "multithreading_string_matching_tpu_torch/csrc/window_count.cu",
            "replaces": "multithreading_string_matching_tpu/ops/pallas_window.py:473",
            "launches": launches["window_count_halo"], "max_abs_err": max_err,
            "ms": halo_ms, "plain_ms": plain_ms, "library_ms": None,
            **window_bound(kern.wp, [(x, eff, ms.clamp(min=0))], positions, kern.num_unique)}


def mxu_cases(rng, dev):
    """(name, patterns, payload uint8[n, L] on ``dev``) cases for the
    tensor-core kernel; rows hold planted patterns and are zero past random
    lengths, as staged tiles are."""
    import torch

    from multithreading_string_matching_tpu_torch.api import Matcher

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

    x_ = [b"x%03d" % i for i in range(129)]
    long_ = [b"a", b"ab" * 49 + b"a", b"b" * 99, b"ba", b"b"]
    rs = [b"rs%06d" % i for i in range(RULES)]
    cases = [
        ("width-1000-rows-37", [b"GET /", b"a", b"Host: "], *tile([b"GET /", b"a", b"Host: "],
                                                                  37, 1000, ALNUM + b" /:")),
        ("width-13-rows-9", [b"ab", b"b", b"abcdefgh"], *tile([b"ab", b"b", b"abcdefgh"], 9, 13, b"abc")),
        ("u1-width-300", [b"abc"], *tile([b"abc"], 50, 300, b"abc")),
        ("u127", x_[:127], *tile(x_[:127], 41, 260, b"x0123")),
        ("u128", x_[:128], *tile(x_[:128], 41, 260, b"x0123")),
        ("u129", x_, *tile(x_, 41, 260, b"x0123")),
        ("u3072", rs, *tile(rs, 97, 517, b"rs0123")),
        ("one-byte-and-m-max-99", long_, *tile(long_, 23, 777, b"ab")),
        ("zero-rows", [b"ab"], np.zeros((0, 64), np.uint8), np.zeros(0, np.int32)),
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
        compare(mx.mxu_count(x, P, tgt), want, name)
        compare(mx.mxu_count(x, P, tgt, reps=3), 3 * want, f"{name}, reps=3")
        print(f"mxu kernel check {name}: U={len(pats)} m_max={m_max} n={x.shape[0]} "
              f"L={x.shape[1]} totals={int(want.sum())}: equal (also reps=3)")

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
    P, tgt = mxm._P, mxm._tgt
    plain_tiles = []

    def plain_all():
        plain_tiles[:] = [mx.mxu_count_plain(P, tgt, mxm.m_max, p) for p, _ in prep.tiles]

    _, plain_ms = timed_once(plain_all)
    for i, ((p, _), want) in enumerate(zip(prep.tiles, plain_tiles)):
        compare(mx.mxu_count(p, P, tgt), want, f"phase 3 tile {i}")
    print(f"mxu kernel, stand-in set over phase 3's resident tiles: {ms:.4f} ms = "
          f"{nbytes / ms * 1e3:.6e} payload B/s (median of {SCAN_RUNS}); plain {plain_ms:.4f} ms "
          f"(1 run), equal on every tile [{card}]")
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
    return {"name": "mxu_count", "route": "cuda",
            "source": "multithreading_string_matching_tpu_torch/csrc/mxu_count.cu",
            "replaces": "bench/mxu_match.py:125", "launches": launches["mxu_count"],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_covers": "torch._int_mm score product only, first 1,024 rows of tile 0",
            "ms_library_rows": rows_ms,
            **bound(nbytes + 4 * mxm.num_unique, ops, mxu_match.INT8_TENSOR_OPS_PER_S)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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
    from multithreading_string_matching_tpu_torch.ops.table import filter_count, partition, table_count
    from multithreading_string_matching_tpu_torch.ops.window import (
        WindowProgram,
        count_matches_window_tiles,
        window_count,
    )

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        for f in [ex.submit(m.load_library, verbose_ptxas=True) for m in (cw, ct, mx)]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.3f} s wall for the three libraries")
    for m in (cw, ct, mx):
        print(f"build: nvcc {m.BUILD_INFO['seconds']:.3f} s -> {m.BUILD_INFO['path']}")
        for line in str(m.BUILD_INFO["log"]).splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"ptxas: {line.strip()}")

    # -- 2. kernels against the plain version -----------------------------
    rng = np.random.default_rng(SEED)
    max_err = {k: 0 for k in (*cw.LAUNCHES, *ct.LAUNCHES)}

    def compare(kname, got, want, name):
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{kname} {name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err[kname] = max(max_err[kname], err)
        check(err == 0, f"{kname} disagrees with the plain version on {name}")

    cases = kernel_cases(rng)
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
        if k != "window_count_halo":  # the flow path's kernel: phase 6
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

    # Bounds of the phase 3-5 records, from these runs' inputs.
    U1, U2, n_head = matcher.kernels.num_unique, big.kernels.num_unique, head2_p.shape[0]
    bounds = {
        "window_count_totals": window_bound(matcher.window, prep.tiles, nbytes, U1),
        "window_count_rows": window_bound(matcher.window, rows_prep.tiles, rbytes,
                                          head_p.shape[0] * U1),
        "window_count_totals_repeated": window_bound(matcher.window, prep.tiles, nbytes, U1, reps=3),
    }
    head_bounds, i32 = {}, int32_ops_per_s()
    for form in ("filter", "table"):
        full_ops = compare_ops(big.window, prep2.tiles, nbytes2, form == "filter")
        head_ops = compare_ops(big.window, rows_prep2.tiles, rbytes2, form == "filter")
        bounds[f"{form}_count_totals"] = bound(nbytes2 + 4 * U2, full_ops, i32)
        head_bounds[(form, "totals")] = bound(rbytes2 + 4 * U2, head_ops, i32)
        head_bounds[(form, "rows")] = bounds[f"{form}_count_rows"] = bound(
            rbytes2 + 4 * n_head * U2, head_ops, i32)

    # -- 6. the flow path ---------------------------------------------------
    halo_record = flow_phase(dev, card, patterns, pat_file, cw, ct)

    # -- 7. the sharded path --------------------------------------------------
    shard_records = shard_phase(dev, card, cw, ct, big, rules_file, cap2, batch2, big_counts,
                                big_rows, filt_ms, cap, pat_file, patterns, counts, head_bounds)
    rules_file.unlink()

    # -- 8. the matrix-unit measurement path ----------------------------------
    mxu_record = mxu_phase(dev, card, mx, matcher, prep, counts, head_p, head_l)

    src = "multithreading_string_matching_tpu_torch/csrc/window_count.cu"
    ref = "multithreading_string_matching_tpu/ops/pallas_window.py"
    tsrc = "multithreading_string_matching_tpu_torch/csrc/table_count.cu"
    tref = "multithreading_string_matching_tpu/ops/pallas_table.py"
    record = {"kernels": [
        {"name": "window_count_totals", "route": "cuda", "source": src,
         "replaces": f"{ref}:402", "launches": launches["window_count_totals"],
         "max_abs_err": max_err["window_count_totals"], "ms": tot_ms, "plain_ms": tot_plain_ms,
         "library_ms": None, **bounds["window_count_totals"]},
        {"name": "window_count_rows", "route": "cuda", "source": src,
         "replaces": f"{ref}:450", "launches": launches["window_count_rows"],
         "max_abs_err": max_err["window_count_rows"], "ms": rows_ms, "plain_ms": rows_plain_ms,
         "library_ms": None, **bounds["window_count_rows"]},
        {"name": "window_count_totals_repeated", "route": "cuda", "source": src,
         "replaces": f"{ref}:417", "launches": launches["window_count_totals_repeated"],
         "max_abs_err": max_err["window_count_totals_repeated"], "ms": rep_ms,
         "plain_ms": rep_plain_ms,
         "library_ms": None, **bounds["window_count_totals_repeated"]},
        {"name": "table_count_totals", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:644", "launches": tab_launches["table_count_totals"],
         "max_abs_err": max(max_err["table_count_totals"], max_err["table_count_totals_repeated"]),
         "ms": tab_ms, "plain_ms": plain_ms["table"],
         "library_ms": None, **bounds["table_count_totals"]},
        {"name": "table_count_rows", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:704", "launches": tab_launches["table_count_rows"],
         "max_abs_err": max_err["table_count_rows"], "ms": tab_rows_ms,
         "plain_ms": plain_rows_ms["table"],
         "library_ms": None, **bounds["table_count_rows"]},
        {"name": "filter_count_totals", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:644", "launches": filt_launches["filter_count_totals"],
         "max_abs_err": max(max_err["filter_count_totals"], max_err["filter_count_totals_repeated"]),
         "ms": filt_ms, "plain_ms": plain_ms["filter"],
         "library_ms": None, **bounds["filter_count_totals"]},
        {"name": "filter_count_rows", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:704", "launches": filt_launches["filter_count_rows"],
         "max_abs_err": max_err["filter_count_rows"], "ms": filt_rows_ms,
         "plain_ms": plain_rows_ms["filter"],
         "library_ms": None, **bounds["filter_count_rows"]},
        halo_record,
        *shard_records,
        mxu_record,
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
