#!/usr/bin/env python3
"""Drive the torch port's main path once on one NVIDIA GPU, and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Print the card's name and power limit, build the CUDA kernels from
   ``multithreading_string_matching_tpu_torch/csrc`` and print the build time.
2. Hold each kernel (``window_count_totals``, ``window_count_rows``) equal to
   its plain PyTorch version on the same CUDA tensors: ragged widths, NUL
   patterns over rows that are not zero-filled, zero-row and zero-width
   tiles, patterns longer than the row, multi-segment rows, and 3072
   ``rs%06d`` patterns (chunked shared-memory tables).
3. The main path at a real size: a seeded 100,000-packet capture of
   ~1 KB payloads (~100 MB) with the 97-token stand-in pattern set, counted
   by ``Matcher(device="cuda").count_pcap`` and per packet on its first 8,192
   rows, with the kernels' launch counters reset just before.  Counts must
   equal the plain version's on the card and, on the first rows, a
   pure-Python count.
4. Times, with the card's name and power limit beside each: the scan rate
   of the resident prepared tiles (median of 20 runs, CUDA events), the
   plain version's rate at the same shapes, and the wall time of the full
   ``serial`` path.

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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

import numpy as np

SEED = 1
MAIN_PACKETS = 100_000
ROWS_PER_PACKET_RUN = 8192
SCAN_RUNS = 20
PLAIN_RUNS = 5
SERIAL_RUNS = 3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` between CUDA events on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def overlapping(text: bytes, pat: bytes) -> int:
    n, i = 0, text.find(pat)
    while i >= 0:
        n += 1
        i = text.find(pat, i + 1)
    return n


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
    from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap
    from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
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
    cw.load_library(verbose_ptxas=True)
    print(f"build: {time.perf_counter() - t0:.3f} s wall "
          f"(nvcc {cw.BUILD_INFO['seconds']:.3f} s) -> {cw.BUILD_INFO['path']}")
    for line in str(cw.BUILD_INFO["log"]).splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")

    # -- 2. kernels against the plain version -----------------------------
    rng = np.random.default_rng(SEED)
    max_err = {"window_count_totals": 0, "window_count_rows": 0}
    for name, pats, payload, lengths in kernel_cases(rng):
        wp = WindowProgram.build(pats)
        words, masks, lens = wp.tables(dev)
        p = torch.from_numpy(payload).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        for kname, fn, per_row in (
            ("window_count_totals", cw.window_count_totals, False),
            ("window_count_rows", cw.window_count_rows, True),
        ):
            got = fn(p, ln, words, masks, lens)
            want = window_count(words, masks, lens, p, ln, per_packet=per_row)
            torch.cuda.synchronize()
            check(got.shape == want.shape, f"{kname} {name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
            err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
            max_err[kname] = max(max_err[kname], err)
            check(err == 0, f"{kname} disagrees with the plain version on {name}")
        print(f"kernel check {name}: U={len(wp.unique_patterns)} K={wp.pat_words.shape[1]} "
              f"n={payload.shape[0]} L={payload.shape[1]} totals={int(want.sum()) if want.numel() else 0}: equal")

    # -- 3. the main path -------------------------------------------------
    pat_file = pathlib.Path(__file__).resolve().parent / (
        "multithreading_string_matching_tpu_torch/data/strings_standin.txt"
    )
    patterns = load_patterns(pat_file)
    tag = hashlib.sha256(b"\x00".join(patterns)).hexdigest()[:12]
    cap = pathlib.Path(tempfile.gettempdir()) / f"msm_torch_mega_{tag}_{MAIN_PACKETS}.pcap"
    if not cap.exists():
        tmp = cap.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        synth_udp_pcap(tmp, MAIN_PACKETS, payload_len=1024, payload_len_jitter=256,
                       patterns=patterns, plant_rate=0.05, seed=SEED)
        os.replace(tmp, cap)
        print(f"synth: {cap} ({cap.stat().st_size} bytes) in {time.perf_counter() - t0:.3f} s")

    matcher = Matcher(patterns, device=dev)
    batch = extract_payloads(read_pcap(cap), "udp", pad_n_to=128, pad_len_to=8)
    head_p = batch.payloads[:ROWS_PER_PACKET_RUN]
    head_l = batch.lengths[:ROWS_PER_PACKET_RUN]
    torch.cuda.synchronize()
    for k in cw.LAUNCHES:
        cw.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    counts = matcher.count_pcap(cap, "udp")
    main_s = time.perf_counter() - t0
    per_row = matcher.count(head_p, head_l, per_packet=True)
    launches = dict(cw.LAUNCHES)
    print(f"main path: count_pcap {main_s:.3f} s, launches {launches}, "
          f"{batch.num_packets} packets, {int(batch.valid.sum())} valid, "
          f"{batch.total_payload_bytes} payload bytes, {int(counts.sum())} matches")
    for k, v in launches.items():
        check(v > 0, f"{k} was not launched by the main path")
    check(counts.shape == (len(patterns),) and counts.dtype == np.int32,
          f"counts shape/dtype {counts.shape} {counts.dtype}")
    check(per_row.shape == (head_p.shape[0], len(patterns)), f"per-row shape {per_row.shape}")
    check(int(counts.sum()) > 0, "the main path counted no matches")

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
    prep = matcher.prepare_batch(batch, packed="auto")
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
        check(reported == want, "serial report differs from the main-path counts")
    print(f"serial wall: median {statistics.median(serial_s):.4f} s of {SERIAL_RUNS} "
          f"({', '.join(f'{s:.4f}' for s in serial_s)}) [{card}]")

    src = "multithreading_string_matching_tpu_torch/csrc/window_count.cu"
    ref = "multithreading_string_matching_tpu/ops/pallas_window.py"
    record = {"kernels": [
        {"name": "window_count_totals", "route": "cuda", "source": src,
         "replaces": f"{ref}:402", "launches": launches["window_count_totals"],
         "max_abs_err": max_err["window_count_totals"], "ms": tot_ms, "plain_ms": tot_plain_ms},
        {"name": "window_count_rows", "route": "cuda", "source": src,
         "replaces": f"{ref}:450", "launches": launches["window_count_rows"],
         "max_abs_err": max_err["window_count_rows"], "ms": rows_ms, "plain_ms": rows_plain_ms},
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
