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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 1
MAIN_PACKETS = 100_000
ROWS_PER_PACKET_RUN = 8192
SCAN_RUNS = 20
PLAIN_RUNS = 5
SERIAL_RUNS = 3
RULES = 3072
ALNUM = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"


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
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(m.load_library, verbose_ptxas=True) for m in (cw, ct)]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.3f} s wall for both libraries")
    for m in (cw, ct):
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
    rules_file.unlink()

    src = "multithreading_string_matching_tpu_torch/csrc/window_count.cu"
    ref = "multithreading_string_matching_tpu/ops/pallas_window.py"
    tsrc = "multithreading_string_matching_tpu_torch/csrc/table_count.cu"
    tref = "multithreading_string_matching_tpu/ops/pallas_table.py"
    record = {"kernels": [
        {"name": "window_count_totals", "route": "cuda", "source": src,
         "replaces": f"{ref}:402", "launches": launches["window_count_totals"],
         "max_abs_err": max_err["window_count_totals"], "ms": tot_ms, "plain_ms": tot_plain_ms},
        {"name": "window_count_rows", "route": "cuda", "source": src,
         "replaces": f"{ref}:450", "launches": launches["window_count_rows"],
         "max_abs_err": max_err["window_count_rows"], "ms": rows_ms, "plain_ms": rows_plain_ms},
        {"name": "window_count_totals_repeated", "route": "cuda", "source": src,
         "replaces": f"{ref}:417", "launches": launches["window_count_totals_repeated"],
         "max_abs_err": max_err["window_count_totals_repeated"], "ms": rep_ms,
         "plain_ms": rep_plain_ms},
        {"name": "table_count_totals", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:644", "launches": tab_launches["table_count_totals"],
         "max_abs_err": max(max_err["table_count_totals"], max_err["table_count_totals_repeated"]),
         "ms": tab_ms, "plain_ms": plain_ms["table"]},
        {"name": "table_count_rows", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:704", "launches": tab_launches["table_count_rows"],
         "max_abs_err": max_err["table_count_rows"], "ms": tab_rows_ms,
         "plain_ms": plain_rows_ms["table"]},
        {"name": "filter_count_totals", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:644", "launches": filt_launches["filter_count_totals"],
         "max_abs_err": max(max_err["filter_count_totals"], max_err["filter_count_totals_repeated"]),
         "ms": filt_ms, "plain_ms": plain_ms["filter"]},
        {"name": "filter_count_rows", "route": "cuda", "source": tsrc,
         "replaces": f"{tref}:704", "launches": filt_launches["filter_count_rows"],
         "max_abs_err": max_err["filter_count_rows"], "ms": filt_rows_ms,
         "plain_ms": plain_rows_ms["filter"]},
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
