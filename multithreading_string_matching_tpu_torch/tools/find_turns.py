"""Time ``window_find`` (``csrc/window_find.cu``) against copies of it with a
part taken out or a constant changed, in turns, on one card::

    python -m multithreading_string_matching_tpu_torch.tools.find_turns \\
        [--rounds R] [--packets N]

Each build in :data:`VARIANTS` is the kernel's source with the listed text
replaced (every replaced text must occur in the source: a stale entry is
an error), built with the package's ``nvcc`` flags into a library of its
own under the package's ``build/``.  A build with a part taken out counts
wrong by design (``ablation``); the others must give the kernel's triples.
The workload is ``chip_smoke.py`` phase 10's: the stand-in pattern set over
a seeded capture of ``--packets`` UDP packets of 1,024 +- 256 payload bytes
(seed 1, 5% planted), staged as one ``[n, L]`` tile.  ``--rounds`` times,
each build is timed in the order kernel, others, others reversed, kernel:
CUDA events around 20 back-to-back calls of the C entry point (its flag
clear and one launch; no host sync between them), median of 5 such runs,
per call.  Prints one JSON object: each build's median and times, its M,
whether it equals the kernel, the card's name and power limit, the payload
bytes and the tile's shape.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import statistics
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from multithreading_string_matching_tpu_torch.utils.timing import card_line

PACKETS = 100_000
SEED = 1
CALLS = 20
RUNS = 5

# name: (ablation, [(text in csrc/window_find.cu, replacement), ...])
VARIANTS = {
    "no look-back (every tile's first slot taken as 0)": (True, [
        ("for (int base = t;; base -= kLook * kThreads) {",
         "for (int base = t; false; base -= kLook * kThreads) {")]),
    "map tests only (no full probe, no hit)": (True, [
        ("        for (unsigned long long m = cand; m != 0; m &= m - 1) {",
         "        cnt += (cand == 12345ull);  // keeps the map tests\n"
         "        for (unsigned long long m = 0; m != 0; m &= m - 1) {")]),
    "no sweep 1 (staging, tickets and look-back only)": (True, [
        ("        for (unsigned long long m = cand; m != 0; m &= m - 1) {",
         "        for (unsigned long long m = 0; m != 0; m &= m - 1) {"),
        ("        for (int step = 0; step < kSteps; ++step) {\n          const uint32_t* w",
         "        for (int step = 0; step < 0; ++step) {\n          const uint32_t* w")]),
    "no sweep 2 (counts and prefixes only)": (True, [
        ("    if (count == 0) return;\n", "    return;\n")]),
    "look-back window of 2 flags a thread": (False, [
        ("constexpr int kLook = 1;", "constexpr int kLook = 2;")]),
    "look-back window of 4 flags a thread": (False, [
        ("constexpr int kLook = 1;", "constexpr int kLook = 4;")]),
    "no register cap (fewer blocks a SM)": (False, [
        ("__global__ void __launch_bounds__(kThreads, 4) window_find_kernel",
         "__global__ void __launch_bounds__(kThreads) window_find_kernel")]),
    "sweep 2 walks the chains again at a lane's first hit": (False, [
        ("            if (4 * step + j == lowest && memo != 0u) {",
         "            if (4 * step + j == lowest && memo == 12345u) {")]),
    "tiles finished 1 iteration after their sweep": (False, [
        ("  constexpr int kDefer = kChunked ? 0 : 2;", "  constexpr int kDefer = kChunked ? 0 : 1;")]),
    "tiles finished 3 iterations after their sweep": (False, [
        ("  constexpr int kDefer = kChunked ? 0 : 2;", "  constexpr int kDefer = kChunked ? 0 : 3;")]),
}


def variant_source(source: str, edits) -> str:
    """``source`` with each ``(text, replacement)`` of ``edits`` applied;
    raises ``ValueError`` when a text does not occur in it."""
    for old, new in edits:
        if old not in source:
            raise ValueError(f"not in csrc/window_find.cu: {old!r}")
        source = source.replace(old, new)
    return source


def build_variant(source: str):
    """The library of one variant's source, built under the package's
    ``build/`` (the header it includes is found through ``-I csrc``)."""
    from multithreading_string_matching_tpu_torch.ops import _build
    from multithreading_string_matching_tpu_torch.ops.cuda_window import FIND_LIBRARY

    tag = hashlib.sha256(source.encode()).hexdigest()[:10]
    path = _build.BUILD_DIR / f"find_turns_{tag}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    out = _build.BUILD_DIR / f"libmsm_find_turns_{tag}.so"
    if _build.is_stale(out, [path]):
        _build.compile_to([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR)],
                          [path], out)
    lib = ctypes.CDLL(str(out))
    fn = lib.msm_window_find
    fn.restype = ctypes.c_int
    fn.argtypes = FIND_LIBRARY.signatures["msm_window_find"]
    return fn


def standin_tile(device, packets: int):
    """(tables, payload tile, lengths, payload bytes) of phase 10's tile."""
    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
    from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap
    from multithreading_string_matching_tpu_torch.ops.window import WindowProgram
    from multithreading_string_matching_tpu_torch.tools.mxu_match import STANDIN

    patterns = load_patterns(STANDIN)
    with tempfile.TemporaryDirectory() as d:
        cap = pathlib.Path(d) / "standin.pcap"
        synth_udp_pcap(cap, packets, payload_len=1024, payload_len_jitter=256,
                       patterns=patterns, plant_rate=0.05, seed=SEED)
        batch = extract_payloads(read_pcap(cap), "udp", pad_n_to=128, pad_len_to=8)
    tables = WindowProgram.build(patterns).tables(device)
    return (tables, torch.from_numpy(batch.payloads).to(device),
            torch.from_numpy(batch.lengths).to(device), batch.total_payload_bytes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--packets", type=int, default=PACKETS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("find_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multithreading_string_matching_tpu_torch.ops import cuda_window as cw

    source = (cw.CSRC_DIR / "window_find.cu").read_text()
    dev = torch.device("cuda")
    (words, masks, lens), p, ln, nbytes = standin_tile(dev, args.packets)
    full = cw.window_find(p, ln, words, masks, lens)
    M = int(full.shape[0])
    n, L = p.shape
    U, K = words.shape
    size = ctypes.c_longlong()
    cw.FIND_LIBRARY.call("msm_window_find_scratch", n, L, ctypes.byref(size))
    stream = torch.cuda.current_stream(dev).cuda_stream
    builds = {"kernel": cw.FIND_LIBRARY.load().msm_window_find}
    with ThreadPoolExecutor(len(VARIANTS)) as ex:  # one nvcc a variant, all at once
        done = {name: ex.submit(build_variant, variant_source(source, edits))
                for name, (_, edits) in VARIANTS.items()}
        builds.update({name: f.result() for name, f in done.items()})

    def caller(fn):
        out = torch.empty((M, 3), dtype=torch.int64, device=dev)
        scratch = torch.empty(size.value, dtype=torch.int64, device=dev)

        def call():
            rc = fn(p.data_ptr(), ln.data_ptr(), words.data_ptr(), masks.data_ptr(),
                    lens.data_ptr(), out.data_ptr(), M, scratch.data_ptr(), n, L, U, K,
                    dev.index or 0, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return call, out, scratch

    calls, found = {}, {}
    for name, fn in builds.items():
        call, out, scratch = caller(fn)
        call()
        torch.cuda.synchronize()
        calls[name] = call
        found[name] = (int(scratch[1]), bool(int(scratch[1]) == M and torch.equal(out, full)))
    for name, (ablation, _) in VARIANTS.items():
        if not ablation and not found[name][1]:
            raise RuntimeError(f"{name} differs from the kernel")

    def per_call(call) -> float:
        times = []
        for _ in range(RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / CALLS)
        return statistics.median(times)

    names = list(builds)
    order = names[:1] + names[1:] + names[1:][::-1] + names[:1]
    times = {name: [] for name in names}
    for _ in range(args.rounds):
        for name in order:
            times[name].append(per_call(calls[name]))
    print(json.dumps({
        "medians_ms": {k: statistics.median(v) for k, v in times.items()},
        "times_ms": times,
        "matches": {k: v[0] for k, v in found.items()},
        "equal_kernel": {k: v[1] for k, v in found.items()},
        "ablation": {k: v[0] for k, v in VARIANTS.items()},
        "tile": [n, L], "payload_bytes": int(nbytes), "card": card_line(),
        "kind": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
