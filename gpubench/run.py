#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

From the root of a checkout:

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix, the entry that mix drives,
the mix's capture generator, the configuration's reference and the
per-layer readers are found by the names in ``BENCHMARK.json`` and its
files (``gpubench/registry.py``).  A run:

1. writes the cell's pattern file and captures with the mix's generator
   (``gpubench/gen/<generator>.py``) from ``--seed`` into a temporary
   directory under ``TMPDIR``;
2. builds the program's matcher and warms up the entry's own shapes: the
   program builds its kernels into its ``build/`` directory inside the
   checkout on the first run there, and loads them on later runs;
   ``setup_s`` runs from the start of this script to here;
3. runs the entry's passes back to back for ``--seconds``; with
   ``--trace 1`` the first ``trace_seconds`` of the traffic file are traced
   with ``torch.profiler`` and the per-layer metrics are read from the trace,
   the program's launch counters and the entry's probes;
4. frees the program's state, counts every capture the window answered with
   the configuration's plain reference (``gpubench/reference/<reference>.py``)
   on the card, and compares every answer of the window with it.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a CUDA card, or with fewer than the cell asks for, the run exits 2
and prints no result; if JAX or the JAX package was loaded, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# Run as a script, Python puts gpubench/ itself first on the path, where
# its modules would shadow the standard library's (trace); the checkout's
# root goes there instead.
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "gpubench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from gpubench import program, registry, roofline, trace  # noqa: E402
from gpubench.gen.inputs import Inputs, make_inputs  # noqa: E402

# Top-level module names that no run may load: JAX and the JAX package
# (the program's own name begins with the latter's; names compare whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "multithreading_string_matching_tpu")
EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def host_usage() -> Dict[str, float]:
    """This process's CPU seconds, all and in the kernel: read around the
    window and logged beside its wall time."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "sys_s": ru.ru_stime}


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"unknown ({e})"


@dataclass
class Context:
    """What an entry's ``setup`` gets."""

    config: dict
    traffic: dict
    inputs: Inputs
    device: str
    matcher_options: dict = field(default_factory=dict)


class Window:
    """The measured window: an entry iterates :meth:`passes` and reports each
    pass's answer with :meth:`answer`."""

    def __init__(self, seconds: float, cuda: bool, tracer: Optional[trace.Tracer] = None):
        self.seconds = float(seconds)
        self.cuda = cuda
        self.tracer = tracer
        self.durations: List[float] = []
        self.answers: List[Tuple[int, np.ndarray]] = []
        self.traced = 0
        self.elapsed = 0.0

    @property
    def count(self) -> int:
        return len(self.durations)

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def passes(self):
        """Pass indices until ``seconds`` have passed; the last pass ends
        after that.  Each pass ends with its answer on the host."""
        self._sync()
        tr = self.tracer
        if tr is not None:
            tr.start()
        t0 = time.perf_counter()
        i = 0
        while True:
            ts = time.perf_counter()
            with tr.span() if tr is not None and tr.active else nullcontext():
                yield i
            te = time.perf_counter()
            self.durations.append(te - ts)
            i += 1
            if tr is not None and tr.active:
                self.traced = i
                if te - t0 >= tr.seconds:
                    tr.stop()
            if te - t0 >= self.seconds:
                break
        self.elapsed = te - t0
        if tr is not None and tr.active:
            tr.stop()

    def answer(self, key: int, counts) -> None:
        self.answers.append((key, np.array(counts, dtype=np.int64)))


def compare(answers, ref: Dict[int, np.ndarray]) -> Tuple[int, int]:
    """``(answers that differ from the reference's in any entry, the most
    entries that differ in one answer)``; an answer of the wrong shape
    differs in every entry."""
    wrong = worst = 0
    for key, got in answers:
        want = ref[key]
        bad = int((got != want).sum()) if got.shape == want.shape else len(want)
        wrong += bad > 0
        worst = max(worst, bad)
    return wrong, worst


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *, device: str = "cuda",
             t_start: Optional[float] = None, capture_overrides: Optional[dict] = None,
             matcher_options: Optional[dict] = None) -> Tuple[dict, List[str]]:
    """One run of one cell: ``(result, check lines)``.  ``device="cpu"``
    runs the program's plain versions and the reference on the CPU (tests
    only: no number of such a run is a device metric)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device == "cuda"
    bench = registry.load_benchmark(ROOT)
    cell = registry.cell(bench, workload)
    cfg = registry.config(bench, cell["config"], ROOT)
    if cfg.get("host_threads"):
        torch.set_num_threads(int(cfg["host_threads"]))
    traffic = registry.traffic(cell["traffic"])
    if capture_overrides:
        traffic["capture"].update(capture_overrides)
    entry = registry.entry(traffic["entry"])
    reference = registry.reference(cfg.get("reference", registry.DEFAULT_REFERENCE))
    e2e = registry.end_to_end(bench, workload)
    layers = registry.per_layer(bench, workload)
    readers = {m["name"]: registry.reader(m["name"]) for m in layers} if trace_on else {}
    with tempfile.TemporaryDirectory(prefix="gpubench-") as work:
        work = pathlib.Path(work)
        t = time.perf_counter()
        log(f"set-up: {t - t_start:.3f} s to the inputs")
        inputs = make_inputs(cfg, traffic, seed, ROOT, work)
        t1 = time.perf_counter()
        log(f"inputs: {len(inputs.patterns)} patterns, {len(inputs.captures)} captures, "
            f"{sum(inputs.payload_bytes)} payload bytes in {t1 - t:.3f} s")
        ctx = Context(cfg, traffic, inputs, device, dict(matcher_options or {}))
        state = entry.setup(ctx)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log(f"set-up: the entry's set-up and warm-up {t_start + setup_s - t1:.3f} s")
        tracer = (trace.Tracer(traffic.get("trace_seconds", seconds), work, cuda=cuda)
                  if trace_on else None)
        win = Window(seconds, cuda, tracer)
        l0, h0 = program.launches(), host_usage()
        readings = entry.window(state, win)
        launches = program.launches() - l0
        h1 = host_usage()
        log(f"host over the window: {torch.get_num_threads()} intra-op thread(s), "
            + ", ".join(f"{k} {h1[k] - h0[k]:.3f}" for k in h0))
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            log(f"card: {card_line()}")
        probes = entry.probes(state) if trace_on else {}
        d = sorted(win.durations)
        log(f"setup {setup_s:.4f} s; window {win.elapsed:.4f} s, {win.count} passes "
            f"(min {d[0]:.6f}, median {d[len(d) // 2]:.6f}, max {d[-1]:.6f} s), "
            f"{launches} launches; {readings}")
        del state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ref, ref_bytes = {}, {}
        for key in sorted({k for k, _ in win.answers}):
            ref[key], ref_bytes[key] = reference.capture_counts(
                inputs.captures[key], inputs.patterns, inputs.mode, device=device)
        log(f"reference: {len(ref)} captures in {time.perf_counter() - t:.3f} s")
    wrong, worst = compare(win.answers, ref)
    checks = {
        "wrong_answers": (wrong, 0),
        "wrong_entries_max": (worst, 0),
        "payload_bytes_gap": (sum(abs(inputs.payload_bytes[k] - ref_bytes[k]) for k in ref), 0),
    }
    correct = bool(win.answers) and all(v <= lim for v, lim in checks.values())
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    metrics = {}
    result = {"correct": correct, "attempted": len(win.answers), "failed": checks["wrong_answers"][0]}
    if trace_on:
        rec = dict(tracer.records or trace.reduce_events([]))
        rec.update(
            kernel_names=trace.program_kernel_names(program.csrc_dir()),
            traced_payload_bytes=sum(ref_bytes[k] for k, _ in win.answers[: win.traced]),
            patterns=len(inputs.patterns), hbm_bytes_per_s=roofline.hbm_bytes_per_s(kind),
            counters={"launches": launches, "passes": win.count}, probes=probes,
        )
        for m in layers:
            v = readers[m["name"]].read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = trace.busy_s(rec) or 0.0
        dev["window_s"] = trace.window_s(rec) or 0.0
        result["breakdown"] = trace.breakdown(rec)
        log(f"traced window {dev['window_s']:.4f} s, {rec['passes']} passes, "
            f"{len(rec['device'])} device ops, busy {dev['busy_s']:.4f} s")
    else:
        values = dict(readings, setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    lines = [f"check {k}: {v} (limit {lim})" for k, (v, lim) in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = registry.cell(registry.load_benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"error: {args.workload} needs {cell['chips']} CUDA card(s); {have} available")
        return EXIT_NO_CARD
    log(f"set-up: {time.perf_counter() - T_START:.3f} s to import torch and find the card")
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START)
    found = forbidden_modules()
    if found:
        log(f"error: the run loaded {', '.join(found)}")
        return EXIT_FORBIDDEN
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
