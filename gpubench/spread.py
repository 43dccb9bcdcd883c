#!/usr/bin/env python3
"""Runs a cell many times, one process a run, and reports each metric's
spread: what an end-to-end bound is set from.

From the root of a checkout with a card:

    python3 gpubench/spread.py --workload <name> --seconds 10 \\
        --warm-seed 100 --seeds 1 2 3 4 5 6 --sets 2 --trace-seeds 7 8 9 \\
        --out runs_<name>.jsonl

runs ``gpubench/run.py`` once with the warm seed (a first run in a checkout
builds the program's kernels), then every seed once in each set, in the same
order, then each trace seed with ``--trace 1``.  Every run's result line and
the end of its standard error go to ``--out``, one JSON object a run.  The
summary gives each metric's median and its spread: the distance between
the first and third quartiles of ``statistics.quantiles(values, n=4)`` as a
share of the median, in each set.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
# gpubench/ itself must not stand first on the path: its trace.py would
# shadow the standard library's.
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "gpubench":
    sys.path[0] = str(ROOT)


def one_run(workload, seed, seconds, trace, timeout):
    cmd = [sys.executable, str(ROOT / "gpubench" / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(int(trace))]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    result = None
    if out.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"workload": workload, "seed": seed, "trace": int(trace), "rc": out.returncode,
            "wall_s": time.perf_counter() - t0, "result": result, "stderr": out.stderr[-3000:]}


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--warm-seed", type=int)
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    plan = [(args.warm_seed, 0, "warm")] if args.warm_seed is not None else []
    plan += [(s, 0, f"set{k + 1}") for k in range(args.sets) for s in args.seeds]
    plan += [(s, 1, "trace") for s in args.trace_seeds]
    by_set = {}
    with open(args.out, "a") as f:
        for seed, trace, label in plan:
            rec = one_run(args.workload, seed, args.seconds, trace, args.timeout)
            rec["label"] = label
            f.write(json.dumps(rec) + "\n")
            f.flush()
            res = rec["result"]
            brief = None if res is None else {
                "correct": res["correct"], "attempted": res["attempted"],
                **{k: v["value"] for k, v in res["metrics"].items()},
                **{k: res["device"][k] for k in ("memory_peak_bytes", "busy_s", "window_s")
                   if k in res["device"]}}
            print(json.dumps({"label": label, "seed": seed, "rc": rec["rc"],
                              "wall_s": round(rec["wall_s"], 3), **(brief or {})}), flush=True)
            if res is None:
                print(rec["stderr"], flush=True)
            elif label.startswith("set"):
                by_set.setdefault(label, []).append(res)
    for label, results in by_set.items():
        for name in results[0]["metrics"]:
            vals = [r["metrics"][name]["value"] for r in results]
            if len(vals) >= 2:
                med, spr = spread(vals)
                print(f"{args.workload} {label} {name}: median {med!r}, spread {spr!r}, "
                      f"values {vals!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
