#!/usr/bin/env python3
"""The control of the check that decides ``correct``: runs of a cell with
one guarantee of its configuration broken, which the check must call not
correct.

The configurations state that patterns match byte for byte, case-sensitively.
The control is the program's own path with that guarantee switched off:
``Matcher(case_insensitive=True)``, which folds ASCII letters in patterns and
payloads before it counts.  Every other step of the run is the cell's own,
at the cell's own size.  From the root of a checkout with a card:

    python3 gpubench/control.py --workload <name> --seeds 11 12 13 --seconds 2

prints one JSON line a seed: ``correct`` and the numbers compared.  The
benchmark's own runs never run it.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "gpubench":
    sys.path[0] = str(ROOT)

from gpubench import run  # noqa: E402

CONTROL = {"case_insensitive": True}


def control_run(workload: str, seed: int, seconds: float, **kw) -> dict:
    result, _ = run.run_cell(workload, seed, seconds, False, matcher_options=CONTROL, **kw)
    return {"workload": workload, "seed": seed, "correct": result["correct"],
            "attempted": result["attempted"], "checks": result["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_run(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
