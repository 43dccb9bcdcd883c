"""Finds what ``BENCHMARK.json`` names: a cell's configuration file, its
traffic file (``gpubench/traffic/<traffic>.json``), the entry that traffic
names (``gpubench/entries/<entry>.py``), the capture generator its
``capture`` names (``gpubench/gen/<generator>.py``, ``udp`` by default), the
reference its configuration names (``gpubench/reference/<reference>.py``,
``udp_packets`` by default) and each per-layer metric's reader
(``gpubench/metrics/<metric>.py``, or for ``<name>.<cell kind>`` without a
file of its own, ``gpubench/metrics/<name>.py``).  New cells, mixes,
configurations, generators, references, entries and metrics are new files;
nothing here changes for them.

A generator module exposes ``write(path, capture, patterns, weights, seed)
-> int``: it writes one capture from the traffic's ``capture`` parameters and
returns its payload bytes by its own rule.  A reference module exposes
``capture_counts(path, patterns, mode, device) -> (int64 counts in
pattern-file order, payload bytes)`` and imports nothing of the program
under test."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from typing import List

BENCH_DIR = pathlib.Path(__file__).resolve().parent
DEFAULT_GENERATOR = "udp"
DEFAULT_REFERENCE = "udp_packets"


def load_benchmark(root: pathlib.Path) -> dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: pathlib.Path) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(pathlib.Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _load(path: pathlib.Path, kind: str):
    if not path.is_file():
        raise KeyError(f"no {kind} file {path}")
    mod_name = "gpubench._" + kind + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    return _load(BENCH_DIR / "entries" / f"{name}.py", "entry")


def generator(name: str):
    return _load(BENCH_DIR / "gen" / f"{name}.py", "generator")


def reference(name: str):
    return _load(BENCH_DIR / "reference" / f"{name}.py", "reference")


def reader(metric: str):
    own = BENCH_DIR / "metrics" / f"{metric}.py"
    if own.is_file() or "." not in metric:
        return _load(own, "metric")
    return _load(BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py", "metric")


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["per_layer"] if applies(m, cell_name)]
