"""What the benchmark takes from the program under test, the PyTorch and
CUDA package: its matcher, its launch counters and the place of its CUDA
sources.  Modules of the program are looked up when called, never at
import, so that this module imports nothing of it."""

from __future__ import annotations

import importlib
import pathlib

PACKAGE = "multithreading_string_matching_tpu_torch"
# The program's modules that keep a ``LAUNCHES`` counter of kernel launches.
COUNTED = ("ops.cuda_window", "ops.cuda_table", "ops.scan", "ops.mxu")


def module(name: str):
    return importlib.import_module(f"{PACKAGE}.{name}")


def csrc_dir() -> pathlib.Path:
    return pathlib.Path(importlib.import_module(PACKAGE).__file__).resolve().parent / "csrc"


def build_matcher(ctx):
    """The configuration's matcher over the cell's pattern file, loaded by
    the program's own pattern loader."""
    api = module("api")
    patterns = module("io.patterns").load_patterns(ctx.inputs.pattern_file)
    opts = dict(ctx.config.get("matcher", {}))
    opts.update(ctx.matcher_options)
    return api.Matcher(patterns, device=ctx.device, **opts)


def launches() -> int:
    """Kernel launches the program has counted in this process so far."""
    return sum(sum(module(m).LAUNCHES.values()) for m in COUNTED)
