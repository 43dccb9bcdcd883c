"""Phase-labeled timing (component C14); counterpart of
``multithreading_string_matching_tpu/utils/timing.py``.  Phases time host
wall clock: a phase that ends in a device result must synchronise (the
port's ``Matcher.count`` returns host arrays, which does).

The reference times inconsistent regions per program (serial includes pcap
ingest, serial.c:111; openmp_data excludes it, openmp_data.c:126; MPI times
post-scatter, mpi_dumping.c:166-168; live prints no time).  Here every run
records named phases — ingest / extract / compile / h2d / scan / reduce —
so numbers are comparable across execution modes, plus a total.

:func:`cuda_ms` times device work with CUDA events, and :func:`card_line`
names the card and its power limit, to be printed beside every such time.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator


@dataclass
class PhaseTimer:
    phases: Dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - start

    @property
    def total(self) -> float:
        return time.perf_counter() - self._t0

    def summary(self) -> str:
        parts = [f"{k}={v:.6f}s" for k, v in self.phases.items()]
        return " ".join(parts + [f"total={self.total:.6f}s"])


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` reports them."""
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
