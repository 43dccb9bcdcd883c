"""Phase-labeled timing (component C14); counterpart of
``multithreading_string_matching_tpu/utils/timing.py``.  Phases time host
wall clock: a phase that ends in a device result must synchronise (the
port's ``Matcher.count`` returns host arrays, which does).

The reference times inconsistent regions per program (serial includes pcap
ingest, serial.c:111; openmp_data excludes it, openmp_data.c:126; MPI times
post-scatter, mpi_dumping.c:166-168; live prints no time).  Here every run
records named phases — ingest / extract / compile / h2d / scan / reduce —
so numbers are comparable across execution modes, plus a total.
"""

from __future__ import annotations

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
