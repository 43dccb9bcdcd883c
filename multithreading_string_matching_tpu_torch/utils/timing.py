"""Phase-labeled timing (component C14); counterpart of
``multithreading_string_matching_tpu/utils/timing.py``.  Phases time host
wall clock: a phase that ends in a device result must synchronise (the
port's ``Matcher.count`` returns host arrays, which does).

The reference times inconsistent regions per program (serial includes pcap
ingest, serial.c:111; openmp_data excludes it, openmp_data.c:126; MPI times
post-scatter, mpi_dumping.c:166-168; live prints no time).  Here every run
records named phases — ingest / extract / compile / h2d / scan / reduce —
so numbers are comparable across execution modes, plus a total.

:func:`span` opens a named range in a ``torch.profiler`` trace, on the
profiler's clock beside the card's kernels and copies, and costs one check
when no profiler runs: the port's one span mechanism (``msm.*`` stages of
the streamed path, ``msm_<entry>`` kernel launches).  :func:`cuda_ms` times
device work with CUDA events, :func:`queued_ms` the device time of one call
queued ahead of the card, and :func:`card_line` names the card and its
power limit, to be printed beside every such time.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import ContextManager, Dict, Iterator, Tuple

import torch

# What span() returns when no profiler runs: one shared context, so the off
# path allocates nothing.
_NO_SPAN = nullcontext()


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


def span(name: str) -> ContextManager:
    """A ``torch.profiler.record_function(name)`` range while a profiler
    records this thread, else one shared no-op context.  Spans nest in time
    on the caller's thread; a profiler does not record ranges opened in
    threads it was not started in."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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


def queued_ms(fn, runs: int = 3) -> Tuple[float, bool]:
    """``(milliseconds, clean)``: the median device time of one call of
    ``fn`` queued alone behind ``torch.cuda._sleep`` (about twice the
    call's own time), CUDA events around the call.  ``clean`` is true when
    in every run the host had enqueued the whole call while the card still
    slept (the call's start event not yet reached): then the host's time
    between launches, which :func:`cuda_ms` holds where the host is the
    slower side, is not in it.  Otherwise the host fell behind (a full
    launch queue blocks it) and the time is an upper bound.  ``fn`` must not
    synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    times, clean = [], True
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4e9 * call_s) + 10_000_000)  # cycles: ~2x the call at <= 2 GHz
        start.record()
        fn()
        end.record()
        clean &= not start.query()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), clean
