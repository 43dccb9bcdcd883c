"""The traced window: a ``torch.profiler`` trace of the first passes of a
window, reduced to the records that the per-layer readers
(``gpubench/metrics/``) take their numbers from.

The profiler records host ops and the card's kernels, copies and fills.
Its Chrome trace is written into the run's own temporary directory and read
back; the records keep:

- ``window_us``: from the start of the first traced pass to the end of the
  last (each pass is a ``gpubench.pass`` range);
- ``device``: ``(category, name, start_us, end_us)`` of every kernel
  (``kernel``), copy (``gpu_memcpy``) and fill (``gpu_memset``) inside it;
- ``host``: ``(name, start_us, end_us)`` of every host op and range inside
  it but the pass ranges.

Helpers below turn records into shares, sums and the ``breakdown`` of the
result line.
"""

from __future__ import annotations

import bisect
import json
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Tuple

PASS_SPAN = "gpubench.pass"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 160   # a breakdown keeps this much of a templated kernel's name

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def program_kernel_names(csrc: pathlib.Path) -> List[str]:
    """The names of the program's hand-written kernels: every ``__global__``
    function of its CUDA sources (``.cu``, ``.cuh``)."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text(errors="replace")))
    return sorted(names)


class Tracer:
    """Profiles a window's passes until ``seconds`` have passed."""

    def __init__(self, seconds: float, workdir: pathlib.Path, cuda: bool = True):
        self.seconds = float(seconds)
        self.cuda = cuda
        self.workdir = pathlib.Path(workdir)
        self.prof = None
        self.records: Optional[dict] = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def span(self):
        import torch

        return torch.profiler.record_function(PASS_SPAN)

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        path = self.workdir / "trace.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        path.unlink()
        self.records = reduce_events(events)


def reduce_events(events: Iterable[dict]) -> dict:
    """Records of a Chrome trace's complete events (see the module's doc)."""
    passes, device, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        if cat == "user_annotation" and name == PASS_SPAN:
            passes.append((t0, t1))
        elif cat in DEVICE_CATS:
            device.append((cat, name, t0, t1))
        elif cat in HOST_CATS:
            host.append((name, t0, t1))
    if not passes:
        return {"window_us": None, "passes": 0, "device": [], "host": []}
    w0, w1 = min(p[0] for p in passes), max(p[1] for p in passes)
    return {
        "window_us": (w0, w1),
        "passes": len(passes),
        "device": [d for d in device if d[3] > w0 and d[2] < w1],
        "host": [h for h in host if h[2] > w0 and h[1] < w1],
    }


def window_s(rec: dict) -> Optional[float]:
    if not rec.get("window_us"):
        return None
    w0, w1 = rec["window_us"]
    return (w1 - w0) / 1e6


def merged(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[List[float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, as sorted disjoint
    ``[start, end]`` pairs."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(rec: dict) -> Optional[float]:
    """Seconds of the traced window in which a kernel, copy or fill ran."""
    if not rec.get("window_us"):
        return None
    w0, w1 = rec["window_us"]
    return sum(b - a for a, b in merged(((d[2], d[3]) for d in rec["device"]), w0, w1)) / 1e6


def idle_share_pct(rec: dict) -> Optional[float]:
    """Per cent of the traced window in which nothing ran on the card."""
    w, b = window_s(rec), busy_s(rec)
    if not w or b is None or not rec["device"]:
        return None
    return 100.0 * (1.0 - b / w)


def device_seconds(rec: dict, pick) -> float:
    """Summed device seconds of the events ``pick(category, name)`` accepts."""
    return sum(d[3] - d[2] for d in rec["device"] if pick(d[0], d[1])) / 1e6


def is_program_kernel(rec: dict):
    names = rec.get("kernel_names") or []
    pats = [re.compile(r"\b" + re.escape(n) + r"\b") for n in names]
    return lambda cat, name: cat == "kernel" and any(p.search(name) for p in pats)


def breakdown(rec: dict, top: int = 10) -> Dict[str, list]:
    """``device_ops``: the device ops that took most time, by name;
    ``idle_gaps``: the card's idle time inside the window, by the innermost
    host op or range running at each gap's midpoint (``host (no op
    traced)`` where only the pass's own Python ran)."""
    ops: Dict[str, float] = {}
    for cat, name, a, b in rec["device"]:
        name = name[:NAME_CHARS]
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    gaps: Dict[str, float] = {}
    if rec.get("window_us"):
        w0, w1 = rec["window_us"]
        busy = merged(((d[2], d[3]) for d in rec["device"]), w0, w1)
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        host = sorted(rec["host"], key=lambda h: h[1])
        starts = [h[1] for h in host]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            name = _host_at(host, starts, (a + b) / 2)
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return {
        "device_ops": [[n, s] for n, s in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
    }


def _host_at(host, starts, t: float, max_scan: int = 256) -> str:
    """The innermost host op running at ``t``: the one that started last
    among those that cover it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - max_scan), -1):
        name, a, b = host[j]
        if a <= t <= b:
            return name
    return "host (no op traced)"
