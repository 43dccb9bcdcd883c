"""The streamed serving path: ``parallel.pipeline.count_pcap_streamed``, what
``match --stream`` calls, in passes back to back over capture 0.

Each pass ingests, decodes, packs and stages the whole capture and ends
with counts on the host.  ``stream_MBps`` is the payload bytes of all passes
over the time from the window's start to the end of its last pass.
The traffic file's ``entry_args`` are the pass's keyword arguments.
"""

from __future__ import annotations

import statistics
import sys
import time

from gpubench import program

IO_PROBE_PASSES = 3


def setup(ctx):
    t0 = time.perf_counter()
    matcher = program.build_matcher(ctx)
    st = {"m": matcher, "path": str(ctx.inputs.captures[0]), "mode": ctx.inputs.mode,
          "args": dict(ctx.traffic.get("entry_args", {})), "bytes": ctx.inputs.payload_bytes[0]}
    t1 = time.perf_counter()
    _pass(st)   # builds the kernels, the ingest library and the stager
    print(f"set-up: matcher {t1 - t0:.3f} s, warm-up pass {time.perf_counter() - t1:.3f} s",
          file=sys.stderr, flush=True)
    return st


def _pass(st):
    pipeline = program.module("parallel.pipeline")
    return pipeline.count_pcap_streamed(st["m"], st["path"], st["mode"], **st["args"])


def window(st, win) -> dict:
    for _ in win.passes():
        win.answer(0, _pass(st))
    return {"stream_MBps": win.count * st["bytes"] / win.elapsed / 1e6}


def probes(st) -> dict:
    """Host seconds to read and decode the capture alone, through the same
    public io functions and batch size as a pass."""
    pcap = program.module("io.pcap")
    decode = program.module("io.decode")
    batch = int(st["args"].get("batch_packets", 8192))
    times, nbytes = [], 0
    for _ in range(IO_PROBE_PASSES):
        nbytes = 0
        t0 = time.perf_counter()
        for chunk in pcap.iter_pcap(st["path"], batch_packets=batch):
            nbytes += decode.extract_payloads(chunk, st["mode"]).total_payload_bytes
        times.append(time.perf_counter() - t0)
    return {"io_s": statistics.median(times), "io_bytes": nbytes}
