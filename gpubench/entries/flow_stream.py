"""The TCP flow monitor: ``parallel.flow_stream.count_pcap_flows_streamed``,
what ``match --flows --stream`` calls, in passes back to back over capture 0.

Each pass reads the whole capture, feeds every segment to a fresh monitor
(``FlowStreamMatcher`` on the engine the CLI picks, ``flow_stream_engine``),
scans it in rounds, flushes and ends with counts on the host.
``stream_MBps`` is the stream bytes of all passes (every TCP payload to
the IP total length) over the time from the window's start to the end of
its last pass.  The traffic file's ``entry_args`` are the pass's keyword
arguments.
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
    _pass(st)   # builds the kernels and the ingest library
    print(f"set-up: matcher {t1 - t0:.3f} s, warm-up pass {time.perf_counter() - t1:.3f} s",
          file=sys.stderr, flush=True)
    return st


def _pass(st):
    flow_stream = program.module("parallel.flow_stream")
    fs = flow_stream.FlowStreamMatcher(st["m"], st["mode"],
                                       engine=flow_stream.flow_stream_engine(st["m"]))
    return flow_stream.count_pcap_flows_streamed(fs, st["path"], **st["args"])


def window(st, win) -> dict:
    for _ in win.passes():
        win.answer(0, _pass(st))
    return {"stream_MBps": win.count * st["bytes"] / win.elapsed / 1e6}


def probes(st) -> dict:
    """Host seconds to read the capture and parse its flow segments alone,
    through the same public io functions and chunk size as a pass; and the
    program's ``FLOWS`` counter over one more pass, where it keeps one."""
    pcap = program.module("io.pcap")
    flows = program.module("io.flows")
    batch = int(st["args"].get("batch_packets", 8192))
    times, nbytes = [], 0
    for _ in range(IO_PROBE_PASSES):
        nbytes = 0
        t0 = time.perf_counter()
        for chunk in pcap.iter_pcap(st["path"], batch_packets=batch):
            nbytes += int(flows.flow_keys(chunk, st["mode"])[3].sum())
        times.append(time.perf_counter() - t0)
    out = {"io_s": statistics.median(times), "io_bytes": nbytes}
    counter = getattr(program.module("parallel.flow_stream"), "FLOWS", None)
    if counter is not None:
        before = dict(counter)
        _pass(st)
        out["flows"] = {k: counter[k] - before.get(k, 0) for k in counter}
    return out
