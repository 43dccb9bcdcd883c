"""The TCP flow monitor with sequence-order reassembly:
``parallel.flow_stream.count_pcap_flows_streamed`` on a
``FlowStreamMatcher(..., reorder=True)``, what ``match --flows --reorder
--stream`` calls, in passes back to back over capture 0.

Each pass reads the whole capture, feeds every segment with its sequence
number to a fresh monitor (on the engine the CLI picks,
``flow_stream_engine``), puts each round's segments in sequence order,
scans the rounds, flushes and ends with counts on the host.
``stream_MBps`` is the payload bytes on the wire of all passes
(retransmissions included: what the sensor ingests) over the time from the
window's start to the end of its last pass.  The traffic file's
``entry_args`` are the pass's keyword arguments.
"""

from __future__ import annotations

import sys
import time

from gpubench import program


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
    fs = flow_stream.FlowStreamMatcher(st["m"], st["mode"], reorder=True,
                                       engine=flow_stream.flow_stream_engine(st["m"]))
    return flow_stream.count_pcap_flows_streamed(fs, st["path"], **st["args"])


def window(st, win) -> dict:
    for _ in win.passes():
        win.answer(0, _pass(st))
    return {"stream_MBps": win.count * st["bytes"] / win.elapsed / 1e6}


def probes(st) -> dict:
    """The program's ``FLOWS`` counter over one more pass, every key."""
    counter = getattr(program.module("parallel.flow_stream"), "FLOWS", None)
    if counter is None:
        return {}
    before = dict(counter)
    _pass(st)
    return {"flows": {k: counter[k] - before.get(k, 0) for k in counter}}
