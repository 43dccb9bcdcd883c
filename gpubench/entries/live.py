"""The live sensor: ``parallel.stream.run_live``, what ``live`` runs, in
passes back to back over capture 0.

Each pass reads the capture and replays it through a fresh
``StreamMatcher`` in batches of ``batch_packets`` frames, each batch
through the capture filter, the decode and the packed tiles, and ends with
counts on the host.  ``stream_MBps`` is the payload bytes of all passes
over the time from the window's start to the end of its last pass.  The
traffic file's ``entry_args`` are the stream's settings (``batch_packets``,
``tile_rows``, ``pack_width``, ``fixed_len``) and the CLI's thread count
``threads``, which must be 0: no prefetch thread, the path ``run_live``
reads the capture on.
"""

from __future__ import annotations

import sys
import time

from gpubench import program


def setup(ctx):
    t0 = time.perf_counter()
    args = dict(ctx.traffic.get("entry_args", {}))
    if int(args.get("threads", 0)):
        raise ValueError("the live entry runs no prefetch thread: threads must be 0")
    matcher = program.build_matcher(ctx)
    st = {"m": matcher, "path": str(ctx.inputs.captures[0]), "mode": ctx.inputs.mode,
          "args": args, "bytes": ctx.inputs.payload_bytes[0]}
    t1 = time.perf_counter()
    _pass(st)   # builds the kernels, the ingest library and the stager
    print(f"set-up: matcher {t1 - t0:.3f} s, warm-up pass {time.perf_counter() - t1:.3f} s",
          file=sys.stderr, flush=True)
    return st


def _pass(st):
    stream = program.module("parallel.stream")
    a = st["args"]
    sm = stream.StreamMatcher(st["m"], batch_size=int(a["batch_packets"]),
                              fixed_len=int(a["fixed_len"]), tile_rows=int(a["tile_rows"]),
                              pack_width=int(a["pack_width"]))
    stream.run_live(sm, st["path"], st["mode"])
    return sm.counts()


def window(st, win) -> dict:
    for _ in win.passes():
        win.answer(0, _pass(st))
    return {"stream_MBps": win.count * st["bytes"] / win.elapsed / 1e6}


def probes(st) -> dict:
    """The program's ``LIVE`` counter over one more pass, where it keeps
    one."""
    counter = getattr(program.module("parallel.stream"), "LIVE", None)
    if counter is None:
        return {}
    before = dict(counter)
    _pass(st)
    return {"live": {k: counter[k] - before.get(k, 0) for k in counter}}
