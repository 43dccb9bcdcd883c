"""Command line of the torch package: the one-shot commands.

Counterpart of ``multithreading_string_matching_tpu/cli.py``::

  python -m multithreading_string_matching_tpu_torch serial <file.pcap> <strings.txt> [udp/tcp]
  python -m multithreading_string_matching_tpu_torch match  --pcap F --patterns F
        [--mode udp|tcp] [--engine auto|pallas|window|ac|kmp] [--nocase]
        [--vlan] [--ipv6] [--per-packet] [--flows [--reorder] [--stream]] [--json]

``MSM_DEVICE=cpu|cuda`` (default ``cuda``) picks the device, as
``MSM_PLATFORM`` does for the JAX package: ``cuda`` runs the hand-written
kernels and fails without a card, ``cpu`` runs their plain versions.
Output is byte-compatible with the reference's report (utils/report.py).

``match --flows`` reassembles TCP/UDP flows and counts over the streams;
``--flows --stream`` is the bounded-memory flow monitor
(parallel/flow_stream.py), fed ``MSM_FLOW_BATCH`` packets (default 8192) at
a time, reloading the rules file on SIGHUP.  The other commands (data,
task, live, mesh, synth) and match's packet streaming, sharding, offset,
dump and distributed options are not yet ported (ROADMAP).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np


def _mode_arg(tokens: List[str], default: str = "udp") -> str:
    """Parse the trailing [udp/tcp] token (anything else exits 1)."""
    if not tokens:
        return default
    if tokens[0] in ("udp", "tcp"):
        return tokens[0]
    raise SystemExit(f"unknown packet type {tokens[0]!r}: expected udp or tcp")


def _build(patterns_path: str, engine: str = "pallas", nocase: bool = False):
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns

    return Matcher(
        load_patterns(patterns_path), engine=engine, case_insensitive=nocase,
        device=os.environ.get("MSM_DEVICE", "cuda"),
    )


def _exact_counts(total) -> np.ndarray:
    """int32 counts unless the exact totals exceed it — then int64."""
    total = np.asarray(total, dtype=np.int64)
    if total.size and total.max() > np.iinfo(np.int32).max:
        return total
    return total.astype(np.int32)


def _report(matcher, counts, elapsed) -> None:
    from multithreading_string_matching_tpu_torch.utils.report import format_report

    print(format_report(matcher.patterns, counts, elapsed))


def cmd_serial(argv: List[str]) -> int:
    """serial.c analogue: one-shot scan of the whole file, timed from
    ingest to counts."""
    if len(argv) < 2:
        print("USAGE: serial <file.pcap> <strings.txt> [tcp/udp]")
        return 1
    mode = _mode_arg(argv[2:])
    matcher = _build(argv[1])
    start = time.perf_counter()
    counts = matcher.count_pcap(argv[0], mode)
    elapsed = time.perf_counter() - start
    _report(matcher, counts, elapsed)
    return 0


def _execution_blob(matcher, actual: str) -> dict:
    """``matcher.explain()``, corrected to the engine a path really ran
    (``actual``), as the JAX CLI reports it."""
    ex = matcher.explain()
    if actual != ex["engine_resolved"]:
        ex["streamed_remap"] = f"{ex['engine_resolved']}->{actual}"
        ex["engine_resolved"] = actual
        ex.pop("pallas_kernel", None)
    return ex


def cmd_match(argv: List[str]) -> int:
    """One-shot scan with explicit flags, or the flow monitor."""
    p = argparse.ArgumentParser(prog="match")
    p.add_argument("--pcap", required=True, help="capture file ('-' reads stdin)")
    p.add_argument("--patterns", required=True)
    p.add_argument("--mode", choices=["udp", "tcp"], default="udp")
    p.add_argument("--engine", choices=["auto", "pallas", "window", "ac", "kmp"],
                   default="pallas")
    p.add_argument("--nocase", action="store_true",
                   help="ASCII case-insensitive matching (patterns and payloads folded)")
    p.add_argument("--vlan", action="store_true", help="skip 802.1Q/802.1ad VLAN tags (up to two)")
    p.add_argument("--ipv6", action="store_true", help="also decode IPv6 frames (ethertype 0x86dd)")
    p.add_argument("--per-packet", action="store_true")
    p.add_argument("--flows", action="store_true",
                   help="reassemble TCP/UDP 5-tuple flows and scan the concatenated streams")
    p.add_argument("--reorder", action="store_true",
                   help="with --flows: order each TCP flow's segments by sequence number "
                        "and drop retransmitted or overlapping bytes (first bytes win)")
    p.add_argument("--stream", action="store_true",
                   help="with --flows: the bounded-memory flow monitor")
    for flag in ("--offsets", "--sharded", "--distributed"):
        p.add_argument(flag, action="store_true", help="not yet ported")
    p.add_argument("--dump-matches", metavar="OUT.pcap", help="not yet ported")
    p.add_argument("--host-workers", type=int, default=0, metavar="N", help="not yet ported")
    p.add_argument("--json", action="store_true")
    a = p.parse_args(argv)
    if a.per_packet and not a.json:
        raise SystemExit("--per-packet produces an [N, P] matrix: use --json")
    unported = [f for f, on in (("--offsets", a.offsets), ("--dump-matches", a.dump_matches),
                                ("--sharded", a.sharded), ("--host-workers", a.host_workers),
                                ("--distributed", a.distributed),
                                ("--stream without --flows", a.stream and not a.flows)) if on]
    if unported:
        raise NotImplementedError(
            f"match {', '.join(unported)} is not yet ported to the torch package (ROADMAP)"
        )
    if a.flows and a.per_packet:
        raise SystemExit("--flows does not compose with --per-packet (per-flow rows "
                         "ARE the attribution unit; use --offsets for positions)")
    if a.reorder and not a.flows:
        raise SystemExit("--reorder requires --flows")
    if a.reorder and a.mode != "tcp":
        raise SystemExit("--reorder applies to TCP flows only")

    from multithreading_string_matching_tpu_torch.utils.timing import PhaseTimer

    matcher = _build(a.patterns, engine=a.engine, nocase=a.nocase)
    timer = PhaseTimer()
    if a.flows and a.stream:
        return _match_flow_stream(a, matcher, timer)
    if a.flows:
        return _match_flows(a, matcher, timer)

    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap

    with timer.phase("ingest"):
        pcap = read_pcap(a.pcap)
    with timer.phase("extract"):
        batch = extract_payloads(pcap, a.mode, pad_n_to=128, pad_len_to=8,
                                 vlan=a.vlan, ipv6=a.ipv6)
    with timer.phase("scan"):
        counts = matcher.count_batch(batch, per_packet=a.per_packet)
    if a.json:
        _print_json({
            "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
            "counts": np.asarray(counts).tolist(),
            "packets": batch.num_packets,
            "valid_payloads": int(batch.valid.sum()),
            "payload_bytes": batch.total_payload_bytes,
            "phases": timer.phases,
            "execution": matcher.explain(),
        })
    else:
        _report(matcher, _exact_counts(counts), timer.total)
        print(f"# {timer.summary()}", file=sys.stderr)
    return 0


def _print_json(blob: dict) -> None:
    import json

    print(json.dumps(blob))


def _match_flows(a, matcher, timer) -> int:
    """One-shot ``--flows``: reassemble every flow, count over the streams."""
    from multithreading_string_matching_tpu_torch.io.flows import extract_flows
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap

    with timer.phase("ingest"):
        pcap = read_pcap(a.pcap)
    with timer.phase("extract"):
        fb = extract_flows(pcap, a.mode, reorder=a.reorder, ipv6=a.ipv6, vlan=a.vlan)
    with timer.phase("scan"):
        counts = matcher.count(fb.payloads, fb.lengths)
    if a.json:
        _print_json({
            "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
            "counts": np.asarray(counts).tolist(),
            "flows": fb.num_flows,
            "flow_packets": int((fb.flow_of_packet >= 0).sum()),
            "packets": fb.num_packets,
            "stream_bytes": fb.total_payload_bytes,
            "phases": timer.phases,
            "execution": matcher.explain(),
        })
    else:
        _report(matcher, _exact_counts(counts), timer.total)
    return 0


def _flow_stream_engine(a, matcher) -> str:
    """The JAX CLI's choice: an explicit ``window`` anywhere, ``pallas`` or
    ``auto`` take the window rounds on an accelerator, the rest the AC scan
    (not yet ported, so a CPU run without ``--engine window`` exits 1)."""
    if a.engine == "window":
        return "window"
    if (a.engine in ("pallas", "auto") and matcher.device.type == "cuda"
            and matcher._resolve_engine(None) in ("pallas", "window")):
        return "window"
    return "ac"


def _match_flow_stream(a, matcher, timer) -> int:
    """``--flows --stream``: iter_pcap batches into the flow monitor, with
    the rules file reloaded on SIGHUP (``--pcap -`` behind a tcpdump pipe
    is the daemon shape)."""
    import signal

    from multithreading_string_matching_tpu_torch.io.pcap import iter_pcap
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher
    from multithreading_string_matching_tpu_torch.utils.report import format_report

    fse = _flow_stream_engine(a, matcher)
    fs = FlowStreamMatcher(matcher, a.mode, engine=fse, reorder=a.reorder, ipv6=a.ipv6,
                           vlan=a.vlan)
    reload_flag = {"hup": False}
    old_hup = None
    if hasattr(signal, "SIGHUP"):
        old_hup = signal.signal(signal.SIGHUP, lambda s, f: reload_flag.__setitem__("hup", True))
    # The batch size is the reload and feed latency on a pipe: iter_pcap
    # yields on a full batch or at EOF (rounds are still set by scan_bytes).
    flow_batch = int(os.environ.get("MSM_FLOW_BATCH", "8192"))
    reloads = 0
    try:
        with timer.phase("scan"):
            for chunk in iter_pcap(a.pcap, batch_packets=flow_batch):
                if reload_flag["hup"]:
                    reload_flag["hup"] = False
                    try:
                        new_matcher = _build(a.patterns, engine=a.engine, nocase=a.nocase)
                        prev = fs.reload(new_matcher)
                    except Exception as e:  # the daemon keeps its old rules
                        print(f"# rules reload failed, keeping old set: {e}", file=sys.stderr)
                    else:
                        reloads += 1
                        if a.json:
                            import json

                            # The final blob covers the last epoch only.
                            print(json.dumps({
                                "reload": reloads,
                                "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
                                "counts": prev.tolist(),
                            }), file=sys.stderr)
                        else:
                            print("# rules reloaded; counts under the previous set:",
                                  file=sys.stderr)
                            print(format_report(matcher.patterns, prev, None), file=sys.stderr)
                        matcher = new_matcher
                fs.feed_pcap_slice(chunk)
            fs.flush()
    finally:
        if old_hup is not None:
            signal.signal(signal.SIGHUP, old_hup)
    counts = fs.counts()
    if a.json:
        ex = _execution_blob(matcher, actual=fse)
        ex["flow_rounds"] = "window_count_halo" if fs._use_halo_kernel() else "plain"
        blob = {
            "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
            "counts": counts.tolist(),
            "flows": fs.flows_seen,
            "flow_packets": fs.packets_seen,
            "stream_bytes": fs.bytes_seen,
            "phases": timer.phases,
            "execution": ex,
        }
        if reloads:
            blob["reloads"] = reloads
        _print_json(blob)
    else:
        _report(matcher, _exact_counts(counts), timer.total)
    return 0


COMMANDS = {
    "serial": cmd_serial,
    "match": cmd_match,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 1
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        print(f"unknown command {argv[0]!r}; one of {sorted(COMMANDS)}")
        return 1
    try:
        return cmd(argv[1:])
    except FileNotFoundError as e:
        # Reference behavior: perror + exit(1) on fopen/pcap_open failure.
        print(f"error opening file: {e.filename or e}", file=sys.stderr)
        return 1
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
