"""Command line of the torch package: the one-shot commands.

Counterpart of ``multithreading_string_matching_tpu/cli.py``::

  python -m multithreading_string_matching_tpu_torch serial <file.pcap> <strings.txt> [udp/tcp]
  python -m multithreading_string_matching_tpu_torch match  --pcap F --patterns F
        [--mode udp|tcp] [--engine auto|pallas|window|ac|kmp] [--nocase]
        [--vlan] [--ipv6] [--per-packet] [--flows [--reorder] [--stream]]
        [--sharded [--shard-axis auto|packets|patterns|both]] [--json]

``MSM_DEVICE=cpu|cuda`` (default ``cuda``) picks the device, as
``MSM_PLATFORM`` does for the JAX package: ``cuda`` runs the hand-written
kernels and fails without a card, ``cpu`` runs their plain versions.
Output is byte-compatible with the reference's report (utils/report.py).

``match --flows`` reassembles TCP/UDP flows and counts over the streams;
``--flows --stream`` is the bounded-memory flow monitor
(parallel/flow_stream.py), fed ``MSM_FLOW_BATCH`` packets (default 8192) at
a time, reloading the rules file on SIGHUP.  ``--sharded`` spreads the scan
over a mesh of every device of ``MSM_DEVICE``'s type (each card; one shard
on the CPU): the packet axis, the pattern axis (each shard holds 1/N of the
rule set) or both; ``auto`` takes the pattern axis for table-route sets on
more than one device, the packet axis otherwise.  The other commands (data,
task, live, mesh, synth) and match's packet streaming, offset, dump and
distributed options are not yet ported (ROADMAP).
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


def _execution_blob(matcher, sharded: bool = False, attribution: bool = False,
                    actual: Optional[str] = None, shard_axis: Optional[str] = None) -> dict:
    """``matcher.explain()``, corrected for the remaps of the path that ran,
    as the JAX CLI reports it: ``actual``, the engine a path really ran,
    wins; else sharded attribution and the pattern axis remap ac/kmp to the
    window family, and the sharded counts run kmp as ac."""
    ex = matcher.explain()
    if actual is not None:
        if actual != ex["engine_resolved"]:
            ex["sharded_remap" if sharded else "streamed_remap"] = (
                f"{ex['engine_resolved']}->{actual}")
            ex["engine_resolved"] = actual
        if actual != "pallas":
            ex.pop("pallas_kernel", None)
        return ex
    if (sharded and (attribution or shard_axis in ("patterns", "both"))
            and ex["engine_resolved"] in ("ac", "kmp")):
        ex["sharded_remap"] = f"{ex['engine_resolved']}->window"
        ex["engine_resolved"] = "window"
    elif sharded and ex["engine_resolved"] == "kmp":
        ex["engine_resolved"] = "ac"
        ex["sharded_remap"] = "kmp->ac"
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
    p.add_argument("--sharded", action="store_true",
                   help="use every device of MSM_DEVICE's type through a mesh")
    p.add_argument("--shard-axis", choices=["auto", "packets", "patterns", "both"],
                   default="auto",
                   help="with --sharded: packets (data parallel), patterns (each device "
                        "holds 1/N of the rule set), both (2-D mesh), or auto (patterns "
                        "for table-route sets on more than one device)")
    for flag in ("--offsets", "--distributed"):
        p.add_argument(flag, action="store_true", help="not yet ported")
    p.add_argument("--dump-matches", metavar="OUT.pcap", help="not yet ported")
    p.add_argument("--host-workers", type=int, default=0, metavar="N", help="not yet ported")
    p.add_argument("--json", action="store_true")
    a = p.parse_args(argv)
    if a.per_packet and not a.json:
        raise SystemExit("--per-packet produces an [N, P] matrix: use --json")
    unported = [f for f, on in (("--offsets", a.offsets), ("--dump-matches", a.dump_matches),
                                ("--host-workers", a.host_workers),
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
    shard_axis = a.shard_axis
    if a.sharded:
        if shard_axis == "auto":
            from multithreading_string_matching_tpu_torch.parallel.mesh import default_devices
            from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
                choose_shard_axis,
            )

            shard_axis = choose_shard_axis(matcher, len(default_devices(matcher.device.type)))
    elif shard_axis != "auto":
        raise SystemExit("--shard-axis requires --sharded")
    if a.flows and a.stream:
        return _match_flow_stream(a, matcher, timer)
    if a.flows:
        return _match_flows(a, matcher, timer, shard_axis)

    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap

    with timer.phase("ingest"):
        pcap = read_pcap(a.pcap)
    with timer.phase("extract"):
        batch = extract_payloads(pcap, a.mode, pad_n_to=128, pad_len_to=8,
                                 vlan=a.vlan, ipv6=a.ipv6)
    with timer.phase("scan"):
        if a.sharded and a.per_packet:
            counts = _sharded_rows(a, matcher, shard_axis, batch.payloads, batch.lengths)
        elif a.sharded:
            counts = _sharded_counts(a, matcher, shard_axis, batch.payloads, batch.lengths)
        else:
            counts = matcher.count_batch(batch, per_packet=a.per_packet)
    if a.json:
        blob = {
            "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
            "counts": np.asarray(counts).tolist(),
            "packets": batch.num_packets,
            "valid_payloads": int(batch.valid.sum()),
            "payload_bytes": batch.total_payload_bytes,
            "phases": timer.phases,
            "execution": _execution_blob(matcher, a.sharded, attribution=a.sharded and a.per_packet,
                                         shard_axis=shard_axis if a.sharded else None),
        }
        if a.sharded:
            blob["execution"]["shard_axis"] = shard_axis
        _print_json(blob)
    else:
        _report(matcher, _exact_counts(counts), timer.total)
        print(f"# {timer.summary()}", file=sys.stderr)
    return 0


def _sharded_counts(a, matcher, shard_axis: str, payloads, lengths) -> np.ndarray:
    """Totals over the mesh of ``--shard-axis``: the pattern axis through
    parallel/pattern_shard.py, the packet axis through parallel/mesh.py
    (whose AC engine is not yet ported: ``--engine ac`` exits 1 there)."""
    dev_type = matcher.device.type
    if shard_axis in ("patterns", "both"):
        from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
            count_matches_pattern_sharded,
            resolve_shard_mesh,
        )

        return count_matches_pattern_sharded(
            matcher, payloads, lengths, resolve_shard_mesh(shard_axis, device_type=dev_type),
            engine=a.engine)
    from multithreading_string_matching_tpu_torch.parallel.mesh import (
        count_matches_sharded,
        make_mesh,
    )

    eng = matcher._requested_engine(a.engine)
    if eng == "kmp":
        eng = "ac"
    return count_matches_sharded(
        None, matcher._maybe_fold(payloads), lengths, make_mesh(device_type=dev_type),
        dup_map=matcher.window.dup_map, engine=eng, window=matcher.window,
        pallas_matcher=matcher.kernels if eng == "pallas" else None)


def _sharded_rows(a, matcher, shard_axis: str, payloads, lengths) -> np.ndarray:
    """``--per-packet`` over the mesh: rows stay with their packet shard;
    the window family only (ac/kmp remap to the window form)."""
    row_eng = "pallas" if matcher._requested_engine(a.engine) == "pallas" else "window"
    dev_type = matcher.device.type
    if shard_axis in ("patterns", "both"):
        from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
            count_rows_pattern_sharded,
            resolve_shard_mesh,
        )

        return count_rows_pattern_sharded(
            matcher, payloads, lengths, resolve_shard_mesh(shard_axis, device_type=dev_type),
            engine=row_eng)
    from multithreading_string_matching_tpu_torch.parallel.mesh import (
        count_rows_sharded,
        make_mesh,
    )

    return count_rows_sharded(matcher, payloads, lengths, make_mesh(device_type=dev_type),
                              engine=row_eng)


def _print_json(blob: dict) -> None:
    import json

    print(json.dumps(blob))


def _match_flows(a, matcher, timer, shard_axis: str) -> int:
    """One-shot ``--flows``: reassemble every flow, count over the streams."""
    from multithreading_string_matching_tpu_torch.io.flows import extract_flows
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap

    with timer.phase("ingest"):
        pcap = read_pcap(a.pcap)
    with timer.phase("extract"):
        fb = extract_flows(pcap, a.mode, reorder=a.reorder, ipv6=a.ipv6, vlan=a.vlan)
    with timer.phase("scan"):
        if a.sharded and fb.num_flows == 0:
            # The answer for a capture without flows is known.
            counts = np.zeros(len(matcher.patterns), np.int64)
        elif a.sharded:
            counts = _sharded_counts(a, matcher, shard_axis, fb.payloads, fb.lengths)
        else:
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
            "execution": _execution_blob(matcher, a.sharded,
                                         shard_axis=shard_axis if a.sharded else None),
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
    if a.sharded and a.shard_axis in ("patterns", "both"):
        # Only an explicit request errors (auto takes the lane axis here):
        # each lane's carried tail pins it to one shard.
        raise SystemExit("--flows --stream shards the flow-lane axis only: drop "
                         "--shard-axis or use --shard-axis packets")
    fs = FlowStreamMatcher(matcher, a.mode, engine=fse, reorder=a.reorder, ipv6=a.ipv6,
                           vlan=a.vlan, sharded=a.sharded)
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
