"""Worked example: flow-aware signature alerting (segment-split detection)
on the torch port.

The per-packet model (the reference's, and ``ids_demo``'s) cannot see a
signature split across two TCP segments of one connection.  This demo
reassembles 5-tuple flows and reports matches with their flow and stream
offset — then proves the point by ALSO running the per-packet scan and
printing what it missed.

    MSM_DEVICE=cpu python -m multithreading_string_matching_tpu_torch.examples.flow_ids_demo \\
        <capture.pcap> <signatures.txt> [udp|tcp]

With no arguments it synthesizes a demo capture in which every signature
occurrence straddles a segment boundary, interleaved across two flows.
``MSM_DEVICE=cpu|cuda`` (default ``cuda``, no fallback) picks the device.
The twin of the JAX package's ``examples/flow_ids_demo.py``: the same
stdout on the same inputs.
"""

import os
import pathlib
import sys
import tempfile

import numpy as np

from multithreading_string_matching_tpu_torch import Matcher, extract_payloads
from multithreading_string_matching_tpu_torch.io.flows import extract_flows, key_tuple_bytes
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher


def _demo_capture():
    from multithreading_string_matching_tpu_torch.io.synth import synth_tcp_flows_pcap

    d = pathlib.Path(tempfile.mkdtemp())
    cap, sigs = d / "demo.pcap", d / "sigs.txt"
    sigs.write_text("EVILPAYLOAD beacon")
    synth_tcp_flows_pcap(cap, [
        (("10.0.0.5", "192.168.1.9", 44123, 443),
         b"GET /a EVIL" + b"PAYLOAD ok beac" + b"on tail", [11, 15, 7]),
        (("10.0.0.7", "192.168.1.9", 44200, 443),
         b"clean traffic with beacon inside", [10, 10, 12]),
    ], interleave_seed=3)
    return str(cap), str(sigs), "tcp"


def _stream_alert(k, o, u, uniq):
    src, dst, sp, dp = key_tuple_bytes(k)
    print(f"STREAM-ALERT flow {src}:{sp} -> {dst}:{dp} @ {o}: "
          f"{uniq[u].decode('latin-1')!r}")


def main(argv):
    if len(argv) >= 2:
        cap, sigs, mode = argv[0], argv[1], (argv[2] if len(argv) > 2 else "tcp")
    else:
        cap, sigs, mode = _demo_capture()
        print(f"# no args: synthesized split-signature demo at {cap}")

    matcher = Matcher(load_patterns(sigs), device=os.environ.get("MSM_DEVICE", "cuda"))
    pcap = read_pcap(cap)

    fb = extract_flows(pcap, mode)
    rows = matcher.find_matches(fb.payloads, fb.lengths)
    uniq = matcher.window.unique_patterns
    print(f"# {fb.num_flows} flows reassembled from "
          f"{int((fb.flow_of_packet >= 0).sum())} segments")
    for f, i, u in np.asarray(rows):
        src, dst, sp, dp = fb.key_tuple(int(f))
        print(f"ALERT flow {src}:{sp} -> {dst}:{dp} @ stream byte {i}: "
              f"{uniq[u].decode('latin-1')!r}")

    # What the per-packet scan would have seen:
    batch = extract_payloads(pcap, mode, strict=True)
    per_pkt = matcher.count_batch(batch)
    missed = matcher.counts_from_match_rows(rows) - np.asarray(per_pkt)
    for p, d in zip(matcher.patterns, missed):
        if d > 0:
            print(f"# per-packet scanning would have MISSED {d} x "
                  f"{p.decode('latin-1')!r} (split across segments)")

    # The same alerts from the unbounded streaming monitor (the daemon
    # shape, `match --flows --stream --offsets`): per-flow carried tails,
    # bounded pending, positions identical to the one-shot reassembly.
    fs = FlowStreamMatcher(matcher, mode, engine="window",
                           collect_offsets=True, scan_bytes=64)
    for s in range(0, pcap.num_packets, 4):
        fs.feed_pcap_slice(slice_pcap(pcap, s, s + 4, copy=False))
        for k, o, u in fs.drain_offsets():   # alerts stream per round
            _stream_alert(k, o, u, uniq)
    fs.flush()
    for k, o, u in fs.drain_offsets():
        _stream_alert(k, o, u, uniq)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
