"""Command line of the torch package: the one-shot commands.

Counterpart of ``multithreading_string_matching_tpu/cli.py``::

  python -m multithreading_string_matching_tpu_torch serial <file.pcap> <strings.txt> [udp/tcp]
  python -m multithreading_string_matching_tpu_torch match  --pcap F --patterns F
        [--mode udp|tcp] [--engine auto|pallas|window|ac|kmp] [--nocase]
        [--per-packet] [--json]

``MSM_DEVICE=cpu|cuda`` (default ``cuda``) picks the device, as
``MSM_PLATFORM`` does for the JAX package: ``cuda`` runs the hand-written
kernels and fails without a card, ``cpu`` runs their plain versions.
Output is byte-compatible with the reference's report (utils/report.py).
The other commands (data, task, live, mesh, synth) and match's flow,
streaming, sharding and offset options are not yet ported (ROADMAP).
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


def cmd_match(argv: List[str]) -> int:
    """One-shot scan with explicit flags."""
    p = argparse.ArgumentParser(prog="match")
    p.add_argument("--pcap", required=True, help="capture file")
    p.add_argument("--patterns", required=True)
    p.add_argument("--mode", choices=["udp", "tcp"], default="udp")
    p.add_argument("--engine", choices=["auto", "pallas", "window", "ac", "kmp"],
                   default="pallas")
    p.add_argument("--nocase", action="store_true",
                   help="ASCII case-insensitive matching (patterns and payloads folded)")
    p.add_argument("--per-packet", action="store_true")
    p.add_argument("--json", action="store_true")
    a = p.parse_args(argv)
    if a.per_packet and not a.json:
        raise SystemExit("--per-packet produces an [N, P] matrix: use --json")

    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
    from multithreading_string_matching_tpu_torch.utils.timing import PhaseTimer

    matcher = _build(a.patterns, engine=a.engine, nocase=a.nocase)
    timer = PhaseTimer()
    with timer.phase("ingest"):
        pcap = read_pcap(a.pcap)
    with timer.phase("extract"):
        batch = extract_payloads(pcap, a.mode, pad_n_to=128, pad_len_to=8)
    with timer.phase("scan"):
        counts = matcher.count_batch(batch, per_packet=a.per_packet)
    if a.json:
        import json

        blob = {
            "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
            "counts": np.asarray(counts).tolist(),
            "packets": batch.num_packets,
            "valid_payloads": int(batch.valid.sum()),
            "payload_bytes": batch.total_payload_bytes,
            "phases": timer.phases,
            "execution": matcher.explain(),
        }
        print(json.dumps(blob))
    else:
        _report(matcher, _exact_counts(counts), timer.total)
        print(f"# {timer.summary()}", file=sys.stderr)
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
