"""Measure the matrix-unit formulation of exact byte matching against the
table kernels, on one card.

Counterpart of ``main()`` in ``bench/mxu_match.py``::

    python -m multithreading_string_matching_tpu_torch.tools.mxu_match
        [--device cuda|cpu] [--packets N]

It writes the seeded corpus (``PACKETS`` UDP packets of 1,024 +- 256
payload bytes, ``pt000000`` planted in 2% of them, seed 3) to a temporary
file, reads it back, stages it with ``Matcher.prepare_batch(packed="auto")``
and counts three pattern sets with :class:`MxuMatcher` (ops/mxu.py) and
with the table kernels (``CudaTableMatcher(assume_zero_padded=True)``):
the stand-in pattern file deduplicated, ``pt%06d`` x 768 and
``pt%06d`` x 3,072.  The two totals must be equal.  On the card it times
both with CUDA events (median of ``RUNS``) and prints one JSON row per set
with ``mxu_bytes_per_sec`` and ``table_bytes_per_sec`` (real payload bytes
per second) and ``mxu_bound_ms`` (the product's :func:`mxu_ops` int8
operations at the H100's 1,979 TOP/s) beside the card's name and power
limit.

``--device`` defaults to ``$MSM_DEVICE`` or ``cuda``; without a card that
exits non-zero.  ``--device cpu`` runs the plain versions and prints the
counts only: it times nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
from typing import List, Tuple

import torch

from multithreading_string_matching_tpu_torch.utils.timing import card_line, cuda_ms

PACKETS = 10_000
SEED = 3
RUNS = 20
WARMUP = 2
INT8_TENSOR_OPS_PER_S = 1.979e15  # H100 SXM, dense int8, NVIDIA's data sheet
STANDIN = pathlib.Path(__file__).resolve().parent.parent / "data" / "strings_standin.txt"


def mxu_ops(nbytes: int, num_patterns: int, m_max: int) -> int:
    """The score product's int8 operations: a multiply and an add per
    (payload position, pattern, bit column), ``C = 8 * m_max`` columns."""
    return 2 * nbytes * num_patterns * 8 * m_max


def pattern_sets() -> List[Tuple[str, List[bytes]]]:
    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns

    return [
        ("standin", list(dict.fromkeys(load_patterns(STANDIN)))),
        ("pt768", [b"pt%06d" % i for i in range(768)]),
        ("pt3072", [b"pt%06d" % i for i in range(3072)]),
    ]


def corpus(packets: int = PACKETS):
    """The seeded capture's decoded payload batch."""
    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
    from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap

    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "mxu_corpus.pcap"
        synth_udp_pcap(path, packets, payload_len=1024, payload_len_jitter=256,
                       patterns=[b"pt000000"], plant_rate=0.02, seed=SEED)
        return extract_payloads(read_pcap(path), "udp")


def measure(batch, name: str, patterns: List[bytes], device) -> dict:
    """One JSON row: the two matchers' totals (which must agree) and, on the
    card, their times and rates."""
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.ops.cuda_table import CudaTableMatcher
    from multithreading_string_matching_tpu_torch.ops.mxu import MxuMatcher

    device = torch.device(device)
    m = Matcher(patterns, device=device)
    prep = m.prepare_batch(batch, packed="auto")
    mxu = MxuMatcher(patterns, device)
    table = CudaTableMatcher(m.window, device, assume_zero_padded=True)
    got = mxu.count_tiles(prep.tiles)
    want = table.count_tiles(prep.tiles, expand_duplicates=False)
    if not torch.equal(got, want):
        raise RuntimeError(f"{name}: mxu counts differ from the table kernels'")
    nbytes = int(batch.total_payload_bytes)
    row = {"set": name, "patterns": len(patterns), "m_max": mxu.m_max,
           "tiles": sum(1 for p, _ in prep.tiles if p.numel()), "packed": prep.packed,
           "payload_bytes": nbytes, "matches": int(got.sum()), "device": str(device)}
    if device.type == "cuda":
        mxu_ms = cuda_ms(lambda: mxu.count_tiles(prep.tiles), RUNS, WARMUP)
        table_ms = cuda_ms(lambda: table.count_tiles(prep.tiles, expand_duplicates=False), RUNS, WARMUP)
        ops = mxu_ops(nbytes, len(patterns), mxu.m_max)
        row.update(mxu_ms=mxu_ms, table_ms=table_ms, mxu_bytes_per_sec=nbytes / mxu_ms * 1e3,
                   table_bytes_per_sec=nbytes / table_ms * 1e3,
                   mxu_bound_ms=ops / INT8_TENSOR_OPS_PER_S * 1e3, card=card_line(),
                   kind=torch.cuda.get_device_name(device))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=os.environ.get("MSM_DEVICE", "cuda"))
    ap.add_argument("--packets", type=int, default=PACKETS)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("mxu_match: CUDA is not available (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    batch = corpus(args.packets)
    for name, pats in pattern_sets():
        print(json.dumps(measure(batch, name, pats, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
