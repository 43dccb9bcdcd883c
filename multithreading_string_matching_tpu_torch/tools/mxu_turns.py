"""Time other builds of the tensor-core kernel against ``csrc/mxu_count.cu``,
in turns, on one card::

    python -m multithreading_string_matching_tpu_torch.tools.mxu_turns \\
        OTHER.cu [OTHER.cu ...] [--rounds R] [--packets N]

Each ``OTHER.cu`` is a source with the C interface of ``csrc/mxu_count.cu``:
an earlier version of the kernel, or a copy with a part taken out.  It is
called through ``msm_mxu_count_live`` with the live pattern count where it
has that entry point, as the kernel is, else through ``msm_mxu_count``
(every padded slot).  Each is built with the
package's ``nvcc`` flags into its own library under the package's
``build/``.  The workload is ``chip_smoke.py``'s phase 3: the stand-in
pattern set (deduplicated) over the staged tiles of a seeded capture of
``--packets`` UDP packets of 1,024 +- 256 payload bytes (seed 1, 5% planted),
one launch per non-empty tile, each adding into one zeroed buffer (as
``MxuMatcher`` does).  Every build's totals must equal the
kernel's (a copy with a part taken out may differ, and is reported as
such).  Then, ``--rounds`` times, each build is timed (CUDA events, median
of 20 passes) in the order kernel, others, others reversed, kernel, so
drift within the call falls on all alike; after the rounds, the device
time of one pass of each, queued alone behind a sleep
(``utils.timing.queued_ms``, median of 3: without the host's launch
cost).  Prints one JSON object: the median of each build's times, the
times themselves, the device times, the card's name and power limit, and
the payload bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import sys
import tempfile

import torch

from multithreading_string_matching_tpu_torch.utils.timing import card_line, cuda_ms, queued_ms

RUNS = 20
PACKETS = 100_000
SEED = 1


def build_other(path: pathlib.Path):
    """``(library, entry point)``: ``path`` built, and ``msm_mxu_count_live``
    where it has it, else ``msm_mxu_count``."""
    from multithreading_string_matching_tpu_torch.ops._build import KernelLibrary
    from multithreading_string_matching_tpu_torch.ops.mxu import LIBRARY

    tag = hashlib.sha256(path.read_bytes()).hexdigest()[:10]
    for entry in ("msm_mxu_count_live", "msm_mxu_count"):
        lib = KernelLibrary(f"msm_mxu_other_{tag}", [path],
                            {entry: LIBRARY.signatures[entry]})
        try:
            lib.load()
        except AttributeError:  # no such entry point
            continue
        return lib, entry
    raise RuntimeError(f"{path} exports neither msm_mxu_count_live nor msm_mxu_count")


def phase3_tiles(device, packets: int):
    """(deduplicated stand-in patterns, staged tiles, payload bytes)."""
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
    from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap
    from multithreading_string_matching_tpu_torch.tools.mxu_match import STANDIN

    patterns = load_patterns(STANDIN)
    with tempfile.TemporaryDirectory() as d:
        cap = pathlib.Path(d) / "standin.pcap"
        synth_udp_pcap(cap, packets, payload_len=1024, payload_len_jitter=256,
                       patterns=patterns, plant_rate=0.05, seed=SEED)
        batch = extract_payloads(read_pcap(cap), "udp", pad_n_to=128, pad_len_to=8)
    matcher = Matcher(patterns, device=device)
    prep = matcher.prepare_batch(batch, packed="auto")
    return list(matcher.window.unique_patterns), prep.tiles, prep.total_payload_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--packets", type=int, default=PACKETS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mxu_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multithreading_string_matching_tpu_torch.ops import mxu

    dev = torch.device("cuda")
    uniq, tiles, nbytes = phase3_tiles(dev, args.packets)
    m = mxu.MxuMatcher(uniq, dev)
    P, tgt = m._P, m._tgt
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = [p for p, _ in tiles if p.numel()]

    def caller(lib, entry):
        live = (len(uniq),) if entry == "msm_mxu_count_live" else ()

        def count_all():  # every launch adds into one zeroed buffer, as the kernel's pass does
            total = torch.zeros(P.shape[0], dtype=torch.int32, device=dev)
            for p in tiles:
                lib.call(entry, p.data_ptr(), P.data_ptr(), tgt.data_ptr(), total.data_ptr(),
                         p.shape[0], p.shape[1], P.shape[0], P.shape[1], 1, *live,
                         dev.index or 0, stream)
            return total
        return count_all

    builds = [("kernel", lambda: m.count_tiles([(p, None) for p in tiles]))]
    builds += [(str(path), caller(*build_other(path))) for path in args.others]
    want = builds[0][1]()
    equal = {}
    for name, fn in builds[1:]:
        equal[name] = bool(torch.equal(fn()[: len(uniq)], want))
    order = builds[:1] + builds[1:] + builds[1:][::-1] + builds[:1]
    times = {name: [] for name, _ in builds}
    for _ in range(args.rounds):
        for name, fn in order:
            times[name].append(cuda_ms(fn, RUNS))
    device = {}
    for name, fn in builds:
        ms, clean = queued_ms(fn)
        device[name] = ms if clean else None
    print(json.dumps({
        "medians_ms": {k: statistics.median(v) for k, v in times.items()},
        "times_ms": times, "device_ms": device, "totals_equal_kernel": equal, "matches": int(want.sum()),
        "tiles": len(tiles), "payload_bytes": int(nbytes), "card": card_line(),
        "kind": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
