"""Worked example: a minimal IDS-style alerter on the torch port.

Loads a signature list, scans a capture (file or live interface), and
prints one alert line per match occurrence with packet number, byte
offset, and the matched signature — the kind of tool the reference's five
C programs approximate with count-only output.

    python -m multithreading_string_matching_tpu_torch.examples.ids_demo \\
        <capture.pcap|iface> <signatures.txt> [udp|tcp]

On a capture file it runs the one-shot scan + offset extraction; on an
interface (requires CAP_NET_RAW) it streams until Ctrl-C and prints the
count report on shutdown, like live_openmp_task.c.  ``MSM_DUMP=out.pcap``
also writes the matching packets.  ``MSM_DEVICE=cpu|cuda`` (default
``cuda``, no fallback) picks the device, as for the CLI.  The twin of the
JAX package's ``examples/ids_demo.py``: the same stdout on the same inputs.
"""

import os
import sys

import numpy as np

from multithreading_string_matching_tpu_torch import (
    Matcher,
    extract_payloads,
    load_patterns,
    read_pcap,
)


def _matcher(patterns_path) -> Matcher:
    return Matcher(load_patterns(patterns_path), engine="auto",
                   device=os.environ.get("MSM_DEVICE", "cuda"))


def scan_file(path, patterns_path, mode):
    matcher = _matcher(patterns_path)
    pcap = read_pcap(path)
    batch = extract_payloads(
        pcap, mode, pad_n_to=128, pad_len_to=8, vlan=True, ipv6=True
    )
    # ONE find_matches pass yields the alerts, the totals (bincount of the
    # occurrence rows), and the dump selection.
    rows = np.asarray(matcher.find_matches(batch.payloads, batch.lengths))
    uniq = matcher.window.unique_patterns
    valid_idx = np.flatnonzero(batch.valid)
    for pkt, start, u in rows:
        sig = uniq[u].decode("latin-1")
        # ORIGINAL capture packet numbers (find_matches rows index the valid
        # payload rows), consistent with the MSM_DUMP selection below.
        print(
            f"ALERT packet={valid_idx[pkt]} offset={start} signature={sig!r}"
        )
    total = int(matcher.counts_from_match_rows(rows).sum())  # dup-expanded
    print(f"# {total} matches in {batch.num_packets} packets "
          f"({batch.total_payload_bytes} payload bytes)")
    if os.environ.get("MSM_DUMP"):
        from multithreading_string_matching_tpu_torch import write_pcap

        hit_rows = np.unique(rows[:, 0]) if len(rows) else []
        wrote = write_pcap(os.environ["MSM_DUMP"], pcap, valid_idx[hit_rows])
        print(f"# wrote {wrote} matching packets to {os.environ['MSM_DUMP']}")
    return 0


def scan_live(iface, patterns_path, mode):
    from multithreading_string_matching_tpu_torch.io.live import LiveSource
    from multithreading_string_matching_tpu_torch.parallel.stream import StreamMatcher
    from multithreading_string_matching_tpu_torch.utils.report import format_report

    matcher = _matcher(patterns_path)
    # Defaults give the serving shape: packed tiles (one launch per tile,
    # not per batch) and the kernel-level BPF protocol filter + promiscuous
    # open an IDS tap needs.
    stream = StreamMatcher(matcher)
    stream.install_sigint()
    try:
        with LiveSource(iface, filter_mode=mode, promiscuous=True) as src:
            for pcap_slice in src:
                stream.feed_pcap_slice(pcap_slice, mode=mode)
                if stream.stopped:
                    break
    finally:
        stream.uninstall_sigint()
    print(format_report(matcher.patterns, stream.counts(), None,
                        sniffed=stream.packets_seen, oops_line=True))
    return 0


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    target, patterns_path = argv[0], argv[1]
    mode = argv[2] if len(argv) > 2 else "udp"
    if os.path.exists(target):
        return scan_file(target, patterns_path, mode)
    return scan_live(target, patterns_path, mode)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
