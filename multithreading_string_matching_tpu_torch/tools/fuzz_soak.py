"""Randomized engine soak: every engine of the port against the oracle.

Counterpart of ``bench/fuzz_soak.py``::

    python -m multithreading_string_matching_tpu_torch.tools.fuzz_soak
        [--minutes M] [--seed K] [--device cuda|cpu]

It rolls fresh random cases (patterns with NULs, duplicates and extreme
lengths, binary payloads over small and full alphabets, case folding) until
the time budget runs out, and diffs every engine of ``Matcher``
(``auto``, ``pallas``, ``window``, ``ac``, ``kmp``) against the pure-Python
oracle (``tools/oracle.py``).  Sampled sub-checks per case:

- per-packet count matrices against a per-text oracle (not only their
  column sums);
- the table route: the set grown past 512 pattern words, so that
  ``pallas`` takes the table kernels with the filter;
- ``find_matches`` triples against the ``bytes.find`` position oracle
  (every ``(packet, start, unique_pattern)`` triple, overlapping starts
  included), and the counts <-> rows invariant of
  ``counts_from_match_rows``;
- the full streamed pipeline: the payloads wrapped as UDP frames
  (``io/synth.py``) in a classic pcap, a pcapng or a gzipped classic pcap
  (the port's writer), counted by ``count_pcap_streamed`` at random batch
  sizes with and without host workers, or scanned by
  ``scan_pcap_streamed(offsets=True)`` with its triples held to the
  position oracle and (half the time) its ``--dump-matches`` file to the
  original frames of the hit packets, in capture order.

The device is ``cuda`` by default (the kernels; without a card it exits
non-zero); ``--device cpu`` runs the plain versions.  Case ``i`` of a run
draws everything from ``default_rng(case_seed)``, ``case_seed`` the
``i``-th draw of ``default_rng(seed)``.  On the first divergence it prints
a reproducer (seed, case, ``case_seed``, the patterns) and raises
:class:`Divergence`: the run exits non-zero.
"""

from __future__ import annotations

import argparse
import pathlib
import struct
import sys
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.tools import oracle
from multithreading_string_matching_tpu_torch.tools.differential import Divergence, check_device

ENGINES = ("auto", "pallas", "window", "ac", "kmp")
TABLE_WORDS = 512  # api.PALLAS_TABLE_WORDS: more words take the table kernels
# ASCII case folding, as Matcher(case_insensitive=True) folds.
FOLD = bytes(range(65)) + bytes(range(97, 123)) + bytes(range(91, 256))


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def random_case(rng: np.random.Generator):
    """``(patterns, payloads uint8[n, L], lengths int32[n])``: 1-23 patterns
    of 1-96 bytes over 2, 3, 5 or 256 symbols, a NUL inside some, a
    duplicate now and then; rows over 2-256 symbols with planted hits;
    ``n`` and ``L`` powers of two, lengths 0..L."""
    pats = []
    for _ in range(int(rng.integers(1, 24))):
        m = int(rng.integers(1, 33)) if rng.random() < 0.9 else int(rng.integers(33, 97))
        alpha = int(rng.choice([2, 3, 5, 256]))
        p = rng.integers(0, alpha, size=m).astype(np.uint8)
        if rng.random() < 0.1:
            p[rng.integers(0, m)] = 0
        pats.append(p.tobytes())
    if len(pats) > 1 and rng.random() < 0.3:
        pats.append(pats[int(rng.integers(0, len(pats)))])
    n = _pow2(int(rng.integers(1, 65)))
    lmax = _pow2(int(rng.integers(1, 301)))
    alpha = int(rng.choice([2, 3, 5, 17, 256]))
    payloads = rng.integers(0, alpha, size=(n, lmax)).astype(np.uint8)
    lengths = rng.integers(0, lmax + 1, size=n).astype(np.int32)
    for _ in range(min(4, n)):
        i = int(rng.integers(0, n))
        p = pats[int(rng.integers(0, len(pats)))]
        if len(p) <= lengths[i]:
            off = int(rng.integers(0, lengths[i] - len(p) + 1))
            payloads[i, off : off + len(p)] = np.frombuffer(p, np.uint8)
    return pats, payloads, lengths


def case_inputs(case_seed: int):
    """``(crng, patterns, payloads, lengths, nocase)`` of one case: its
    generator after the draws, for the sampled sub-checks."""
    crng = np.random.default_rng(case_seed)
    pats, payloads, lengths = random_case(crng)
    return crng, pats, payloads, lengths, bool(crng.random() < 0.2)


def table_fillers(rng, pats) -> List[bytes]:
    """Patterns over the case's own bytes that take the set past
    ``TABLE_WORDS`` pattern words (the table route), some of them present in
    the payloads as pieces of the case's patterns."""
    alphabet = np.unique(np.frombuffer(b"".join(pats), np.uint8))
    words = sum(-(-len(p) // 4) for p in dict.fromkeys(pats))
    out = []
    while words <= TABLE_WORDS:
        m = int(rng.integers(4, 65))
        p = bytes(rng.choice(alphabet, size=m).tolist())
        if rng.random() < 0.2:
            p = pats[int(rng.integers(len(pats)))] + p[:4]
        if p not in out and p not in pats:
            out.append(p)
            words += -(-len(p) // 4)
    return out


def udp_frames(texts) -> List[bytes]:
    from multithreading_string_matching_tpu_torch.io.synth import _eth_ipv4

    return [_eth_ipv4(t) for t in texts]


def write_capture(path: pathlib.Path, frames, fmt: int) -> pathlib.Path:
    """``frames`` as a classic pcap (``fmt`` 0, the port's writer), a
    pcapng (1) or a gzipped classic pcap (2); returns the file's path."""
    if fmt == 1:
        blob = bytearray()

        def block(btype, body):
            pad = (-len(body)) % 4
            blen = 12 + len(body) + pad
            blob.extend(struct.pack("<II", btype, blen) + body + b"\x00" * pad
                        + struct.pack("<I", blen))

        block(0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
        block(0x00000001, struct.pack("<HHI", 1, 0, 65535))
        for fr in frames:
            block(0x00000006, struct.pack("<IIIII", 0, 0, 0, len(fr), len(fr)) + fr)
        path = path.with_suffix(".pcapng")
        path.write_bytes(bytes(blob))
        return path
    from multithreading_string_matching_tpu_torch.io.pcap import PcapFile, write_pcap

    lens = np.array([len(f) for f in frames], np.int64)
    pcap = PcapFile(
        buf=np.frombuffer(b"".join(frames), np.uint8).copy(),
        offsets=np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64),
        caplens=lens, origlens=lens.copy(), ts_sec=np.arange(len(frames), dtype=np.int64),
        ts_frac=np.zeros(len(frames), np.int64), linktype=1, snaplen=65535, nanos=False)
    path = path.with_suffix(".pcap.gz" if fmt == 2 else ".pcap")
    write_pcap(path, pcap)
    return path


def streamed_case(m, texts, crng, folded_texts, uniq, want) -> Optional[str]:
    """Round-trip the payloads through the streamed pipeline; ``None`` when
    it agrees with the oracle, else what differed."""
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
    from multithreading_string_matching_tpu_torch.parallel.pipeline import (
        count_pcap_streamed,
        scan_pcap_streamed,
    )

    frames = udp_frames(texts)
    fmt = int(crng.integers(0, 3))
    bp = int(crng.choice([3, 64, 8192]))
    hw = int(crng.choice([0, 2]))
    attribution = bool(crng.random() < 0.4)
    dump = attribution and bool(crng.random() < 0.5)
    shape = f"fmt={fmt} batch_packets={bp} host_workers={hw} offsets={attribution} dump={dump}"
    with tempfile.TemporaryDirectory() as d:
        path = write_capture(pathlib.Path(d) / "case", frames, fmt)
        if not attribution:
            got = count_pcap_streamed(m, path, "udp", batch_packets=bp, host_workers=hw)
            return None if np.array_equal(np.asarray(got), want) else \
                f"count_pcap_streamed {shape}: got {np.asarray(got).tolist()}"
        dump_path = pathlib.Path(d) / "dump.pcap" if dump else None
        got, rows = scan_pcap_streamed(m, path, "udp", offsets=True, batch_packets=bp,
                                       host_workers=hw, dump_path=dump_path)
        if not np.array_equal(np.asarray(got), want):
            return f"scan_pcap_streamed {shape}: got {np.asarray(got).tolist()}"
        got_rows = sorted(map(tuple, np.asarray(rows).tolist()))
        if got_rows != oracle.match_positions(folded_texts, uniq):
            return f"scan_pcap_streamed offsets {shape}: got {got_rows[:12]}"
        if dump:
            hits = sorted({r[0] for r in got_rows})
            got_frames = []
            if dump_path.exists():
                dp = read_pcap(dump_path)
                got_frames = [dp.packet(i).tobytes() for i in range(dp.num_packets)]
            if got_frames != [frames[i] for i in hits]:
                return f"--dump-matches {shape}: {len(got_frames)} frames for {len(hits)} hits"
    return None


def fuzz_case(case_seed: int, device="cuda") -> dict:
    """Run one case; raise :class:`Divergence` (after printing what
    differed) on the first disagreement.  Returns what the case ran."""
    from multithreading_string_matching_tpu_torch.api import Matcher

    crng, pats, payloads, lengths, nocase = case_inputs(case_seed)
    texts = [payloads[i, : lengths[i]].tobytes() for i in range(len(lengths))]
    folded_texts = [t.translate(FOLD) for t in texts] if nocase else texts
    match_pats = [p.translate(FOLD) for p in pats] if nocase else pats
    want = np.array(oracle.oracle_counts(folded_texts, match_pats))
    ran = {"engines": 0, "per_packet": 0, "table": 0, "find": 0, "streamed": 0}

    def fail(what: str):
        print(f"DIVERGENCE {what}\n  case_seed={case_seed} nocase={nocase} device={device}\n"
              f"  patterns={pats}\n  again: python -c \"from multithreading_string_matching_"
              f"tpu_torch.tools.fuzz_soak import fuzz_case; fuzz_case({case_seed}, "
              f"'{torch.device(device).type}')\"", flush=True)
        raise Divergence(what)

    def engines_agree(m, pats_m, want_m, engines, label=""):
        for engine in engines:
            got = np.asarray(m.count(payloads, lengths, engine=engine))
            ran["engines"] += 1
            if not np.array_equal(got, want_m):
                fail(f"{label}engine={engine}: got {got.tolist()} want {want_m.tolist()}")
            if crng.random() < 0.3:
                pp = np.asarray(m.count(payloads, lengths, engine=engine, per_packet=True))
                ran["per_packet"] += 1
                want_pp = np.array(oracle.oracle_matrix(folded_texts, pats_m)).reshape(pp.shape)
                if not np.array_equal(pp, want_pp):
                    fail(f"{label}engine={engine} per-packet matrix")

    m = Matcher(pats, case_insensitive=nocase, device=device)
    engines_agree(m, match_pats, want, ENGINES)
    if crng.random() < 0.2:
        fillers = table_fillers(crng, pats)
        big = Matcher(pats + fillers, case_insensitive=nocase, device=device)
        if big.explain()["pallas_kernel"] not in ("table+filter", "table"):
            fail(f"{len(fillers)} fillers did not take the table route: {big.explain()}")
        big_pats = [p.translate(FOLD) for p in big.patterns] if nocase else big.patterns
        big_want = np.array(oracle.oracle_counts(folded_texts, big_pats))
        engines_agree(big, big_pats, big_want, ("pallas",), "table route ")
        ran["table"] += 1
    uniq = [bytes(p) for p in m.window.unique_patterns]
    if crng.random() < 0.25:
        rows = np.asarray(m.find_matches(payloads, lengths))
        got_rows = sorted(map(tuple, rows.tolist()))
        if got_rows != oracle.match_positions(folded_texts, uniq):
            fail(f"find_matches: got {got_rows[:12]}")
        if not np.array_equal(m.counts_from_match_rows(rows.reshape(-1, 3)), want):
            fail("counts_from_match_rows differs from the counts")
        ran["find"] += 1
    if crng.random() < 0.25:
        bad = streamed_case(m, texts, crng, folded_texts, uniq, want)
        if bad is not None:
            fail(bad)
        ran["streamed"] += 1
    return ran


def soak(minutes: float, seed: int, device="cuda", max_cases: Optional[int] = None,
         log=print) -> Tuple[int, dict]:
    """Cases until ``minutes`` have passed (or ``max_cases`` ran): returns
    ``(cases, sub-check totals)``; raises :class:`Divergence` on the
    first disagreement."""
    device = check_device(device)
    rng = np.random.default_rng(seed)
    deadline = time.monotonic() + minutes * 60
    cases, totals = 0, {}
    while time.monotonic() < deadline and (max_cases is None or cases < max_cases):
        case_seed = int(rng.integers(0, 2**63))
        try:
            ran = fuzz_case(case_seed, device)
        except Divergence:
            log(f"  seed={seed} case={cases}")
            raise
        for k, v in ran.items():
            totals[k] = totals.get(k, 0) + v
        cases += 1
        if cases % 50 == 0:
            log(f"{cases} cases clean, {deadline - time.monotonic():.0f} s left")
    return cases, totals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = check_device(args.device)
    t0 = time.perf_counter()
    cases, totals = soak(args.minutes, args.seed, device)
    where = "cpu: plain versions"
    if device.type == "cuda":
        from multithreading_string_matching_tpu_torch.utils.timing import card_line

        where = card_line()
    print(f"soak clean: {cases} cases, seed={args.seed}, {totals}, "
          f"{time.perf_counter() - t0:.1f} s [{where}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
