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
  original frames of the hit packets, in capture order;
- the flow path (:func:`flow_case`, 15% of cases): the texts as TCP flows
  with random segmentation, interleave, v6 and VLAN keys and a
  pathological wire, counted one-shot after reassembly and by a
  carried-state ``FlowStreamMatcher`` (both flow engines, a checkpoint
  and load, a same-set reload, offsets held to ``find_matches``).

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


def flow_case(pats, texts, crng, device="cuda") -> Optional[str]:
    """Repackage the case's texts as TCP flows (one text a stream, random
    segmentation, cross-flow interleave; v6 keys, VLAN tags and, half the
    time, a pathological wire: reorder, retransmit and overlap with
    ``reorder=True``) and hold both flow scans to the per-flow oracle: the
    one-shot reassembly count, and a carried-state ``FlowStreamMatcher``
    (``window`` or ``ac`` engine, random round sizes, a mid-stream
    checkpoint and load, a reload to the same set, offsets held to
    ``find_matches``).  Draws from ``crng`` exactly what
    ``bench/fuzz_soak._flow_case`` draws.  ``None`` when everything agrees,
    else what differed.

    The window-engine stream runs on a matcher whose engine is ``pallas``,
    so on the card its rounds launch ``window_count_halo`` (the JAX soak's
    ``engine="ac"`` matcher takes the plain window form there); the ``ac``
    stream launches ``ac_scan``.  On the card a stream that scanned bytes
    must have launched its kernel."""
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.flows import extract_flows, key_tuple_bytes
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
    from multithreading_string_matching_tpu_torch.io.synth import synth_tcp_flows_pcap
    from multithreading_string_matching_tpu_torch.ops import cuda_window, scan
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher

    ipv6 = bool(crng.random() < 0.3)
    pathological = bool(crng.random() < 0.5)
    vlan = bool(crng.random() < 0.3)
    flows = []
    for i, t in enumerate(texts[:12]):
        if ipv6 and crng.random() < 0.5:
            key = (f"2001:db8::{i + 1:x}", "2001:db8::ffff", 1000 + i, 80)
        else:
            key = (f"10.9.{i // 200}.{i % 200 + 1}", "10.0.0.1", 1000 + i, 80)
        segs, left = [], len(t)
        while left > 0:
            s = int(crng.integers(1, left + 1))
            segs.append(s)
            left -= s
        flows.append((key, t, segs or [0]))
    want = oracle.oracle_counts([t for _, t, _ in flows], pats)
    shape = f"ipv6={ipv6} pathological={pathological} vlan={vlan}"
    knobs = {}
    if pathological:
        knobs = dict(reorder_seed=int(crng.integers(0, 10_000)),
                     retransmit_rate=float(crng.random() * 0.5),
                     overlap_rate=float(crng.random() * 0.5))
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "flows.pcap"
        synth_tcp_flows_pcap(path, flows, interleave_seed=int(crng.integers(0, 10_000)),
                             seed=int(crng.integers(0, 10_000)),
                             vlan_rate=0.5 if vlan else 0.0, **knobs)
        pcap = read_pcap(path)
        fb = extract_flows(pcap, "tcp", ipv6=ipv6, reorder=pathological, vlan=vlan)
        m = Matcher(pats, engine="window", device=device)
        got = m.count(fb.payloads, fb.lengths).tolist() if fb.num_flows else [0] * len(pats)
        if got != want:
            return f"flows one-shot ({shape}): got {got} want {want}"
        fse = "window" if crng.random() < 0.4 else "ac"
        offsets_on = fse == "window" and bool(crng.random() < 0.7)
        stream_engine = "pallas" if fse == "window" else "ac"

        def mk_fs():
            # Pathological captures need the whole capture in one round (the
            # streaming reorder window); in-order captures fuzz small rounds.
            return FlowStreamMatcher(
                Matcher(pats, engine=stream_engine, device=device), "tcp", engine=fse,
                scan_bytes=(1 << 30) if pathological else int(crng.integers(1, 64)),
                width=int(crng.choice([8, 32, 128])), min_lanes=8, reorder=pathological,
                ipv6=ipv6, vlan=vlan, collect_offsets=offsets_on)

        kernel = "window_count_halo" if fse == "window" else "ac_scan"
        launches = cuda_window.LAUNCHES if fse == "window" else scan.LAUNCHES
        before = launches[kernel]
        fs = mk_fs()
        step = int(crng.integers(1, 6))
        ckpt_at = int(crng.integers(0, pcap.num_packets + 1)) if crng.random() < 0.3 else None
        # A same-set reload mid-capture: the window engine's tails carry, so
        # both epochs' counts add up to the oracle and the offsets (bases
        # persist) to the one-shot find.  In-order captures only: a forced
        # round would split a scrambled capture's reordering.
        reload_at = (int(crng.integers(0, pcap.num_packets + 1))
                     if fse == "window" and not pathological and crng.random() < 0.25
                     else None)
        shape += f" engine={fse} step={step} checkpoint_at={ckpt_at} reload_at={reload_at}"
        epoch_counts = np.zeros(len(pats), np.int64)
        collected = []
        for s0 in range(0, pcap.num_packets, step):
            if ckpt_at is not None and s0 >= ckpt_at:
                ck = fs.save(pathlib.Path(d) / "ck")
                fs = mk_fs()
                fs.load(ck)
                ckpt_at = None
            if reload_at is not None and s0 >= reload_at:
                fs.flush()
                if offsets_on:
                    collected.extend(fs.drain_offsets())
                epoch_counts += fs.reload(Matcher(pats, engine=stream_engine, device=device))
                reload_at = None
            fs.feed_pcap_slice(slice_pcap(pcap, s0, s0 + step, copy=False))
        fs.flush()
        total = (epoch_counts + fs.counts()).tolist()
        if total != want:
            return f"flow stream ({shape}): got {total} want {want}"
        if torch.device(device).type == "cuda" and any(t for _, t, _ in flows) \
                and launches[kernel] == before:
            return f"flow stream ({shape}): scanned bytes without a {kernel} launch"
        if offsets_on:
            hits = collected + fs.drain_offsets()
            bc = np.bincount([u for _, _, u in hits],
                             minlength=len(m.window.unique_patterns))[m.window.dup_map]
            rows = (np.asarray(m.find_matches(fb.payloads, fb.lengths)) if fb.num_flows
                    else np.zeros((0, 3), np.int64))
            want_tr = sorted((fb.key_tuple(int(f)), int(i), int(u)) for f, i, u in rows)
            got_tr = sorted((key_tuple_bytes(k), int(o), int(u)) for k, o, u in hits)
            if got_tr != want_tr or bc.tolist() != want:
                return (f"flow stream offsets ({shape}): got {got_tr[:8]} want {want_tr[:8]} "
                        f"bincount {bc.tolist()} counts {want}")
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
    ran = {"engines": 0, "per_packet": 0, "table": 0, "find": 0, "streamed": 0, "flows": 0}

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
    if crng.random() < 0.15:
        bad = flow_case(pats, texts, crng, device)
        if bad is not None:
            fail(bad)
        ran["flows"] += 1
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
