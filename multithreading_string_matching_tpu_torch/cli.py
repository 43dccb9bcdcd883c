"""Command line of the torch package: the reference's programs as commands.

Counterpart of ``multithreading_string_matching_tpu/cli.py``::

  python -m multithreading_string_matching_tpu_torch serial <file.pcap> <strings.txt> [udp/tcp]
  python -m multithreading_string_matching_tpu_torch data   <file.pcap> <strings.txt> [threads] [udp/tcp]
  python -m multithreading_string_matching_tpu_torch task   <file.pcap> <strings.txt> [threads] [udp/tcp]
  python -m multithreading_string_matching_tpu_torch live   <interface> <strings.txt> [threads] [udp/tcp]
        [--dump-matches OUT.pcap]
  python -m multithreading_string_matching_tpu_torch mesh   <file.pcap> <strings.txt> [udp/tcp]   (alias: mpi)
  python -m multithreading_string_matching_tpu_torch synth  <out.pcap> <num_packets> [payload_len] [strings.txt]
  python -m multithreading_string_matching_tpu_torch match  --pcap F [--pcap F ...] --patterns F
        [--mode udp|tcp] [--engine auto|pallas|window|ac|kmp] [--nocase] [--strict]
        [--pattern-syntax plain|escaped] [--config FILE] [--profile DIR]
        [--vlan] [--ipv6] [--per-packet] [--staging auto|packed|bucketed]
        [--offsets] [--dump-matches OUT.pcap]
        [--stream [--host-workers N] [--distributed]] [--flows [--reorder] [--stream]]
        [--sharded [--shard-axis auto|packets|patterns|both]] [--json]

``MSM_DEVICE=cpu|cuda`` (default ``cuda``) picks the device, as
``MSM_PLATFORM`` does for the JAX package: ``cuda`` runs the hand-written
kernels and fails without a card, ``cpu`` runs their plain versions.
``--engine ac`` and ``--engine kmp`` run the DFA scans (ops/scan.py) on
every path, with the JAX CLI's remaps: the pattern axis and attribution
take the window family, the packet axis runs kmp as ac.
Output is byte-compatible with the reference's report (utils/report.py).

The thread count of ``data``, ``task`` and ``live`` sizes the HOST thread
pool (parallel/host.py), the analogue of the reference's ``num_threads``:
``data`` extracts contiguous packet ranges on a pool, ``task`` threads the
streamed read/extract stages of the 100-packet task pipeline
(parallel/pipeline.count_pcap_pipelined), ``live`` prefetches tap batches.
Counts are identical at any thread count.

``live`` is the live program (live_openmp_task.c): an existing capture
file replays in batches (io/live.FileReplaySource), anything else names an
interface opened with the kernel's ``udp``/``tcp`` filter
(io/live.LiveSource; ``MSM_LIVE_PROMISC=0`` leaves promiscuous mode off,
``MSM_LIVE_RING=1`` takes the TPACKET_V3 ring).  Batches feed
parallel/stream.StreamMatcher, sized by ``MSM_STREAM_BATCH``/``_WINDOW``/
``_PACKED``/``_TILE_ROWS``; Ctrl-C drains and reports, SIGHUP reloads the
rules file.

``match --stream`` is the bounded-memory serving path
(parallel/pipeline.count_pcap_streamed): the capture streams in, payloads
pack into fixed tiles staged through pinned buffers, with ``--host-workers
N`` threading ingest and decode; repeated ``--pcap`` files stream as one
corpus.  ``match --flows`` reassembles TCP/UDP flows and counts over the
streams; ``--flows --stream`` is the bounded-memory flow monitor
(parallel/flow_stream.py), fed ``MSM_FLOW_BATCH`` packets (default 8192) at
a time, reloading the rules file on SIGHUP.  ``--sharded`` spreads the scan
over a mesh of every device of ``MSM_DEVICE``'s type (each card; one shard
on the CPU): the packet axis, the pattern axis (each shard holds 1/N of the
rule set) or both; ``auto`` takes the pattern axis for table-route sets on
more than one device, the packet axis otherwise.  ``--offsets`` reports
every match as ``(packet, start, pattern)`` (for flows: the flow, the
offset in its reassembled stream and the capture packet holding it) and
``--dump-matches OUT.pcap`` writes the matching packets (for flows: every
packet of a hit flow) to a new classic pcap, on every one of these paths;
repeated ``--pcap`` files scan as one corpus, packets numbered in input
order, classic and pcapng mixed.  ``--config FILE`` loads a MatchConfig
JSON (utils/config.py) that the flags override, and ``--profile DIR``
writes a torch.profiler Chrome trace of the run into DIR.

``mesh`` (alias ``mpi``) is the MPI program (mpi_dumping.c) and ``match
--stream --distributed`` its streamed form (parallel/distributed.py): with
``MSM_COORDINATOR`` (host:port of rank 0), ``MSM_NUM_PROCESSES`` and
``MSM_PROCESS_ID`` set, each process joins a gloo process group, counts its
share of the packets on its own devices, and the counts merge in one SUM;
rank 0 prints.  Without them the command runs as one process.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
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


def _build(patterns_path: str, engine: str = "pallas", nocase: bool = False,
           syntax: str = "plain", bucketed: bool = True):
    from multithreading_string_matching_tpu_torch.api import Matcher
    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns

    return Matcher(
        load_patterns(patterns_path, syntax=syntax), engine=engine, case_insensitive=nocase,
        bucketed=bucketed, device=os.environ.get("MSM_DEVICE", "cuda"),
    )


def _exact_counts(total) -> np.ndarray:
    """int32 counts unless the exact totals exceed it — then int64."""
    total = np.asarray(total, dtype=np.int64)
    if total.size and total.max() > np.iinfo(np.int32).max:
        return total
    return total.astype(np.int32)


def _report(matcher, counts, elapsed, **kw) -> None:
    from multithreading_string_matching_tpu_torch.utils.report import format_report

    print(format_report(matcher.patterns, counts, elapsed, **kw))


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


def _take_threads(argv: List[str]):
    """Parse the reference's positional thread-count argument.

    Returns ``(host_workers, rest)``: the count sizes the host thread pool
    (parallel/host.py, the analogue of ``num_threads(thread_count)``,
    openmp_data.c:128).  A count of 0/1 or an absent argument maps to
    host_workers=0 (sequential: one thread is no parallelism, and a
    1-worker pool only adds handoff overhead)."""
    if argv and argv[0].isdigit():
        n = int(argv[0])
        return (n if n > 1 else 0), argv[1:]
    return 0, argv


def cmd_data(argv: List[str]) -> int:
    """openmp_data.c analogue: the whole file in RAM, packet ranges
    extracted on host threads, each counted by the one-shot path.

    Timing excludes the pcap read (openmp_data.c:126 starts after ingest)."""
    if len(argv) < 2:
        print("USAGE: data <file.pcap> <strings.txt> [threads] [tcp/udp]")
        return 1
    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap

    threads, rest = _take_threads(argv[2:])
    mode = _mode_arg(rest)
    matcher = _build(argv[1])
    pcap = read_pcap(argv[0])
    start = time.perf_counter()
    if threads and pcap.num_packets:
        # Contiguous packet ranges extract on host worker threads (the
        # native decode releases the GIL); counts sum exactly: the host-side
        # analogue of openmp_data.c's packet-parallel region (:128-146).
        from multithreading_string_matching_tpu_torch.parallel.host import map_prefetch

        per = -(-pcap.num_packets // threads)
        slices = [
            slice_pcap(pcap, s, min(s + per, pcap.num_packets), copy=False)
            for s in range(0, pcap.num_packets, per)
        ]
        batches = list(map_prefetch(
            lambda p: extract_payloads(p, mode, keep_invalid=True, pad_n_to=128, pad_len_to=8),
            iter(slices), workers=threads,
        ))
        counts = np.sum([matcher.count_batch(b) for b in batches], axis=0).astype(np.int64)
    else:
        batch = extract_payloads(pcap, mode, keep_invalid=True, pad_n_to=128, pad_len_to=8)
        counts = matcher.count_batch(batch)
    elapsed = time.perf_counter() - start
    _report(matcher, counts, elapsed)
    return 0


def cmd_task(argv: List[str]) -> int:
    """openmp_task.c analogue: the batched producer/consumer pipeline
    (batch = 100 packets)."""
    if len(argv) < 2:
        print("USAGE: task <file.pcap> <strings.txt> [threads] [tcp/udp]")
        return 1
    from multithreading_string_matching_tpu_torch.parallel.pipeline import count_pcap_pipelined

    threads, rest = _take_threads(argv[2:])
    mode = _mode_arg(rest)
    matcher = _build(argv[1])
    start = time.perf_counter()
    counts = count_pcap_pipelined(matcher, argv[0], mode, host_workers=threads)
    elapsed = time.perf_counter() - start
    _report(matcher, counts, elapsed)
    return 0


@contextlib.contextmanager
def _process_group():
    """Join the process group of ``MSM_COORDINATOR`` etc. (when set) for the
    block, and end the group this command started however the block ends.
    Yields this process's rank (0 without a group)."""
    import torch.distributed as dist

    from multithreading_string_matching_tpu_torch.parallel.distributed import (
        _procs_and_rank,
        initialize_from_env,
    )

    started = not dist.is_initialized()
    initialize_from_env()
    try:
        yield _procs_and_rank()[1]
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def cmd_mesh(argv: List[str]) -> int:
    """mpi_dumping.c analogue: each process counts its share of the packets
    on its own devices, the counts merge in one SUM and rank 0 prints
    (mpi_dumping.c:208-215).  Without ``MSM_COORDINATOR`` one process counts
    the whole capture over a mesh of every device of ``MSM_DEVICE``'s type."""
    if len(argv) < 2:
        print("USAGE: mesh <file.pcap> <strings.txt> [tcp/udp]")
        return 1
    from multithreading_string_matching_tpu_torch.parallel.distributed import (
        count_pcap_distributed,
    )

    with _process_group() as rank:
        mode = _mode_arg(argv[2:])
        matcher = _build(argv[1])
        # The matcher's resolved engine on every shard: the kernels
        # (pallas) unless the set resolves to ac or kmp.
        eng = matcher._resolve_engine(None)
        res = count_pcap_distributed(
            matcher, argv[0], mode,
            engine=eng if eng in ("pallas", "window", "ac") else "window",
        )
    if rank == 0:
        _report(matcher, res.counts, res.elapsed_max_s)
    return 0


def cmd_live(argv: List[str]) -> int:
    """live_openmp_task.c analogue: stream batches of 10 until SIGINT, then
    drain and report (the sniffed-packet total and the "Oops!" line)."""
    dump_path = None
    if "--dump-matches" in argv:
        i = argv.index("--dump-matches")
        if i + 1 >= len(argv):
            print("USAGE: live ... --dump-matches <out.pcap>")
            return 1
        dump_path = argv[i + 1]
        argv = argv[:i] + argv[i + 2 :]
    if len(argv) < 2:
        print("USAGE: live <interface> <strings.txt> [threads] [tcp/udp] "
              "[--dump-matches out.pcap]")
        return 1
    import signal

    from multithreading_string_matching_tpu_torch.io.live import FileReplaySource, LiveSource
    from multithreading_string_matching_tpu_torch.io.pcap import PcapWriter
    from multithreading_string_matching_tpu_torch.parallel.stream import StreamMatcher, run_live
    from multithreading_string_matching_tpu_torch.utils.config import MatchConfig
    from multithreading_string_matching_tpu_torch.utils.report import format_report

    threads, rest = _take_threads(argv[2:])
    mode = _mode_arg(rest)
    matcher = _build(argv[1])
    # An existing path replays offline; anything else names an interface,
    # opened with the reference's capture setup: the kernel "udp"/"tcp"
    # filter (live_openmp_task.c:127-136) and promiscuous mode (:111-112).
    # The source comes before the dump file, so a failed open leaves none.
    source = (
        FileReplaySource(argv[0])
        if os.path.exists(argv[0])
        else LiveSource(
            argv[0], filter_mode=mode,
            promiscuous=os.environ.get("MSM_LIVE_PROMISC", "1") != "0",
            ring=os.environ.get("MSM_LIVE_RING", "0") == "1",
        )
    )
    writer = PcapWriter(dump_path) if dump_path else None
    # Stream settings come from MSM_STREAM_* (the argv contract has no room).
    env_cfg = MatchConfig.from_env()
    stream = StreamMatcher(
        matcher, batch_size=env_cfg.stream_batch, fixed_len=env_cfg.stream_window,
        dump_writer=writer,
        packed={"0": False, "1": True}.get(env_cfg.stream_packed, env_cfg.stream_packed),
        tile_rows=env_cfg.stream_tile_rows,
    )
    # The handler also stops the source: on a quiet interface the capture
    # loop never yields, so a flag checked between batches would never be
    # seen and Ctrl-C would lose the report.
    stream.install_sigint(on_stop=source.stop if hasattr(source, "stop") else None)
    # SIGHUP reloads the rules file without dropping the tap; the handler
    # only sets a flag, the swap happens between batches, and a bad file is
    # reported and ignored.
    reload_flag = {"hup": False}
    old_hup = None
    if hasattr(signal, "SIGHUP"):
        old_hup = signal.signal(signal.SIGHUP, lambda s, f: reload_flag.__setitem__("hup", True))
    # Byte-exact start banner (live_openmp_task.c:152-153).
    print("\nWork in progress...\nPress ctrl+c to stop sniffing procedure")
    print(f"You can stop the procedure only if at least one {mode} packet has been read")
    # The thread count sizes a prefetch thread that pulls batches off the tap
    # while this thread decodes and launches (every CUDA call stays here).
    if threads:
        from multithreading_string_matching_tpu_torch.parallel.host import prefetch_iter

        batches = prefetch_iter(iter(source), depth=max(2, threads))
    else:
        batches = source

    def reload_between(st):
        nonlocal matcher
        if not reload_flag["hup"]:
            return
        reload_flag["hup"] = False
        try:
            new_matcher = _build(argv[1])
            prev = st.reload(new_matcher)
        except Exception as e:  # keep sniffing under the old rules
            print(f"# rules reload failed, keeping old set: {e}", file=sys.stderr)
        else:
            print("# rules reloaded; counts under the previous set:", file=sys.stderr)
            print(format_report(matcher.patterns, prev, None), file=sys.stderr)
            matcher = new_matcher

    try:
        # Only protocol-matching packets count as sniffed; the pending dump
        # scan and the partial tile flush before the writer closes.
        run_live(stream, batches, mode, between=reload_between)
    except KeyboardInterrupt:
        pass
    finally:
        stream.uninstall_sigint()
        if old_hup is not None:
            signal.signal(signal.SIGHUP, old_hup)
        if writer is not None:
            writer.close()
    _report(matcher, stream.counts(), None, sniffed=stream.packets_seen, oops_line=True)
    if writer is not None:
        # stderr keeps stdout byte-compatible with the reference's report.
        print(f"# wrote {writer.packets_written} matching packets to {dump_path}",
              file=sys.stderr)
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
    """One-shot scan with explicit flags, the streamed scan, or the flow
    monitor."""
    p = argparse.ArgumentParser(prog="match")
    p.add_argument("--pcap", action="append",
                   help="capture file (classic pcap or pcapng); repeatable — multiple "
                        "captures (e.g. rotated files) scan as one corpus, packets "
                        "numbered in input order")
    # Not argparse-required or defaulted: a --config file may give them.
    p.add_argument("--patterns")
    p.add_argument("--mode", choices=["udp", "tcp"], default=None)
    p.add_argument("--engine", choices=["auto", "pallas", "window", "ac", "kmp"],
                   default=None)
    p.add_argument("--strict", action="store_true",
                   help="enable the protocol checks the reference omits")
    p.add_argument("--nocase", action="store_true",
                   help="ASCII case-insensitive matching (patterns and payloads folded)")
    p.add_argument("--pattern-syntax", choices=["plain", "escaped"], default="plain",
                   help="'escaped' decodes \\xNN / \\\\ per token, allowing binary "
                        "patterns the reference's fscanf loader cannot express")
    p.add_argument("--vlan", action="store_true", help="skip 802.1Q/802.1ad VLAN tags (up to two)")
    p.add_argument("--ipv6", action="store_true", help="also decode IPv6 frames (ethertype 0x86dd)")
    p.add_argument("--per-packet", action="store_true")
    p.add_argument("--flows", action="store_true",
                   help="reassemble TCP/UDP 5-tuple flows and scan the concatenated streams")
    p.add_argument("--reorder", action="store_true",
                   help="with --flows: order each TCP flow's segments by sequence number "
                        "and drop retransmitted or overlapping bytes (first bytes win)")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory streaming scan (fixed packed tiles; any-size "
                        "captures); with --flows: the bounded-memory flow monitor")
    p.add_argument("--staging", choices=["auto", "packed", "bucketed"], default="auto",
                   help="device staging policy for the pallas engine")
    p.add_argument("--sharded", action="store_true",
                   help="use every device of MSM_DEVICE's type through a mesh")
    p.add_argument("--shard-axis", choices=["auto", "packets", "patterns", "both"],
                   default="auto",
                   help="with --sharded: packets (data parallel), patterns (each device "
                        "holds 1/N of the rule set), both (2-D mesh), or auto (patterns "
                        "for table-route sets on more than one device)")
    p.add_argument("--offsets", action="store_true",
                   help="also emit (packet, start, pattern) match positions")
    p.add_argument("--dump-matches", metavar="OUT.pcap",
                   help="write the packets that contained at least one match to a new "
                        "classic pcap (original bytes and timestamps preserved)")
    p.add_argument("--distributed", action="store_true",
                   help="with --stream: multi-process streamed counting "
                        "(count_pcap_streamed_distributed; set MSM_COORDINATOR etc. "
                        "on every process — a single process runs locally)")
    p.add_argument("--host-workers", type=int, default=0, metavar="N",
                   help="with --stream: thread the host stages (prefetched ingest + N "
                        "parallel extract workers); identical counts, faster wall clock "
                        "on multi-core hosts")
    p.add_argument("--json", action="store_true")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run into DIR")
    p.add_argument("--config", metavar="FILE",
                   help="load a MatchConfig JSON (flags override)")
    a = p.parse_args(argv)

    from multithreading_string_matching_tpu_torch.utils.config import MatchConfig

    cfg = MatchConfig.load(a.config) if a.config else MatchConfig()
    # Flags override the config only when given (mode and engine default to
    # None; the boolean flags can only turn features on, so an unset flag
    # never clobbers a config file's True).
    pcap_paths = a.pcap or ([cfg.pcap] if cfg.pcap else [])
    if not pcap_paths:
        raise SystemExit("match: --pcap is required (flag or config file)")
    cfg.pcap = pcap_paths[0]
    cfg.patterns = a.patterns or cfg.patterns
    if not cfg.patterns:
        raise SystemExit("match: --patterns is required (flag or config file)")
    cfg.mode = a.mode or cfg.mode
    cfg.engine = a.engine or cfg.engine
    cfg.strict = a.strict or cfg.strict
    cfg.per_packet = a.per_packet or cfg.per_packet
    cfg.flows = a.flows or cfg.flows
    cfg.reorder = a.reorder or cfg.reorder
    cfg.profile_dir = a.profile or cfg.profile_dir
    cfg.host_workers = a.host_workers or cfg.host_workers
    cfg.validate()
    if cfg.per_packet and not a.json:
        raise SystemExit("--per-packet produces an [N, P] matrix: use --json")
    # The paths below read the merged settings from the namespace.
    a.pcap, a.patterns, a.mode, a.engine = pcap_paths, cfg.patterns, cfg.mode, cfg.engine
    a.strict, a.per_packet, a.flows, a.reorder = cfg.strict, cfg.per_packet, cfg.flows, cfg.reorder
    a.host_workers, a.bucketed, a.n_tile, a.l_quant = (cfg.host_workers, cfg.bucketed,
                                                        cfg.n_tile, cfg.l_quant)
    if not cfg.profile_dir:
        return _run_match(a)
    # A real with-block: the trace is written on every exit path, errors
    # included, as the JAX CLI's jax.profiler.trace does.
    with _profiled(cfg.profile_dir):
        return _run_match(a)


@contextlib.contextmanager
def _profiled(out_dir: str):
    """torch.profiler over the block, CPU and (on the card) CUDA activities,
    its Chrome trace written into ``out_dir`` however the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if os.environ.get("MSM_DEVICE", "cuda") == "cuda" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(out_dir, f"match.{os.getpid()}.pt.trace.json"))


def _run_match(a) -> int:
    from multithreading_string_matching_tpu_torch.utils.timing import PhaseTimer

    matcher = _build(a.patterns, engine=a.engine, nocase=a.nocase, syntax=a.pattern_syntax,
                     bucketed=a.bucketed)
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
    # The JAX CLI's guards, in its order.
    if a.distributed and not a.stream:
        raise SystemExit("--distributed requires --stream (the one-shot "
                         "multi-host path is the `mesh` subcommand)")
    if a.host_workers and not a.stream:
        raise SystemExit("--host-workers requires --stream (the one-shot "
                         "path reads the capture in one pass)")
    if a.flows and a.per_packet:
        raise SystemExit("--flows does not compose with --per-packet (per-flow rows "
                         "ARE the attribution unit; use --offsets for positions)")
    if a.flows and a.dump_matches and a.stream:
        raise SystemExit("--flows --dump-matches is one-shot only (the streamed flow "
                         "monitor does not retain packets): drop --stream")
    if a.flows and a.stream and a.distributed:
        raise SystemExit("--flows --stream does not compose with --distributed "
                         "(per-flow carried state is single-host; use --sharded for "
                         "multi-device lanes)")
    if a.reorder and not a.flows:
        raise SystemExit("--reorder requires --flows")
    if a.reorder and a.mode != "tcp":
        raise SystemExit("--reorder applies to TCP flows only")
    if a.stream and not a.flows:
        if a.per_packet:
            raise SystemExit("--stream is incompatible with --per-packet")
        if a.distributed and (a.dump_matches or a.offsets or a.sharded):
            raise SystemExit("--distributed streaming is counts-only (per-host tiles, "
                             "one end-of-run merge); drop --sharded/--offsets/"
                             "--dump-matches")
    if a.flows and a.stream:
        return _match_flow_stream(a, matcher, timer)
    if a.flows:
        return _match_flows(a, matcher, timer, shard_axis)
    if a.stream:
        return _match_stream(a, matcher, timer, shard_axis)

    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads

    with timer.phase("ingest"):
        pcap = _read_corpus(a.pcap)
    with timer.phase("extract"):
        batch = extract_payloads(pcap, a.mode, strict=a.strict, pad_n_to=128, pad_len_to=8,
                                 vlan=a.vlan, ipv6=a.ipv6)
    with timer.phase("scan"):
        offsets = None
        hit_rows = None
        per_row = None
        sharded_attr = a.sharded and bool(a.per_packet or a.dump_matches or a.offsets)
        if a.sharded and not sharded_attr:
            counts = _sharded_counts(a, matcher, shard_axis, batch.payloads, batch.lengths)
        elif sharded_attr:
            # One sharded per-row pass serves --per-packet, --dump-matches
            # and --offsets; without --per-packet only totals and hit flags
            # leave the devices, and positions come from the hit rows only.
            if a.per_packet:
                per_row = _sharded_rows(a, matcher, shard_axis, batch.payloads, batch.lengths)
                counts = per_row
                hit_rows = np.flatnonzero(per_row.sum(axis=1) > 0)
            else:
                tot, hits = _sharded_summary(a, matcher, shard_axis, batch.payloads,
                                             batch.lengths)
                counts = _exact_counts(tot[matcher.window.dup_map])
                hit_rows = np.flatnonzero(hits)
            hit_rows = hit_rows[hit_rows < int(batch.valid.sum())]
            if a.offsets:
                offsets = matcher.find_matches(batch.payloads[hit_rows], batch.lengths[hit_rows])
                if offsets.size:
                    offsets[:, 0] = hit_rows[offsets[:, 0]]
        elif a.offsets and not a.per_packet:
            # One find_matches pass gives every output: the triples are the
            # counts, the offsets and the dump selection.
            offsets = matcher.find_matches(batch.payloads, batch.lengths)
            counts = _exact_counts(matcher.counts_from_match_rows(offsets))
            hit_rows = (np.unique(offsets[:, 0]) if offsets.size
                        else np.zeros(0, np.int64))
        elif a.dump_matches and not a.per_packet:
            # The per-row counts give the dump and, as column sums, the totals.
            if a.staging != "auto":
                print(f"# note: --dump-matches uses the per-row kernel; "
                      f"--staging {a.staging} does not apply", file=sys.stderr)
            per_row = np.asarray(matcher.count_batch(batch, per_packet=True, n_tile=a.n_tile,
                                                     l_quant=a.l_quant))
            counts = _exact_counts(per_row.sum(axis=0, dtype=np.int64))
        else:
            counts = matcher.count_batch(batch, per_packet=a.per_packet, staging=a.staging,
                                         n_tile=a.n_tile, l_quant=a.l_quant)
            if a.per_packet:
                per_row = np.asarray(counts)
        if a.offsets and offsets is None:
            offsets = matcher.find_matches(batch.payloads, batch.lengths)
    valid_idx = np.flatnonzero(batch.valid)
    if offsets is not None and len(offsets):
        # Capture packet numbers: find_matches rows index the valid payloads.
        offsets[:, 0] = valid_idx[offsets[:, 0]]
    dumped = None
    if a.dump_matches:
        from multithreading_string_matching_tpu_torch.io.pcap import write_pcap

        if hit_rows is None:
            hit_rows = np.flatnonzero(per_row[: valid_idx.size].sum(axis=1) > 0)
        dumped = write_pcap(a.dump_matches, pcap, valid_idx[hit_rows])
    if a.json:
        blob = {
            "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
            "counts": np.asarray(counts).tolist(),
            "packets": batch.num_packets,
            "valid_payloads": int(batch.valid.sum()),
            "payload_bytes": batch.total_payload_bytes,
            "phases": timer.phases,
            "execution": _execution_blob(matcher, a.sharded, attribution=sharded_attr,
                                         shard_axis=shard_axis if a.sharded else None),
        }
        if a.sharded:
            blob["execution"]["shard_axis"] = shard_axis
        if offsets is not None:
            blob["offsets"] = offsets.tolist()  # (packet, start, unique_pattern)
            blob["unique_patterns"] = _unique_names(matcher)
        if dumped is not None:
            blob["dump_path"] = a.dump_matches
            blob["dumped_packets"] = dumped
        _print_json(blob)
    else:
        _report(matcher, _exact_counts(counts), timer.total)
        if offsets is not None:
            uniq = matcher.window.unique_patterns
            for n, i, u in offsets.tolist():
                print(f"packet {n} @ {i}: {uniq[u].decode('latin-1')}")
        if dumped is not None:
            print(f"# wrote {dumped} matching packets to {a.dump_matches}", file=sys.stderr)
        print(f"# {timer.summary()}", file=sys.stderr)
    return 0


def _read_corpus(paths):
    """Every ``--pcap`` read and concatenated into one capture, packets
    numbered in input order."""
    from multithreading_string_matching_tpu_torch.io.pcap import concat_pcaps, read_pcap

    return concat_pcaps([read_pcap(p) for p in paths])


def _unique_names(matcher) -> list:
    return [pt.decode("latin-1") for pt in matcher.window.unique_patterns]


def _sharded_counts(a, matcher, shard_axis: str, payloads, lengths) -> np.ndarray:
    """Totals over the mesh of ``--shard-axis``: the pattern axis through
    parallel/pattern_shard.py (ac/kmp remap to the window family there),
    the packet axis through parallel/mesh.py (kmp runs as ac there)."""
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
        matcher.cac if eng == "ac" else None, matcher._maybe_fold(payloads), lengths,
        make_mesh(device_type=dev_type),
        dup_map=matcher.ac.dup_map if eng == "ac" else matcher.window.dup_map, engine=eng,
        window=matcher.window, pallas_matcher=matcher.kernels if eng == "pallas" else None)


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


def _sharded_summary(a, matcher, shard_axis: str, payloads, lengths):
    """``(unique totals int64[U], row hit flags)`` over the mesh, reduced on
    each shard's device: the attribution pass of ``--sharded`` with
    ``--offsets`` or ``--dump-matches`` (the window family)."""
    row_eng = "pallas" if matcher._requested_engine(a.engine) == "pallas" else "window"
    dev_type = matcher.device.type
    if shard_axis in ("patterns", "both"):
        from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
            count_rows_summary_pattern_sharded,
            resolve_shard_mesh,
        )

        return count_rows_summary_pattern_sharded(
            matcher, payloads, lengths, resolve_shard_mesh(shard_axis, device_type=dev_type),
            engine=row_eng)
    from multithreading_string_matching_tpu_torch.parallel.mesh import (
        count_rows_summary,
        make_mesh,
    )

    return count_rows_summary(matcher, payloads, lengths, make_mesh(device_type=dev_type),
                              engine=row_eng)


def _print_json(blob: dict) -> None:
    import json

    print(json.dumps(blob))


def _match_flows(a, matcher, timer, shard_axis: str) -> int:
    """One-shot ``--flows``: reassemble every flow, count over the streams;
    with ``--offsets`` the matches' flows, stream offsets and capture
    packets, with ``--dump-matches`` every packet of every hit flow."""
    from multithreading_string_matching_tpu_torch.io.flows import extract_flows

    with timer.phase("ingest"):
        pcap = _read_corpus(a.pcap)
    with timer.phase("extract"):
        fb = extract_flows(pcap, a.mode, reorder=a.reorder, ipv6=a.ipv6, vlan=a.vlan)
    with timer.phase("scan"):
        flow_rows = None
        hit_flows = None
        if a.sharded and fb.num_flows == 0:
            # The answer for a capture without flows is known.
            counts = np.zeros(len(matcher.patterns), np.int64)
            if a.offsets:
                flow_rows = np.zeros((0, 3), np.int64)
        elif a.sharded and (a.offsets or a.dump_matches):
            # One summary pass on the mesh (totals and hit-flow flags), then
            # positions from the hit flows only.
            tot, hits = _sharded_summary(a, matcher, shard_axis, fb.payloads, fb.lengths)
            counts = _exact_counts(tot[matcher.window.dup_map])
            hit = np.flatnonzero(hits)
            hit_flows = hit = hit[hit < fb.num_flows]  # padding rows cannot hit
            if a.offsets:
                flow_rows = matcher.find_matches(fb.payloads[hit], fb.lengths[hit])
                if flow_rows.size:
                    flow_rows[:, 0] = hit[flow_rows[:, 0]]
        elif a.sharded:
            counts = _sharded_counts(a, matcher, shard_axis, fb.payloads, fb.lengths)
        elif a.offsets or a.dump_matches:
            # One find_matches pass serves counts, positions and the hit flows.
            flow_rows = matcher.find_matches(fb.payloads, fb.lengths)
            counts = matcher.counts_from_match_rows(flow_rows)
        else:
            counts = matcher.count(fb.payloads, fb.lengths)
    if a.dump_matches:
        # Every packet of every hit flow, original bytes and timestamps.
        from multithreading_string_matching_tpu_torch.io.pcap import write_pcap

        if hit_flows is None:
            hit_flows = (np.unique(flow_rows[:, 0]) if flow_rows is not None and flow_rows.size
                         else np.zeros(0, np.int64))
        hit_b = np.zeros(max(fb.num_flows, 1), bool)
        hit_b[np.asarray(hit_flows, np.int64)] = True
        fop = fb.flow_of_packet
        write_pcap(a.dump_matches, pcap,
                   (fop >= 0) & hit_b[np.clip(fop, 0, hit_b.size - 1)])
    if a.json:
        blob = {
            "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
            "counts": np.asarray(counts).tolist(),
            "flows": fb.num_flows,
            "flow_packets": int((fb.flow_of_packet >= 0).sum()),
            "packets": fb.num_packets,
            "stream_bytes": fb.total_payload_bytes,
            "phases": timer.phases,
            "execution": _execution_blob(matcher, a.sharded, attribution=a.offsets,
                                         shard_axis=shard_axis if a.sharded else None),
        }
        if a.dump_matches:
            blob["dump_path"] = a.dump_matches
        if a.offsets and flow_rows is not None:
            # Each row carries the capture packet whose segment holds the
            # match's first byte.
            blob["offsets"] = [[f, i, u, fb.packet_of_offset(f, i)]
                               for f, i, u in flow_rows.tolist()]
            blob["flow_keys"] = [list(fb.key_tuple(f)) for f in range(fb.num_flows)]
            blob["unique_patterns"] = _unique_names(matcher)
        _print_json(blob)
    else:
        _report(matcher, _exact_counts(counts), timer.total)
        if a.offsets and flow_rows is not None:
            uniq = matcher.window.unique_patterns
            for f, i, u in flow_rows.tolist():
                src, dst, sp, dp = fb.key_tuple(f)
                print(f"flow {src}:{sp}->{dst}:{dp} @ {i} "
                      f"(packet {fb.packet_of_offset(f, i)}): {uniq[u].decode('latin-1')}")
    return 0


def _match_flow_stream(a, matcher, timer) -> int:
    """``--flows --stream``: the flow monitor's pass
    (parallel/flow_stream.count_pcap_flows_streamed), with the rules file
    reloaded on SIGHUP (``--pcap -`` behind a tcpdump pipe is the daemon
    shape)."""
    import signal

    from multithreading_string_matching_tpu_torch.io.flows import key_tuple_bytes
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import (
        FlowStreamMatcher,
        count_pcap_flows_streamed,
        flow_stream_engine,
    )
    from multithreading_string_matching_tpu_torch.utils.report import format_report

    fse = flow_stream_engine(matcher)
    if a.offsets:
        # The find pass reads the per-flow byte tail that only the window
        # layout carries; counts are the same on either engine.
        fse = "window"
    if a.sharded and a.shard_axis in ("patterns", "both"):
        # Only an explicit request errors (auto takes the lane axis here):
        # each lane's carried tail pins it to one shard.
        raise SystemExit("--flows --stream shards the flow-lane axis only: drop "
                         "--shard-axis or use --shard-axis packets")
    fs = FlowStreamMatcher(matcher, a.mode, engine=fse, reorder=a.reorder, ipv6=a.ipv6,
                           vlan=a.vlan, sharded=a.sharded, collect_offsets=a.offsets)
    reload_flag = {"hup": False}
    old_hup = None
    # With --offsets the old and new pattern index spaces cannot share one
    # report, so SIGHUP keeps its default.
    if hasattr(signal, "SIGHUP") and not a.offsets:
        old_hup = signal.signal(signal.SIGHUP, lambda s, f: reload_flag.__setitem__("hup", True))
    # The batch size is the reload and feed latency on a pipe: iter_pcap
    # yields on a full batch or at EOF (rounds are still set by scan_bytes).
    flow_batch = int(os.environ.get("MSM_FLOW_BATCH", "8192"))
    # Text mode prints each drained triple once its round is scanned
    # (bounded memory); --json holds them for the one final blob.  A flow's
    # key is rendered once, not once a triple (bounded for the daemon).
    hits = [] if a.offsets else None
    key_name = functools.lru_cache(maxsize=1 << 16)(key_tuple_bytes)

    def emit_hits(fs):
        if hits is None:
            return
        drained = fs.drain_offsets()
        if a.json:
            hits.extend(drained)
            return
        uniq = fs.matcher.window.unique_patterns
        for k, o, u in drained:
            src, dst, sp, dp = key_name(k)
            print(f"flow {src}:{sp}->{dst}:{dp} @ {o}: {uniq[u].decode('latin-1')}")

    reloads = 0

    def reload_rules(fs):
        nonlocal matcher, reloads
        if not reload_flag["hup"]:
            return
        reload_flag["hup"] = False
        try:
            new_matcher = _build(a.patterns, engine=a.engine, nocase=a.nocase,
                                 syntax=a.pattern_syntax, bucketed=a.bucketed)
            prev = fs.reload(new_matcher)
        except Exception as e:  # the daemon keeps its old rules
            print(f"# rules reload failed, keeping old set: {e}", file=sys.stderr)
            return
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
            print("# rules reloaded; counts under the previous set:", file=sys.stderr)
            print(format_report(matcher.patterns, prev, None), file=sys.stderr)
        matcher = new_matcher

    try:
        with timer.phase("scan"):
            counts = count_pcap_flows_streamed(fs, a.pcap, batch_packets=flow_batch,
                                               host_workers=a.host_workers,
                                               before_chunk=reload_rules, after_feed=emit_hits)
    finally:
        if old_hup is not None:
            signal.signal(signal.SIGHUP, old_hup)
    if a.json:
        ex = _execution_blob(matcher, actual=fse)
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
        if hits is not None:
            # Keys ride inline (the flow set is unbounded); offsets are byte
            # positions in the flow's reassembled stream.
            blob["offsets"] = [[*key_name(k), int(o), int(u)] for k, o, u in hits]
            blob["unique_patterns"] = _unique_names(matcher)
        _print_json(blob)
    else:
        _report(matcher, _exact_counts(counts), timer.total)
    return 0


def _match_stream(a, matcher, timer, shard_axis: str) -> int:
    """``--stream``: the bounded-memory packed-tile scan over every
    ``--pcap`` in turn (parallel/pipeline.count_pcap_streamed); with
    ``--offsets`` or ``--dump-matches`` the per-row streamed scan
    (parallel/pipeline.scan_pcap_streamed); with ``--distributed`` each
    process's share of the chunks, merged at the end
    (parallel/distributed.count_pcap_streamed_distributed), rank 0 printing."""
    from multithreading_string_matching_tpu_torch.parallel.pipeline import (
        count_pcap_streamed,
        scan_pcap_streamed,
    )

    stream_stats: dict = {}
    stream_offsets = None
    with timer.phase("scan"):
        if a.distributed:
            from multithreading_string_matching_tpu_torch.parallel.distributed import (
                count_pcap_streamed_distributed,
            )

            with _process_group() as rank:
                counts = count_pcap_streamed_distributed(
                    matcher, a.pcap, a.mode, strict=a.strict, vlan=a.vlan, ipv6=a.ipv6,
                    engine=a.engine, stats=stream_stats, host_workers=a.host_workers,
                ).counts
            if rank != 0:
                return 0  # rank 0 prints, as mesh does
        elif a.dump_matches or a.offsets:
            res = scan_pcap_streamed(
                matcher, a.pcap, a.mode, dump_path=a.dump_matches, offsets=a.offsets,
                strict=a.strict, vlan=a.vlan, ipv6=a.ipv6, stats=stream_stats, sharded=a.sharded,
                shard_axis=shard_axis if a.sharded else "packets",
                host_workers=a.host_workers,
            )
            counts, stream_offsets = res if a.offsets else (res, None)
        else:
            counts = count_pcap_streamed(
                matcher, a.pcap, a.mode, strict=a.strict, vlan=a.vlan, ipv6=a.ipv6,
                engine=a.engine,
                stats=stream_stats, sharded=a.sharded,
                shard_axis=shard_axis if a.sharded else "packets",
                host_workers=a.host_workers,
            )
    # The pipeline reports the engine it ACTUALLY resolved.
    actual_engine = stream_stats.pop("engine_resolved", None)
    if a.json:
        blob = {
            "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
            "counts": np.asarray(counts).tolist(),
            **stream_stats,  # host_workers / packets / valid_payloads / payload_bytes
            "phases": timer.phases,
            "execution": _execution_blob(matcher, a.sharded,
                                         attribution=bool(a.dump_matches or a.offsets),
                                         actual=actual_engine),
        }
        if a.sharded:
            blob["execution"]["shard_axis"] = shard_axis
        if a.dump_matches:
            blob["dump_path"] = a.dump_matches
        if stream_offsets is not None:
            blob["offsets"] = stream_offsets.tolist()
            blob["unique_patterns"] = _unique_names(matcher)
        _print_json(blob)
    else:
        _report(matcher, counts, timer.total)
        if stream_offsets is not None:
            uniq = matcher.window.unique_patterns
            for n, i, u in stream_offsets.tolist():
                print(f"packet {n} @ {i}: {uniq[u].decode('latin-1')}")
        if a.dump_matches:
            print(f"# wrote {stream_stats.get('dumped_packets', 0)} matching packets to "
                  f"{a.dump_matches}", file=sys.stderr)
    return 0


def cmd_synth(argv: List[str]) -> int:
    """Generate a synthetic UDP capture (mega_udp.pcap stand-in), the same
    bytes as the JAX package's ``synth`` for the same arguments.

    USAGE: synth <out.pcap> <num_packets> [payload_len] [strings.txt]
    """
    if len(argv) < 2:
        print("USAGE: synth <out.pcap> <num_packets> [payload_len] [strings.txt]")
        return 1
    from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
    from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap

    payload_len = int(argv[2]) if len(argv) > 2 else 1024
    patterns = load_patterns(argv[3]) if len(argv) > 3 else None
    total = synth_udp_pcap(
        argv[0], int(argv[1]), payload_len=payload_len,
        payload_len_jitter=payload_len // 4, patterns=patterns,
        plant_rate=0.05, invalid_rate=0.02,
    )
    print(f"wrote {argv[0]}: {argv[1]} packets, {total} payload bytes")
    return 0


COMMANDS = {
    "serial": cmd_serial,
    "data": cmd_data,
    "task": cmd_task,
    "live": cmd_live,
    "mesh": cmd_mesh,
    "mpi": cmd_mesh,  # alias: the MPI program's role
    "match": cmd_match,
    "synth": cmd_synth,
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
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
