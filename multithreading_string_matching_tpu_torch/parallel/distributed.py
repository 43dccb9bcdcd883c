"""Multi-process matching: the reference's MPI program (``mpi_dumping.c``).

Counterpart of ``multithreading_string_matching_tpu/parallel/distributed.py``:
the same names, signatures, defaults, errors and result fields.  The
reference's ranks each match a share of the packets and merge the counts
with ``MPI_Reduce(SUM)`` and the elapsed time with ``MPI_Reduce(MAX)``
(``mpi_dumping.c:202-206``).  Here:

1. :func:`initialize_from_env` joins a ``torch.distributed`` process group
   from ``MSM_COORDINATOR`` / ``MSM_NUM_PROCESSES`` / ``MSM_PROCESS_ID``, the
   variables the JAX package reads, so one launch script serves both.
2. Every rank reads only its own packet range (no rank-0 funnel) and counts
   it with the hand-written kernels on its own devices: a mesh of every
   visible device of the matcher's type (parallel/mesh.py).  When several
   ranks share a host with several cards, the launcher gives each rank its
   card (``CUDA_VISIBLE_DEVICES``).
3. The merges are host collectives over gloo: an error flag first, then one
   exact int64 SUM of the counts and one MAX of the elapsed time.  What
   crosses ranks is a few hundred integers once a run, and the counts are
   on the host already; gloo also lets two ranks share one card, which
   NCCL refuses.  The kernels still run on the cards.

A process without a group (or a group of one) runs the local path: the
same code serves one process and many.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching_tpu_torch.parallel.mesh import (
    count_matches_sharded,
    default_devices,
    make_mesh,
)

_ABORT = "pcap ingest failed on at least one host; all hosts aborting"


def initialize_from_env() -> bool:
    """Join the process group if coordinator env vars are present.

    Set ``MSM_COORDINATOR`` (host:port of rank 0, which serves the group's
    rendezvous), ``MSM_NUM_PROCESSES`` and ``MSM_PROCESS_ID`` on every
    process.  A group already joined is kept.  Returns True if distributed
    mode is on."""
    coord = os.environ.get("MSM_COORDINATOR")
    if not coord:
        return dist.is_initialized() and dist.get_world_size() > 1
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ["MSM_NUM_PROCESSES"]),
            rank=int(os.environ["MSM_PROCESS_ID"]),
        )
    return True


def _procs_and_rank() -> Tuple[int, int]:
    """``(processes, this process's rank)``: ``(1, 0)`` without a group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


@dataclass
class DistributedResult:
    counts: np.ndarray          # over the original (duplicated) pattern list
    elapsed_max_s: float        # slowest rank's extract+scan time (MPI_Wtime analogue)
    local_packets: int
    local_payload_bytes: int


def _all_reduce(values, dtype, op) -> np.ndarray:
    """``op`` over every rank of a small host vector (gloo)."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype).reshape(-1).clone()
    dist.all_reduce(t, op=op)
    return t.numpy()


def _abort_if_any_failed(exc: Optional[BaseException]) -> None:
    """The error flag, the first collective of a run: every rank raises if
    any rank's ingest failed, so none waits in a later collective
    (``mpi_dumping.c:137-142``)."""
    flags = _all_reduce([0 if exc is None else 1], torch.int64, dist.ReduceOp.SUM)
    if int(flags.sum()):
        raise RuntimeError(_ABORT) from exc


def _max_elapsed(elapsed: float) -> float:
    return float(_all_reduce([elapsed], torch.float64, dist.ReduceOp.MAX)[0])


def _int32_if_fits(counts: np.ndarray) -> np.ndarray:
    """Exact int64 counts as int32 unless one exceeds it."""
    if counts.size and counts.max() > np.iinfo(np.int32).max:
        return counts
    return counts.astype(np.int32)


def count_pcap_distributed(
    matcher,
    pcap_path,
    mode: str = "udp",
    *,
    strict: bool = False,
    engine: str = "window",
    mesh=None,
) -> DistributedResult:
    """Count patterns over a pcap shared across all participating ranks.

    Rank r counts packets ``[r * share, (r + 1) * share)`` with
    ``share = ceil(N / ranks)``.  ``engine='pallas'`` runs the matcher's
    kernels on every shard (``window_count_totals``, or the class kernels
    of a large set), ``'window'`` the plain window count and ``'ac'`` the
    automaton scan (``ac_scan``).  ``mesh`` is this rank's local mesh
    (default: every device of the matcher's type)."""
    if engine not in ("window", "ac", "pallas"):
        raise ValueError(
            f"count_pcap_distributed supports engine 'pallas', 'window' or "
            f"'ac', got {engine!r}"
        )
    procs, rank = _procs_and_rank()
    mesh = mesh or make_mesh(device_type=matcher.device.type)

    exc: Optional[BaseException] = None
    full = None
    try:
        full = read_pcap(pcap_path)
        total_packets = full.num_packets
    except (FileNotFoundError, ValueError, OSError) as e:
        exc, total_packets = e, 0
    if procs > 1:
        _abort_if_any_failed(exc)
    elif exc is not None:
        raise exc
    share = -(-total_packets // procs)
    pcap = slice_pcap(full, rank * share, min(total_packets, (rank + 1) * share))
    del full  # keep only this rank's byte range resident

    t0 = time.perf_counter()
    batch = extract_payloads(pcap, mode, strict=strict, keep_invalid=True)

    # One padded width on every rank, a multiple of 128: each rank's shard
    # has the same shape, [share x width].
    global_l = batch.payloads.shape[1]
    if procs > 1:
        global_l = int(_all_reduce([global_l], torch.int64, dist.ReduceOp.MAX)[0])
    global_l = -(-global_l // 128) * 128

    # Case-insensitive matchers fold bytes before staging: the kernels hold
    # folded patterns.  Padding rows have length 0 and count nothing.
    payloads = matcher._maybe_fold(batch.payloads)
    lengths = batch.lengths
    if payloads.shape[1] < global_l:
        payloads = np.pad(payloads, ((0, 0), (0, global_l - payloads.shape[1])))
    rows = max(share, payloads.shape[0], 1)
    if payloads.shape[0] < rows:
        pad = rows - payloads.shape[0]
        payloads = np.pad(payloads, ((0, pad), (0, 0)))
        lengths = np.pad(lengths, (0, pad))

    unique = count_matches_sharded(
        matcher.cac if engine == "ac" else None, payloads, lengths, mesh,
        engine=engine, window=matcher.window,
        pallas_matcher=matcher.kernels if engine == "pallas" else None,
    ).astype(np.int64)
    if procs > 1:
        unique = _allgather_int64(unique)
    dup = matcher.ac.dup_map if engine == "ac" else matcher.window.dup_map
    counts = _int32_if_fits(unique[dup])
    elapsed = time.perf_counter() - t0
    if procs > 1:
        elapsed = _max_elapsed(elapsed)

    return DistributedResult(
        counts=counts,
        elapsed_max_s=elapsed,
        local_packets=pcap.num_packets,
        local_payload_bytes=int(batch.lengths.sum()),
    )


def _allgather_int64(local: np.ndarray) -> np.ndarray:
    """SUM of an int64 vector across processes, exactly (the JAX package's
    helper of this name ships uint32 halves because jnp downcasts int64;
    gloo sums int64 as it is)."""
    local = np.asarray(local, dtype=np.int64)
    if not dist.is_initialized():
        return local.copy()
    return _all_reduce(local, torch.int64, dist.ReduceOp.SUM)


def count_pcap_streamed_distributed(
    matcher,
    pcap_path,
    mode: str = "udp",
    *,
    batch_packets: int = 8192,
    tile_rows: int = 4096,
    pack_width: int = 2048,
    strict: bool = False,
    vlan: bool = False,
    ipv6: bool = False,
    engine: Optional[str] = None,
    stats: Optional[dict] = None,
    host_workers: int = 0,
) -> DistributedResult:
    """Bounded-memory multi-process streaming scan, for captures larger than
    any rank's memory.

    Every rank streams the capture (``iter_pcap``) and scans the chunks
    whose index is its rank modulo the process count, packed into fixed
    tiles on its own devices (``PackedTileCounter``: one kernel launch a
    tile, sharded over the rank's devices when it has more than one).  No
    collective runs per tile, since ranks may count different numbers of
    tiles: the run ends in exactly three, the error flag, one exact int64
    SUM of the counts with ``[packets, valid, bytes]``, and the MAX of the
    elapsed time.  ``host_workers >= 1`` threads each rank's ingest and
    decode (parallel/host.py).

    NUL-containing sets (packing inexact) count chunk by chunk through
    ``matcher.count``.  Counts are int32 when they fit, else int64;
    ``stats`` receives ``engine_resolved`` and the whole capture's packet /
    valid-payload / byte totals."""
    from multithreading_string_matching_tpu_torch.parallel.pipeline import (
        PackedTileCounter,
        _iter_pcap_paths,
    )

    procs, rank = _procs_and_rank()
    t0 = time.perf_counter()
    exc: Optional[BaseException] = None
    local = np.zeros(len(matcher.patterns), dtype=np.int64)
    n_pkts = n_valid = n_bytes = 0
    nul = any(0 in p for p in matcher.window.unique_patterns)
    local_devs = default_devices(matcher.device.type)
    counter = None if nul else PackedTileCounter(
        matcher, engine=engine, tile_rows=tile_rows, pack_width=pack_width,
        sharded=len(local_devs) > 1,
        mesh=make_mesh(local_devs) if len(local_devs) > 1 else None,
    )
    if stats is not None:
        stats["engine_resolved"] = (
            counter.engine if counter is not None
            else matcher._resolve_engine(engine)
        )

    def _my_batches():
        # Chunks are chosen before the decode, so a rank decodes only its own.
        src = (
            c
            for i, c in enumerate(_iter_pcap_paths(pcap_path, batch_packets))
            if i % procs == rank
        )

        def ex(chunk):
            return extract_payloads(chunk, mode, strict=strict, vlan=vlan, ipv6=ipv6)

        if host_workers:
            from multithreading_string_matching_tpu_torch.parallel.host import (
                map_prefetch,
                prefetch_iter,
            )

            yield from map_prefetch(
                ex, prefetch_iter(src, depth=max(2, host_workers)), workers=host_workers,
            )
            return
        for chunk in src:
            yield ex(chunk)

    try:
        for batch in _my_batches():
            n_pkts += batch.num_packets
            n_valid += int(batch.valid.sum())
            n_bytes += batch.total_payload_bytes
            if counter is not None:
                counter.add(batch.payloads, batch.lengths)
            else:
                local += np.asarray(
                    matcher.count(batch.payloads, batch.lengths, engine=engine)
                ).astype(np.int64)
        if counter is not None:
            local += counter.totals()
    except (FileNotFoundError, ValueError, OSError) as e:
        exc = e
    elapsed = time.perf_counter() - t0

    if procs > 1:
        _abort_if_any_failed(exc)
        # The ingest stats ride in the counts' collective: the caller's
        # stats describe the whole capture, not one rank's share.
        merged = _allgather_int64(np.concatenate([
            local, np.array([n_pkts, n_valid, n_bytes], dtype=np.int64),
        ]))
        counts, (g_pkts, g_valid, g_bytes) = merged[:-3], merged[-3:]
        elapsed = _max_elapsed(elapsed)
    else:
        if exc is not None:
            raise exc
        counts = local
        g_pkts, g_valid, g_bytes = n_pkts, n_valid, n_bytes
    if stats is not None:
        stats.update(
            packets=int(g_pkts), valid_payloads=int(g_valid), payload_bytes=int(g_bytes),
        )
    return DistributedResult(
        counts=_int32_if_fits(counts),
        elapsed_max_s=elapsed,
        local_packets=n_pkts,
        local_payload_bytes=n_bytes,
    )
