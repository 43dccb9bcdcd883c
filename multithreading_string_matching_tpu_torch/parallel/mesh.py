"""Packet-axis sharding over a mesh of devices.

Counterpart of ``multithreading_string_matching_tpu/parallel/mesh.py``.  The
JAX package runs one SPMD program over its mesh with ``shard_map`` and
merges counts with ``psum``.  Here one process drives every device of a
:class:`Mesh` (single-controller, as there): each shard's rows are staged on
its own device and counted there by the kernels bound to that device, and
the merges are written out: a sum of the shards' int32 counts for totals,
the shards' rows in order for per-row counts.  Counts are integers, so the
result equals the one-device count for any shard count.

A mesh may name one device more than once: N shards on one card, or on the
CPU, as the JAX package's tests run on 8 virtual CPU devices.

Engines: ``'pallas'`` runs the kernels (their plain versions for CPU
shards), ``'window'`` the plain window count on each shard's device, and
``'ac'`` the Aho-Corasick scan (``ops/scan.ac_scan``), which also carries
flow-lane states across chunks (:func:`count_chunk_sharded`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.ops.cuda_window import canonical_device
from multithreading_string_matching_tpu_torch.ops.scan import CompiledAC, ac_scan, check_states
from multithreading_string_matching_tpu_torch.ops.window import window_count, window_count_halo_plain

PACKET_AXIS = "packets"

# One dispatch of the attribution summary must scan fewer positions than
# this, or its int32 totals could wrap (a position starts at most one match
# per pattern).  Module-level so tests can lower it.
SUMMARY_MAX_POSITIONS = 2**31


class Mesh:
    """Devices arranged on named axes: ``devices`` is a numpy object array
    of ``torch.device`` shaped by the axes, ``axis_names`` their names and
    ``shape`` maps each name to its size (the attributes the JAX package's
    ``jax.sharding.Mesh`` offers to this code).  All devices are of one
    type; a bare ``cuda`` is card 0."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if given.ndim != len(names) or given.size == 0:
            raise ValueError(f"a mesh of shape {given.shape} cannot carry the axes {names}")
        devs = np.empty(given.shape, dtype=object)
        for idx, d in enumerate(given.flat):
            devs.flat[idx] = canonical_device(d)
        types = {d.type for d in devs.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {sorted(types)}")
        self.devices = devs
        self.axis_names = names
        self.shape = dict(zip(names, devs.shape))

    def _key(self):
        return self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def default_devices(device_type: str = "cuda") -> List[torch.device]:
    """Every device a default mesh spans: each visible card for ``cuda``
    (raises without one), one shard for ``cpu``."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device, and none is available; "
                               "pass device_type='cpu' or CPU devices")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {device_type!r}")


def make_mesh(devices: Optional[Sequence] = None, axis: str = PACKET_AXIS, *,
              device_type: str = "cuda") -> Mesh:
    """A 1-D mesh over the packet (data-parallel) axis: ``devices``, or
    :func:`default_devices` of ``device_type``."""
    devs = list(devices) if devices is not None else default_devices(device_type)
    return Mesh(devs, (axis,))


def shard_batch(payloads: np.ndarray, lengths: np.ndarray, mesh: Mesh
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the packet axis so it divides the mesh (padding rows have length
    0 and count nothing)."""
    n_dev = mesh.devices.size
    n = payloads.shape[0]
    n_pad = -(-n // n_dev) * n_dev
    if n_pad != n:
        payloads = np.pad(payloads, ((0, n_pad - n), (0, 0)))
        lengths = np.pad(lengths, (0, n_pad - n))
    return payloads, lengths


def stage(a, dtype, device) -> torch.Tensor:
    """A host array as a fresh contiguous tensor on ``device``."""
    return torch.tensor(np.ascontiguousarray(a, dtype=dtype), device=device)


def _row_shards(payloads: np.ndarray, lengths: np.ndarray, mesh: Mesh):
    """``[(device, payload tensor, lengths tensor)]``: row block d of a
    batch already padded by :func:`shard_batch`, staged on shard d's
    device."""
    devs = list(mesh.devices.flat)
    rows = payloads.shape[0] // len(devs)
    return [(dev, stage(payloads[d * rows:(d + 1) * rows], np.uint8, dev),
             stage(lengths[d * rows:(d + 1) * rows], np.int32, dev))
            for d, dev in enumerate(devs)]


def _sum(parts, device) -> torch.Tensor:
    """The shards' int32 counts added on ``device`` (the psum)."""
    return torch.stack([p.to(device) for p in parts]).sum(dim=0, dtype=torch.int32)


def _staged_window(matcher, device):
    """The matcher's window tables on ``device``, staged once per program
    and device (a sharded call runs per chunk of a stream)."""
    w = matcher.window
    staged = getattr(matcher, "_staged_window_tables", None)
    if staged is None or staged[0] is not w:
        staged = matcher._staged_window_tables = (w, {})
    tabs = staged[1].get(device)
    if tabs is None:
        tabs = staged[1][device] = w.tables(device)
    return tabs


def _ac_shard(cac: CompiledAC, dev, p, l, states=None):
    """``(unique counts, new states)`` of one shard's rows on ``dev`` (the
    automaton's tables copied there when they live elsewhere), from the
    root or from ``states`` that the caller has checked."""
    same = canonical_device(dev) == canonical_device(cac.device)
    c = cac if same else cac.to(dev)
    if states is None:
        states = torch.zeros(p.shape[0], dtype=torch.int32, device=dev)
    return ac_scan(c, p, l, states, check=False)


def count_chunk_sharded(cac: CompiledAC, payloads, lengths, states, mesh: Mesh, *,
                        dup_map: Optional[np.ndarray] = None, check: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carried-state AC chunk scan with the flow lanes sharded over the
    mesh: ``(counts, new_states)``, counts over unique patterns (or
    dup-expanded with ``dup_map``) summed on the first shard's device, and
    the int32[F] states after the chunk there too.  Each shard scans its
    own lanes from their own states; the lane count must divide over the
    mesh (the flow monitor's lane quantization guarantees it).  States
    outside ``[0, dead]`` are refused with ``ValueError``; ``check=False``
    skips that check, for states only the kernel wrote."""
    devs = list(mesh.devices.flat)
    F = int(np.shape(payloads)[0])
    if F % len(devs):
        raise ValueError(f"{F} flow lanes do not divide over {len(devs)} shards")
    rows = F // len(devs)
    states = torch.as_tensor(states, dtype=torch.int32)
    if check:
        check_states(states, cac.dead)
    parts, outs = [], []
    for d, (dev, p, l) in enumerate(_row_shards(np.asarray(payloads), np.asarray(lengths), mesh)):
        st = states[d * rows:(d + 1) * rows].to(dev).contiguous()
        counts, new = _ac_shard(cac, dev, p, l, st)
        parts.append(counts)
        outs.append(new.to(devs[0]))
    counts = _sum(parts, devs[0])
    if dup_map is not None:
        counts = counts[torch.as_tensor(np.asarray(dup_map), dtype=torch.long, device=devs[0])]
    return counts, torch.cat(outs)


def count_flow_round_sharded(matcher, x2, eff2, ms2, mesh: Mesh, *, engine: str = "window"
                             ) -> torch.Tensor:
    """One flow round over a sub-lane tile (FlowStreamMatcher's
    ``_expand_round_lanes`` layout) with the sub-lanes sharded over the
    mesh: int32[U] build-order counts, summed on the first shard's device.
    ``engine='pallas'`` launches the halo kernel on each shard
    (``window_count_halo``); ``'window'`` runs its plain form."""
    devs = list(mesh.devices.flat)
    n_dev = len(devs)
    R = x2.shape[0]
    R_pad = -(-R // n_dev) * n_dev
    if R_pad != R:  # padding sub-lanes: all-zero, eff 0 -> count 0
        x2 = np.pad(np.asarray(x2), ((0, R_pad - R), (0, 0)))
        eff2 = np.pad(np.asarray(eff2), (0, R_pad - R))
        ms2 = np.pad(np.asarray(ms2), (0, R_pad - R))
    H = max(int(matcher.window.max_len) - 1, 1)
    rows = R_pad // n_dev
    parts = []
    for d, dev in enumerate(devs):
        x, eff, ms = (stage(a[d * rows:(d + 1) * rows], dt, dev)
                      for a, dt in ((x2, np.uint8), (eff2, np.int32), (ms2, np.int32)))
        if engine == "pallas":
            parts.append(matcher.halo_kernels.on_device(dev).count_tile_halo(x, eff, ms))
        else:
            parts.append(window_count_halo_plain(x, eff, ms, H, _staged_window(matcher, dev)))
    return _sum(parts, devs[0])


def count_matches_sharded(
    cac,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    dup_map: Optional[np.ndarray] = None,
    engine: str = "ac",
    window=None,
    pallas_matcher=None,
) -> np.ndarray:
    """Packet-sharded totals, equal to the one-device count.

    ``engine='ac'`` (the JAX package's default; ``'kmp'`` runs as ``'ac'``,
    as there) scans each shard with the automaton ``cac``;
    ``engine='window'`` (pass the ``WindowProgram`` as ``window``) runs the
    plain window count per shard; ``engine='pallas'`` (pass a tile-count
    surface, ``CudaWindowMatcher`` or ``CudaTableMatcher``, as
    ``pallas_matcher``) its kernels, on a copy bound to each shard's device.
    ``cac`` is unused by the window family and may be ``None`` there."""
    if engine == "kmp":
        engine = "ac"
    if engine not in ("window", "pallas", "ac"):
        raise ValueError(f"unknown sharded engine {engine!r}: expected ac, window or pallas")
    if engine == "ac" and cac is None:
        raise ValueError("pass the CompiledAC as cac for engine='ac'")
    if engine == "pallas" and pallas_matcher is None:
        raise ValueError("pass pallas_matcher= (a CudaWindowMatcher or CudaTableMatcher) "
                         "for engine='pallas'")
    if engine == "window" and window is None:
        raise ValueError("pass window=WindowProgram for engine='window'")
    payloads, lengths = shard_batch(np.asarray(payloads), np.asarray(lengths), mesh)
    parts = []
    for dev, p, l in _row_shards(payloads, lengths, mesh):
        if engine == "pallas":
            parts.append(pallas_matcher.on_device(dev).count_tiles([(p, l)],
                                                                   expand_duplicates=False))
        elif engine == "ac":
            parts.append(_ac_shard(cac, dev, p, l)[0])
        else:
            parts.append(window_count(*window.tables(dev), p, l))
    counts = _sum(parts, mesh.devices.flat[0]).cpu().numpy()
    if dup_map is not None:
        counts = counts[dup_map]
    return counts


def count_tile_sharded(matcher, payload: torch.Tensor, fill: torch.Tensor, mesh: Mesh, *,
                       engine: str = "pallas") -> torch.Tensor:
    """int32[U] build-order totals of one staged tile (tensors on the mesh's
    first device, rows a multiple of the mesh size) with its row blocks
    counted on their shards and summed on the first device: the packed-tile
    pipeline's step (the JAX package's ``_sharded_count_pallas`` /
    ``_sharded_count_window`` / ``_sharded_count``: ``engine`` is
    ``pallas``, ``window`` or ``ac``).  A shard on the tile's own device reads its
    rows in place; others get a device-to-device copy.  Nothing waits for
    the result."""
    devs = list(mesh.devices.flat)
    if payload.shape[0] % len(devs):
        raise ValueError(f"{payload.shape[0]} tile rows do not divide over {len(devs)} shards")
    rows = payload.shape[0] // len(devs)
    parts = []
    for d, dev in enumerate(devs):
        p = payload[d * rows:(d + 1) * rows].to(dev, non_blocking=True)
        l = fill[d * rows:(d + 1) * rows].to(dev, non_blocking=True)
        if engine == "pallas":
            parts.append(matcher.kernels.on_device(dev).count_tiles([(p, l)],
                                                                   expand_duplicates=False))
        elif engine == "ac":
            parts.append(_ac_shard(matcher.cac, dev, p, l)[0])
        else:
            parts.append(window_count(*_staged_window(matcher, dev), p, l))
    return _sum(parts, devs[0])


def count_rows_sharded(
    matcher,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    engine: str = "window",
    expand_duplicates: bool = True,
) -> np.ndarray:
    """Per-packet counts [N, U or P] with the rows sharded over the mesh
    (each shard keeps its rows: no merge but their order).  ``'pallas'``
    runs the per-row kernels of ``matcher.kernels`` on each shard's device,
    any other engine the plain window count."""
    n = int(np.shape(payloads)[0])
    payloads = matcher._maybe_fold(np.asarray(payloads))
    payloads, lengths = shard_batch(payloads, np.asarray(lengths), mesh)
    outs = []
    for dev, p, l in _row_shards(payloads, lengths, mesh):
        if engine == "pallas":
            (rows,) = matcher.kernels.on_device(dev).count_tiles_per_row(
                [(p, l)], expand_duplicates=False)
        else:
            rows = window_count(*_staged_window(matcher, dev), p, l, per_packet=True)
        outs.append(rows)
    out = np.concatenate([o.cpu().numpy() for o in outs])[:n]
    if expand_duplicates:
        out = out[:, matcher.window.dup_map]
    return out


def count_rows_summary(
    matcher,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    engine: str = "window",
) -> Tuple[np.ndarray, np.ndarray]:
    """``(unique totals int64[U] in build order, row_hits bool[N])``, the
    per-row scan sharded over the mesh and reduced on each shard's device,
    so only totals and hit flags leave it.  Feeds of
    ``SUMMARY_MAX_POSITIONS`` positions or more are sliced, with int64
    totals on the host across slices."""

    def once(payloads, lengths):
        n = int(np.shape(payloads)[0])
        payloads = matcher._maybe_fold(np.asarray(payloads))
        payloads, lengths = shard_batch(payloads, np.asarray(lengths), mesh)
        tots, hits = [], []
        for dev, p, l in _row_shards(payloads, lengths, mesh):
            if engine == "pallas":
                t, h = matcher.kernels.on_device(dev).count_tile_summary(p, l)
            else:
                rows = window_count(*_staged_window(matcher, dev), p, l, per_packet=True)
                t, h = rows.sum(dim=0, dtype=torch.int32), rows.sum(dim=1) > 0
            tots.append(t)
            hits.append(h)
        tot = _sum(tots, mesh.devices.flat[0]).cpu().numpy().astype(np.int64)
        return tot, np.concatenate([h.cpu().numpy() for h in hits])[:n]

    return sliced_summary(once, payloads, lengths, mesh.devices.size,
                          len(matcher.window.unique_patterns))


def sliced_summary(once, payloads, lengths, n_pkt: int, num_unique: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``once(payloads, lengths)`` -> ``(int64 totals, row_hits)`` over the
    whole feed, or over slices of fewer than ``SUMMARY_MAX_POSITIONS``
    positions each, whose row counts divide into ``n_pkt`` packet shards,
    with the totals added on the host in int64."""
    n, L = int(np.shape(payloads)[0]), int(np.shape(payloads)[1])
    if n * max(L, 1) < SUMMARY_MAX_POSITIONS:
        return once(payloads, lengths)
    # Strictly below the bound; flooring to a mesh-divisible count only
    # shrinks it, except the one-row-per-shard floor, which is guarded.
    step = max((SUMMARY_MAX_POSITIONS - 1) // max(L, 1), 1)
    step = max(step // n_pkt, 1) * n_pkt
    if step * L >= SUMMARY_MAX_POSITIONS:
        raise ValueError(
            f"rows of {L} bytes cannot be sliced below the device int32 "
            f"bound on a mesh of {n_pkt} packet shards"
        )
    tot = np.zeros(num_unique, dtype=np.int64)
    hit_parts = []
    lengths = np.asarray(lengths)
    for s in range(0, n, step):
        t, h = once(payloads[s : s + step], lengths[s : s + step])
        tot += t
        hit_parts.append(h)
    return tot, np.concatenate(hit_parts)
