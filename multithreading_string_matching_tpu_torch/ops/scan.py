"""DFA byte scans: the Aho-Corasick engine and the per-pattern KMP engine.

Counterpart of ``multithreading_string_matching_tpu/ops/scan.py``, whose
scans are XLA ``lax.scan`` loops (no Pallas kernel): one table gather per
byte per lane, the lane's state carried from byte to byte.  Here each scan
has a plain PyTorch version (a Python loop over byte columns with one
gather each, on any device) and a hand-written CUDA kernel
(``csrc/scan.cu``: ``ac_scan`` and ``kmp_scan``), built with ``nvcc`` from
the checkout on first use (ops/_build.py) and bound with ctypes.

The wrappers take the plain version for tensors on the CPU and launch the
kernel for tensors on a CUDA device; on a CUDA tensor they launch or raise,
never fall back.  ``LAUNCHES`` counts kernel launches by name.

- :func:`ac_scan` / :func:`kmp_scan` scan one tile.
- :func:`ac_scan_tiles` / :func:`kmp_scan_tiles` scan a list of tiles (a
  pass over bucket tiles) in one launch, or one launch per run of tiles
  under 2^31 positions (:func:`split_tiles`).  On the CPU they run the
  plain version tile by tile.

The kernels' host-side plans live here too: the AC segment size
(:func:`ac_segment_bytes`), the tile descriptors (:data:`TILE_DTYPE`,
:func:`tile_descriptors`) and the KMP pattern groups (:func:`kmp_groups`).

Semantics, as the JAX package's:

- **Aho-Corasick** (:func:`count_matches_ac`): lane r advances through its
  first ``clamp(lengths[r], 0, L)`` bytes from ``initial_states[r]``; a
  masked position HOLDS the lane's state, so the returned state is the
  state after the lane's real bytes and a later chunk can append more bytes
  to the same stream (carried-state streaming, flow revival).  Each valid
  position counts every unique pattern that ends at the state it reaches.
  Counts are over unique patterns (``int32[U]`` or ``int32[N, U]``), or
  over the pattern file's order when ``dup_map`` is given.  An initial
  state outside ``[0, dead]`` is refused with ``ValueError`` (the JAX
  package's ``jnp.take`` fills or wraps such indices instead: its result
  there is not the automaton's).
- **KMP** (:func:`count_matches_kmp`): one DFA per pattern, every lane from
  state 0; a position counts for pattern p when p's DFA reaches its accept
  state.  Counts are over the full pattern list, duplicates included
  (``int32[P]`` or ``int32[N, P]``).

No contraction goes through floating point: the plain AC version counts
visits per emitting state and expands them to patterns with an integer
``index_add_``; the kernel counts each pattern that ends at a visited state
(a CSR of outputs per state) directly.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.models.aho_corasick import AhoCorasick
from multithreading_string_matching_tpu_torch.ops._build import CSRC_DIR, KernelLibrary
from multithreading_string_matching_tpu_torch.ops.cuda_window import check_tile, device_kind

SOURCES = [CSRC_DIR / "scan.cu"]

# Kernel launches by kernel name, for this process.  Incremented only where
# a wrapper launches its kernel.
LAUNCHES: Dict[str, int] = {"ac_scan": 0, "kmp_scan": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
LIBRARY = KernelLibrary("msm_scan", SOURCES, {
    # tiles_host, tiles_dev, num_tiles, total, table, table_bytes (2|4),
    # flagged, emit_bits, out_ptr, out_ids, out, num_states, depth, U,
    # per_row, device, stream
    "msm_ac_scan": [_P, _P, _I, _LL, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # tiles_host, tiles_dev, num_tiles, total, table, table_bytes (1|4),
    # accept, order, out, P, M, groups, group_size, smem, per_row, device,
    # stream
    "msm_kmp_scan": [_P, _P, _I, _LL, _P, _I, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _I, _P],
})
load_library = LIBRARY.load
BUILD_INFO = LIBRARY.build_info

# Tables of fewer states than this hold them as uint16 (a 16-bit view of an
# int16 tensor); larger ones keep int32.
UINT16_STATES = 1 << 16
# uint16 tables of at most this many states carry the emitting-state bit in
# bit 15 of the kernel's table (int32 tables in bit 31); larger uint16
# tables keep a bitmap of emitting states.
FLAG16_STATES = 1 << 15

# One tile of a kernel launch (csrc/scan.cu ``Tile``): pointers, the global
# index of its first work item (AC segment, KMP row), its first row in a
# per-row output, its shape, its segment bytes and segments a row.
TILE_DTYPE = np.dtype([
    ("payload", "<i8"), ("lengths", "<i8"), ("states_in", "<i8"), ("states_out", "<i8"),
    ("first", "<i8"), ("row0", "<i8"), ("n", "<i4"), ("L", "<i4"), ("C", "<i4"),
    ("segs", "<i4"),
])
assert TILE_DTYPE.itemsize == 64

# Counts are int32: a launch scans fewer than this many positions (a
# position ends at most one match per pattern).
POSITION_LIMIT = 2**31

# KMP pattern groups: the slot counts the kernel is built for, the shared
# memory a group's staged DFAs may take (two blocks share an SM), and the
# lanes (rows x groups) a launch should reach to fill the card (chip_smoke.py
# phase 11 times 16,384 to 2^20 on an H100: 65,536 was the fastest for a
# bucket tile of ~1,900 rows, and a pass of 100,000 rows keeps 4 groups).
KMP_GROUP_SIZES = (1, 2, 4, 8, 12, 16, 20, 24, 28, 32)
KMP_SMEM_BYTES = 112 * 1024
KMP_FILL_LANES = 65536


def _uint16_table(a: np.ndarray) -> torch.Tensor:
    """uint16 values carried in an int16 tensor (PyTorch's uint16 support
    is partial); the kernels read them as uint16, the plain versions mask
    them back with 0xFFFF."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint16).view(np.int16))


def _table_values(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 entries of a flat transition table at ``idx``."""
    v = table[idx].long()
    return v & 0xFFFF if table.dtype == torch.int16 else v


def state_depths(goto: np.ndarray) -> np.ndarray:
    """Each state's depth (the length of the string it stands for) by a
    breadth-first walk of ``goto`` from the root; -1 where the root does
    not reach (the dead state).  In a failure-closed AC table the shortest
    path to a state spells its trie string, so the walk's distance is the
    trie depth."""
    n = goto.shape[0]
    depth = np.full(n, -1, np.int64)
    depth[0] = 0
    frontier = np.zeros(1, np.int64)
    d = 0
    while frontier.size:
        d += 1
        new = np.zeros(n, bool)
        new[goto[frontier].ravel()] = True
        new &= depth < 0
        frontier = np.flatnonzero(new)
        depth[frontier] = d
    return depth


class CompiledAC(NamedTuple):
    """An Aho-Corasick automaton's tensors on one device.

    ``table`` is the goto table flattened row-major, ``[(S+1) * 256]``,
    uint16 (as int16) below :data:`UINT16_STATES` states, else int32; the
    plain version reads it.  ``ktable`` is the kernel's: the same entries
    with the emitting bit of the state each leads to in the top bit
    (``kflag``), or ``table`` itself for uint16 tables past
    :data:`FLAG16_STATES` states, whose kernel reads ``emit_bits``.
    ``emit_ids``/``emit_sub`` are the JAX package's (the emitting states
    and their emit rows); ``out_ptr``/``out_ids`` (a CSR of the unique
    patterns each state emits), ``emit_index`` (each state's row in
    ``emit_ids``, or E) and ``pair_e`` (the row of each ``out_ids`` entry's
    state) are the scans' own.  ``depth`` is the greatest state depth (the
    kernel's segment warm-up), or None where the root does not reach every
    live state (then a row is one segment)."""

    table: torch.Tensor      # int16 (uint16 values) or int32 [(S+1) * 256]
    ktable: torch.Tensor     # the kernel's table (flagged entries, or table)
    emit_sub: torch.Tensor   # int32[E, U]
    emit_ids: torch.Tensor   # int32[E]
    emit_bits: torch.Tensor  # int32[ceil((S+1) / 32)] emitting-state bitmap
    out_ptr: torch.Tensor    # int32[S+2] CSR row pointers, by state
    out_ids: torch.Tensor    # int32[nnz] unique pattern ids
    emit_index: torch.Tensor # int64[S+1] state -> row of emit_ids, E if none
    pair_e: torch.Tensor     # int64[nnz] emit row of each out_ids entry
    dead: int
    num_unique: int
    dup_map: Optional[np.ndarray]
    kflag: bool
    depth: Optional[int]

    @property
    def num_states(self) -> int:
        """States in the table, the dead state included (S + 1)."""
        return self.dead + 1

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def goto_flat(self) -> torch.Tensor:
        """The goto table as int32 ``[(S+1) * 256]`` (the JAX package's
        ``goto_flat``)."""
        return _table_values(self.table, torch.arange(self.table.numel(),
                                                      device=self.device)).int()

    @staticmethod
    def from_automaton(ac: AhoCorasick, device="cpu") -> "CompiledAC":
        return CompiledAC.from_numpy(ac.goto, ac.emit, ac.dup_map, device=device)

    @staticmethod
    def from_numpy(goto, emit, dup_map=None, device="cpu") -> "CompiledAC":
        """Compile ``goto`` int32[S+1, 256] and ``emit`` int32[S+1, U] (an
        ``AhoCorasick``'s arrays, from either package) for ``device``."""
        goto = np.asarray(goto)
        emit = np.asarray(emit)
        if goto.ndim != 2 or goto.shape[1] != 256 or emit.shape[0] != goto.shape[0]:
            raise ValueError(f"goto {goto.shape} and emit {emit.shape} do not agree")
        n_states = goto.shape[0]
        if goto.min() < 0 or goto.max() >= n_states:
            raise ValueError("goto holds states outside the table")
        device = torch.device(device)
        flat = goto.reshape(-1)
        small = n_states <= UINT16_STATES
        table = (_uint16_table(flat) if small
                 else torch.from_numpy(np.ascontiguousarray(flat, dtype=np.int32)))
        emitting = emit.sum(axis=1) > 0
        ids = np.nonzero(emitting)[0].astype(np.int32)
        kflag = not small or n_states <= FLAG16_STATES
        if not kflag:
            ktable = table
        elif small:
            ktable = _uint16_table(flat | (emitting[flat].astype(np.int64) << 15))
        else:
            kt = flat.astype(np.uint32) | (emitting[flat].astype(np.uint32) << 31)
            ktable = torch.from_numpy(kt.view(np.int32))
        st, u = np.nonzero(emit)                   # by state, then pattern
        ptr = np.zeros(n_states + 1, np.int32)
        np.cumsum(np.bincount(st, minlength=n_states), out=ptr[1:])
        bits = np.zeros(-(-n_states // 32), np.uint32)
        np.bitwise_or.at(bits, ids // 32, np.uint32(1) << (ids % 32).astype(np.uint32))
        eidx = np.full(n_states, len(ids), np.int64)
        eidx[ids] = np.arange(len(ids))
        depths = state_depths(goto)
        reached = (depths[:-1] >= 0).all()

        def dev(a):
            t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device)

        table_dev = dev(table)
        return CompiledAC(
            table=table_dev,
            ktable=table_dev if ktable is table else dev(ktable),
            emit_sub=dev(emit[ids].astype(np.int32)),
            emit_ids=dev(ids),
            emit_bits=dev(bits.view(np.int32)),
            out_ptr=dev(ptr),
            out_ids=dev(u.astype(np.int32)),
            emit_index=dev(eidx),
            pair_e=dev(eidx[st]),
            dead=n_states - 1,
            num_unique=int(emit.shape[1]),
            dup_map=None if dup_map is None else np.asarray(dup_map, np.int32),
            kflag=bool(kflag),
            depth=int(depths.max()) if reached else None,
        )

    def to(self, device) -> "CompiledAC":
        """The same automaton's tensors on ``device``."""
        device = torch.device(device)
        moved = {f: getattr(self, f).to(device) for f in self._fields
                 if torch.is_tensor(getattr(self, f))}
        if self.ktable is self.table:
            moved["ktable"] = moved["table"]
        return self._replace(**moved)


class CompiledKMP(NamedTuple):
    """Stacked per-pattern KMP DFAs on one device: ``table`` ``[P, M, 256]``
    (uint8 when M <= 256, else int32), ``accept`` int32[P] (each pattern's
    accept state, its length), ``order`` int32[P] (the patterns by accept
    state, the kernel's groups), and host copies of ``accept`` and
    ``order``."""

    table: torch.Tensor
    accept: torch.Tensor
    accept_host: np.ndarray
    order: torch.Tensor
    order_host: np.ndarray

    @property
    def device(self) -> torch.device:
        return self.table.device

    @staticmethod
    def from_numpy(dfas, accept, device="cpu") -> "CompiledKMP":
        dfas = np.asarray(dfas)
        accept = np.asarray(accept, np.int32)
        if dfas.ndim != 3 or dfas.shape[2] != 256 or dfas.shape[0] != accept.shape[0]:
            raise ValueError(f"dfas {dfas.shape} and accept {accept.shape} do not agree")
        P, M, _ = dfas.shape
        if P and (accept.min() < 1 or accept.max() >= M):
            raise ValueError(f"accept states must lie in [1, {M - 1}]")
        dtype = np.uint8 if M <= 256 else np.int32
        table = torch.from_numpy(np.ascontiguousarray(dfas, dtype=dtype))
        order = np.argsort(accept, kind="stable").astype(np.int32)
        return CompiledKMP(table=table.to(device), accept=torch.from_numpy(accept).to(device),
                           accept_host=accept, order=torch.from_numpy(order).to(device),
                           order_host=order)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def check_states(states, dead: int) -> None:
    """Raise ``ValueError`` unless every state lies in ``[0, dead]``.  A
    CUDA tensor is checked on the card, with one wait for the answer."""
    t = torch.as_tensor(states)
    if t.numel() and bool(((t < 0) | (t > dead)).any()):
        bad = t[(t < 0) | (t > dead)][:4].tolist()
        raise ValueError(f"AC start states must lie in [0, {dead}] (the dead state); got {bad}")


def ac_scan_plain(cac: CompiledAC, payload: torch.Tensor, lengths: torch.Tensor,
                  states: torch.Tensor, *, per_packet: bool = False):
    """``(counts, new_states)``: unique-pattern counts (int32[U], or
    int32[n, U] with ``per_packet``) and int32[n] final states, by a loop
    over byte columns (one gather each), on the tensors' device."""
    check_states(states, cac.dead)
    n, L = payload.shape
    dev = payload.device
    E = int(cac.emit_ids.numel())
    lengths = lengths.long()
    st = states.long()
    # Visits per lane and emitting state; column E is the sink for
    # positions that emit nothing.
    hist = torch.zeros((n, E + 1), dtype=torch.int32, device=dev)
    lanes = torch.arange(n, device=dev)
    for j in range(L):
        valid = j < lengths
        nxt = _table_values(cac.table, st * 256 + payload[:, j].long())
        st = torch.where(valid, nxt, st)
        e = torch.where(valid, cac.emit_index[st], E)
        hist[lanes, e] += 1
    hist = hist[:, :E]
    # Exact contraction with emit_sub: one index_add_ per (state, pattern) pair.
    if per_packet:
        counts = torch.zeros((n, cac.num_unique), dtype=torch.int32, device=dev)
        counts.index_add_(1, cac.out_ids, hist[:, cac.pair_e])
    else:
        counts = torch.zeros(cac.num_unique, dtype=torch.int32, device=dev)
        counts.index_add_(0, cac.out_ids, hist.sum(dim=0, dtype=torch.int32)[cac.pair_e])
    return counts, st.int()


def kmp_scan_plain(kmp: CompiledKMP, payload: torch.Tensor, lengths: torch.Tensor, *,
                   per_packet: bool = False) -> torch.Tensor:
    """int32[P] totals, or int32[n, P] with ``per_packet``, by a loop over
    byte columns advancing every (pattern, lane) state with one gather."""
    n, L = payload.shape
    P, M, _ = kmp.table.shape
    dev = payload.device
    flat = kmp.table.reshape(-1)
    base = (torch.arange(P, device=dev) * (M * 256))[:, None]
    accept = kmp.accept.long()[:, None]
    lengths = lengths.long()
    st = torch.zeros((P, n), dtype=torch.long, device=dev)
    cnt = torch.zeros((P, n), dtype=torch.int32, device=dev)
    for j in range(L):
        valid = (j < lengths)[None, :]
        nxt = flat[base + st * 256 + payload[:, j].long()[None, :]].long()
        st = torch.where(valid, nxt, st)
        cnt += ((nxt == accept) & valid).int()
    return cnt.T.contiguous() if per_packet else cnt.sum(dim=1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Host plans: segments, tile lists, pattern groups
# ---------------------------------------------------------------------------


def ac_segment_bytes(depth: Optional[int], L: int, seg_bytes: Optional[int] = None) -> int:
    """The kernel's segment size C for rows of ``L`` bytes: ``seg_bytes``
    if given, else ``max(64, 4 * depth)`` rounded up to 16, so that the
    warm-up stays under a quarter of a segment; capped at ``L`` (at least
    1).  Without a depth (a table the root does not fully reach) a row is
    one segment, whatever ``seg_bytes`` asks: no warm-up from the root is
    known to reach the lane's state."""
    if seg_bytes is not None and seg_bytes < 1:
        raise ValueError(f"segments of {seg_bytes} bytes")
    if depth is None:
        return max(1, int(L))
    if seg_bytes is None:
        seg_bytes = -(-max(64, 4 * depth) // 16) * 16
    return max(1, min(int(seg_bytes), int(L)))


def split_tiles(shapes: Sequence[Tuple[int, int]], limit: int = POSITION_LIMIT) -> List[range]:
    """Runs of consecutive tiles (by ``(n, L)``) whose summed positions stay
    below ``limit``: one launch each.  A single tile at or past the limit
    is refused."""
    runs, start, total = [], 0, 0
    for i, (n, L) in enumerate(shapes):
        pos = int(n) * int(L)
        if pos >= limit:
            raise ValueError(f"a tile of {n} x {L} positions overflows the int32 counters; "
                             "split it")
        if total + pos >= limit:
            runs.append(range(start, i))
            start, total = i, 0
        total += pos
    if start < len(shapes):
        runs.append(range(start, len(shapes)))
    return runs


def tile_descriptors(tiles, seg_of=None, states_in=None, states_out=None
                     ) -> Tuple[np.ndarray, int]:
    """``(descriptors, total work items)`` of a launch over ``tiles`` (a
    list of ``(payload, lengths)`` tensors): :data:`TILE_DTYPE` rows with
    the tensors' addresses, each tile's first global work item and its
    first row in a per-row output.  ``seg_of(L)`` gives the AC segment
    bytes of rows of ``L`` bytes (segments a row: ``ceil(L / C)``, at least
    1); without it a row is one work item (KMP)."""
    desc = np.zeros(len(tiles), TILE_DTYPE)
    first = row0 = 0
    for i, (p, l) in enumerate(tiles):
        n, L = p.shape
        C = seg_of(L) if seg_of is not None else 0
        segs = max(1, -(-L // C)) if C else 1
        desc[i] = (p.data_ptr(), l.data_ptr(),
                   0 if states_in is None else states_in[i].data_ptr(),
                   0 if states_out is None else states_out[i].data_ptr(),
                   first, row0, n, L, C, segs)
        first += n * segs
        row0 += n
    return desc, first


def _upload(desc: np.ndarray, dev) -> Optional[torch.Tensor]:
    """The descriptors on the card for a list of more than one tile (a
    single tile travels in the launch's arguments)."""
    if len(desc) < 2:
        return None
    return torch.from_numpy(desc.view(np.uint8)).to(dev, non_blocking=True)


def kmp_groups(accept_sorted: np.ndarray, rows: int, *, smem_bytes: Optional[int] = None,
               fill_lanes: Optional[int] = None) -> Tuple[int, int, int]:
    """``(groups, slots, smem)`` of a ``kmp_scan`` launch over ``rows``
    rows, for patterns whose accept states are ``accept_sorted``
    (ascending, the kernel's ``order``).  Group g holds sorted patterns
    ``g*P//groups .. (g+1)*P//groups``; a block stages its group's DFAs in
    ``slots`` (a size the kernel is built for) interleaved uint8 slots of R
    states (R: the group's largest accept + 1); ``smem`` holds the largest
    group's R.  As few groups as registers (at most 32 slots) and
    shared memory (``smem_bytes``) allow, but enough that rows x groups
    reaches ``fill_lanes``, so a small launch still fills the card."""
    smem_bytes = KMP_SMEM_BYTES if smem_bytes is None else smem_bytes
    fill_lanes = KMP_FILL_LANES if fill_lanes is None else fill_lanes
    acc = np.asarray(accept_sorted, np.int64)
    P = len(acc)
    if P == 0:
        raise ValueError("no patterns")
    groups = max(-(-P // KMP_GROUP_SIZES[-1]), min(P, -(-fill_lanes // max(1, rows))))
    while True:
        size = -(-P // groups)
        slots = next(s for s in KMP_GROUP_SIZES if s >= size)
        smem = (int(acc[-1]) + 1) * slots * 256
        if smem <= smem_bytes or groups == P:
            return groups, slots, smem
        groups += 1


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_same_device(payload, *tables) -> None:
    for t in tables:
        if t.device != payload.device:
            raise ValueError(f"tables are on {t.device}, payload on {payload.device}")


def _check_tiles(tiles, tables, states=None) -> None:
    """Raise on tiles (and per-tile states) the kernels do not take: the
    wrong dtype, rank, device or layout, states of another row count."""
    if tiles:
        _check_same_device(tiles[0][0], *tables)
    for i, (p, l) in enumerate(tiles):
        check_tile(p, l, () if states is None else (("states", states[i], 1),))
        _check_same_device(p, tables[0])
        if states is not None and states[i].shape[0] != p.shape[0]:
            raise ValueError(f"states has {states[i].shape[0]} rows, payload {p.shape[0]}")


def _on_cpu(tiles, default: torch.device, kernel: str) -> bool:
    """Whether a tile list runs the plain version: its tensors (or, for an
    empty list, the tables) lie on the CPU."""
    probe = tiles[0][0] if tiles else torch.empty(0, device=default)
    return device_kind(probe, kernel) == "cpu"


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _scan_runs(tiles, width: int, per_packet: bool, dev, launch) -> torch.Tensor:
    """int32[width] totals, or int32[rows, width] rows in tile order, from
    ``launch(run, out)`` once per run of tiles under 2^31 positions
    (:func:`split_tiles`).  A per-row run writes from its first tile's row
    on; each run of totals has counters of its own, added after (in int32,
    as a per-tile loop adds its tiles)."""
    runs = split_tiles([tuple(p.shape) for p, _ in tiles])
    if per_packet:
        starts = np.cumsum([0] + [int(p.shape[0]) for p, _ in tiles])
        out = torch.zeros((int(starts[-1]), width), dtype=torch.int32, device=dev)
        for run in runs:
            launch(run, out[int(starts[run.start]):])
        return out
    out = torch.zeros(width, dtype=torch.int32, device=dev)
    for run in runs:
        part = out if len(runs) == 1 else torch.zeros_like(out)
        launch(run, part)
        if part is not out:
            out += part
    return out


def _ac_launch(cac: CompiledAC, tiles, out: torch.Tensor, per_packet: bool,
               seg_bytes: Optional[int], states_in=None, states_out=None) -> None:
    """One ``ac_scan`` launch over ``tiles`` (checked, on ``cac``'s
    device, under 2^31 positions), adding into ``out``."""
    desc, total = tile_descriptors(
        tiles, lambda L: ac_segment_bytes(cac.depth, L, seg_bytes), states_in, states_out)
    if total == 0:
        return
    dev = out.device
    on_card = _upload(desc, dev)
    LIBRARY.call("msm_ac_scan", desc.ctypes.data, 0 if on_card is None else on_card.data_ptr(),
                 len(desc), total, cac.ktable.data_ptr(), cac.ktable.element_size(),
                 int(cac.kflag), cac.emit_bits.data_ptr(), cac.out_ptr.data_ptr(),
                 cac.out_ids.data_ptr(), out.data_ptr(), cac.num_states, int(cac.depth or 0),
                 cac.num_unique, int(per_packet), dev.index or 0, _stream(dev))
    LAUNCHES["ac_scan"] += 1


def ac_scan_tiles(cac: CompiledAC, tiles, *, per_packet: bool = False, states=None,
                  seg_bytes: Optional[int] = None, check: bool = True):
    """Unique-pattern counts over a list of ``(payload uint8[n_i, L_i],
    lengths int32[n_i])`` tiles, every lane from the root or from
    ``states`` (a list of int32[n_i]): int32[U] totals, or int32[sum n_i,
    U] rows in tile order with ``per_packet``; with ``states``, ``(counts,
    new_states list)``.  States outside ``[0, dead]`` are refused with
    ``ValueError``; ``check=False`` skips that check on the card, for states
    that only the kernel wrote (the flow engine's): it waits for the card.

    On a CUDA device one ``ac_scan`` launch for the whole list (one per run
    of tiles under 2^31 positions, :func:`split_tiles`; ``seg_bytes``
    overrides the segment size, :func:`ac_segment_bytes`); on the CPU the
    plain version tile by tile."""
    tiles = list(tiles)
    if states is not None and len(states) != len(tiles):
        raise ValueError(f"{len(states)} state vectors for {len(tiles)} tiles")
    U = cac.num_unique
    if _on_cpu(tiles, cac.device, "ac-scan"):
        outs, new = [], []
        for i, (p, l) in enumerate(tiles):
            st = (torch.zeros(p.shape[0], dtype=torch.int32) if states is None else states[i])
            c, s = ac_scan_plain(cac, p, l, st, per_packet=per_packet)
            outs.append(c)
            new.append(s)
        if per_packet:
            out = torch.cat(outs) if outs else torch.zeros((0, U), dtype=torch.int32)
        else:
            out = sum(outs, torch.zeros(U, dtype=torch.int32))
        return (out, new) if states is not None else out
    _check_tiles(tiles, (cac.ktable, cac.emit_bits, cac.out_ptr, cac.out_ids), states)
    if states is not None and check:
        for st in states:
            check_states(st, cac.dead)
    new = None if states is None else [torch.empty_like(s) for s in states]

    def launch(run, out):
        _ac_launch(cac, [tiles[i] for i in run], out, per_packet, seg_bytes,
                   None if states is None else [states[i] for i in run],
                   None if states is None else [new[i] for i in run])

    out = _scan_runs(tiles, U, per_packet, cac.device, launch)
    return (out, new) if states is not None else out


def ac_scan(cac: CompiledAC, payload: torch.Tensor, lengths: torch.Tensor,
            states: torch.Tensor, *, per_packet: bool = False, seg_bytes: Optional[int] = None,
            check: bool = True):
    """``(counts, new_states)`` over one ``uint8[n, L]`` tile: unique-pattern
    counts (int32[U], or int32[n, U] with ``per_packet``) and the int32[n]
    states after each lane's ``clamp(lengths, 0, L)`` bytes, starting from
    ``states``: :func:`ac_scan_tiles` over the one tile (the plain version
    on the CPU, one ``ac_scan`` launch on a CUDA device)."""
    counts, (new_states,) = ac_scan_tiles(cac, [(payload, lengths)], per_packet=per_packet,
                                          states=[states], seg_bytes=seg_bytes, check=check)
    return counts, new_states


def _kmp_launch(kmp: CompiledKMP, tiles, out: torch.Tensor, per_packet: bool) -> None:
    """One ``kmp_scan`` launch over ``tiles`` (checked, on ``kmp``'s
    device, under 2^31 positions), adding into ``out``."""
    desc, total = tile_descriptors(tiles)
    P, M, _ = kmp.table.shape
    if total == 0 or P == 0:
        return
    if kmp.table.element_size() == 1:
        groups, slots, smem = kmp_groups(kmp.accept_host[kmp.order_host], total)
    else:
        groups, slots, smem = P, 1, 0
    dev = out.device
    on_card = _upload(desc, dev)
    LIBRARY.call("msm_kmp_scan", desc.ctypes.data, 0 if on_card is None else on_card.data_ptr(),
                 len(desc), total, kmp.table.data_ptr(), kmp.table.element_size(),
                 kmp.accept.data_ptr(), kmp.order.data_ptr(), out.data_ptr(), P, M, groups, slots,
                 smem, int(per_packet), dev.index or 0, _stream(dev))
    LAUNCHES["kmp_scan"] += 1


def kmp_scan_tiles(kmp: CompiledKMP, tiles, *, per_packet: bool = False) -> torch.Tensor:
    """int32[P] totals, or int32[sum n_i, P] rows in tile order with
    ``per_packet``, over a list of ``(payload, lengths)`` tiles: one
    ``kmp_scan`` launch on a CUDA device (one per run under 2^31
    positions), the plain version tile by tile on the CPU."""
    tiles = list(tiles)
    P = kmp.table.shape[0]
    if _on_cpu(tiles, kmp.device, "kmp-scan"):
        outs = [kmp_scan_plain(kmp, p, l, per_packet=per_packet) for p, l in tiles]
        if per_packet:
            return torch.cat(outs) if outs else torch.zeros((0, P), dtype=torch.int32)
        return sum(outs, torch.zeros(P, dtype=torch.int32))
    _check_tiles(tiles, (kmp.table, kmp.accept, kmp.order))
    return _scan_runs(tiles, P, per_packet, kmp.device,
                      lambda run, out: _kmp_launch(kmp, [tiles[i] for i in run], out, per_packet))


def kmp_scan(kmp: CompiledKMP, payload: torch.Tensor, lengths: torch.Tensor, *,
             per_packet: bool = False) -> torch.Tensor:
    """int32[P] totals, or int32[n, P] with ``per_packet``, over one
    ``uint8[n, L]`` tile: :func:`kmp_scan_tiles` over the one tile (the
    plain version on the CPU, one ``kmp_scan`` launch on a CUDA device)."""
    return kmp_scan_tiles(kmp, [(payload, lengths)], per_packet=per_packet)


# ---------------------------------------------------------------------------
# The JAX package's entry points
# ---------------------------------------------------------------------------


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=device).contiguous()


def count_matches_ac(
    cac: CompiledAC,
    payloads,
    lengths,
    *,
    initial_states=None,
    per_packet: bool = False,
    dup_map: Optional[np.ndarray] = None,
    return_states: bool = False,
    check: bool = True,
):
    """Count every overlapping occurrence of every pattern in every payload,
    on ``cac``'s device.

    Returns int32 counts over unique patterns (``[U]`` or ``[N, U]``), or
    over the original pattern list when ``dup_map`` is given, as a tensor;
    with ``return_states=True`` also the int32[N] final states for
    carried-state streaming.  ``initial_states`` outside ``[0, dead]`` are
    refused with ``ValueError``; ``check=False`` skips that check on the
    card, for states only the kernel wrote (it waits for the card).
    """
    dev = cac.device
    payloads = _tensor(payloads, torch.uint8, dev)
    lengths = _tensor(lengths, torch.int32, dev)
    n = payloads.shape[0]
    states = (torch.zeros(n, dtype=torch.int32, device=dev) if initial_states is None
              else _tensor(initial_states, torch.int32, dev))
    counts, new_states = ac_scan(cac, payloads, lengths, states, per_packet=per_packet,
                                 check=check and initial_states is not None)
    if dup_map is not None:
        counts = counts[..., torch.as_tensor(np.asarray(dup_map), dtype=torch.long, device=dev)]
    if return_states:
        return counts, new_states
    return counts


def count_matches_kmp(
    dfas: Union[np.ndarray, CompiledKMP],
    accept,
    payloads,
    lengths,
    *,
    per_packet: bool = False,
) -> torch.Tensor:
    """Reference-shaped counting: one KMP DFA per pattern over every lane,
    int32[P] or int32[N, P] over the full pattern list (duplicates
    included).  ``dfas`` is a :class:`CompiledKMP` (``accept`` is then
    unused) or the stacked ``[P, M, 256]`` numpy DFAs with ``accept``,
    compiled for the payloads' device (the CPU for host arrays)."""
    if not isinstance(dfas, CompiledKMP):
        dev = payloads.device if torch.is_tensor(payloads) else torch.device("cpu")
        dfas = CompiledKMP.from_numpy(dfas, accept, device=dev)
    dev = dfas.device
    return kmp_scan(dfas, _tensor(payloads, torch.uint8, dev), _tensor(lengths, torch.int32, dev),
                    per_packet=per_packet)
