"""DFA byte scans: the Aho-Corasick engine and the per-pattern KMP engine.

Counterpart of ``multithreading_string_matching_tpu/ops/scan.py``, whose
scans are XLA ``lax.scan`` loops (no Pallas kernel): one table gather per
byte per lane, the lane's state carried from byte to byte.  Here each scan
has a plain PyTorch version (a Python loop over byte columns with one
gather each, on any device) and a hand-written CUDA kernel
(``csrc/scan.cu``: ``ac_scan`` and ``kmp_scan``), built with ``nvcc`` from
the checkout on first use (ops/_build.py) and bound with ctypes.

The wrappers :func:`ac_scan` and :func:`kmp_scan` take the plain version
for tensors on the CPU and launch the kernel for tensors on a CUDA device;
on a CUDA tensor they launch or raise, never fall back.  ``LAUNCHES``
counts kernel launches by name.

Semantics, as the JAX package's:

- **Aho-Corasick** (:func:`count_matches_ac`): lane r advances through its
  first ``clamp(lengths[r], 0, L)`` bytes from ``initial_states[r]``; a
  masked position HOLDS the lane's state, so the returned state is the
  state after the lane's real bytes and a later chunk can append more bytes
  to the same stream (carried-state streaming, flow revival).  Each valid
  position counts every unique pattern that ends at the state it reaches.
  Counts are over unique patterns (``int32[U]`` or ``int32[N, U]``), or
  over the pattern file's order when ``dup_map`` is given.  An initial
  state outside ``[0, dead]`` starts the lane in the dead state.
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
from typing import Dict, NamedTuple, Optional, Union

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
LIBRARY = KernelLibrary("msm_scan", SOURCES, {
    # payload, lengths, states_in, states_out, table, table_bytes (2|4),
    # emit_bits, out_ptr, out_ids, out, n, L, num_states, U, per_row, device, stream
    "msm_ac_scan": [_P] * 5 + [ctypes.c_int] + [_P] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _P],
    # payload, lengths, table, table_bytes (1|4), accept, out, n, L, P, M,
    # max_accept, per_row, device, stream
    "msm_kmp_scan": [_P] * 3 + [ctypes.c_int] + [_P] * 2 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P],
})
load_library = LIBRARY.load
BUILD_INFO = LIBRARY.build_info

# Tables of fewer states than this hold them as uint16 (a 16-bit view of an
# int16 tensor); larger ones keep int32.
UINT16_STATES = 1 << 16


def _uint16_table(a: np.ndarray) -> torch.Tensor:
    """uint16 values carried in an int16 tensor (PyTorch's uint16 support
    is partial); the kernels read them as uint16, the plain versions mask
    them back with 0xFFFF."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint16).view(np.int16))


def _table_values(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 entries of a flat transition table at ``idx``."""
    v = table[idx].long()
    return v & 0xFFFF if table.dtype == torch.int16 else v


class CompiledAC(NamedTuple):
    """An Aho-Corasick automaton's tensors on one device.

    ``table`` is the goto table flattened row-major, ``[(S+1) * 256]``,
    uint16 (as int16) below :data:`UINT16_STATES` states, else int32; the
    kernel and the plain version both read it.  ``emit_ids``/``emit_sub``
    are the JAX package's (the emitting states and their emit rows);
    ``emit_bits``, ``out_ptr``/``out_ids`` (a CSR of the unique patterns
    each state emits), ``emit_index`` (each state's row in ``emit_ids``, or
    E) and ``pair_e`` (the row of each ``out_ids`` entry's state) are the
    scans' own."""

    table: torch.Tensor      # int16 (uint16 values) or int32 [(S+1) * 256]
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
        table = (_uint16_table(flat) if n_states <= UINT16_STATES
                 else torch.from_numpy(np.ascontiguousarray(flat, dtype=np.int32)))
        ids = np.nonzero(emit.sum(axis=1) > 0)[0].astype(np.int32)
        st, u = np.nonzero(emit)                   # by state, then pattern
        ptr = np.zeros(n_states + 1, np.int32)
        np.cumsum(np.bincount(st, minlength=n_states), out=ptr[1:])
        bits = np.zeros(-(-n_states // 32), np.uint32)
        np.bitwise_or.at(bits, ids // 32, np.uint32(1) << (ids % 32).astype(np.uint32))
        eidx = np.full(n_states, len(ids), np.int64)
        eidx[ids] = np.arange(len(ids))

        def dev(a):
            t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device)

        return CompiledAC(
            table=dev(table),
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
        )

    def to(self, device) -> "CompiledAC":
        """The same automaton's tensors on ``device``."""
        device = torch.device(device)
        return self._replace(**{f: getattr(self, f).to(device) for f in self._fields
                                if torch.is_tensor(getattr(self, f))})


class CompiledKMP(NamedTuple):
    """Stacked per-pattern KMP DFAs on one device: ``table`` ``[P, M, 256]``
    (uint8 when M <= 256, else int32), ``accept`` int32[P] (each pattern's
    accept state, its length), and the host copy of ``accept``."""

    table: torch.Tensor
    accept: torch.Tensor
    accept_host: np.ndarray

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
        return CompiledKMP(table=table.to(device), accept=torch.from_numpy(accept).to(device),
                           accept_host=accept)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def ac_scan_plain(cac: CompiledAC, payload: torch.Tensor, lengths: torch.Tensor,
                  states: torch.Tensor, *, per_packet: bool = False):
    """``(counts, new_states)``: unique-pattern counts (int32[U], or
    int32[n, U] with ``per_packet``) and int32[n] final states, by a loop
    over byte columns (one gather each), on the tensors' device."""
    n, L = payload.shape
    dev = payload.device
    E = int(cac.emit_ids.numel())
    lengths = lengths.long()
    st = states.long()
    st = torch.where((st < 0) | (st > cac.dead), torch.full_like(st, cac.dead), st)
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
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_positions(payload) -> None:
    """Counts are int32: a launch scans fewer than 2^31 positions (a
    position ends at most one match per pattern)."""
    n, L = payload.shape
    if n * L >= 2**31:
        raise ValueError(
            f"a tile of {n} x {L} positions overflows the int32 counters; split it")


def _check_same_device(payload, *tables) -> None:
    for t in tables:
        if t.device != payload.device:
            raise ValueError(f"tables are on {t.device}, payload on {payload.device}")


def ac_scan(cac: CompiledAC, payload: torch.Tensor, lengths: torch.Tensor,
            states: torch.Tensor, *, per_packet: bool = False):
    """``(counts, new_states)`` over one ``uint8[n, L]`` tile: unique-pattern
    counts (int32[U], or int32[n, U] with ``per_packet``) and the int32[n]
    states after each lane's ``clamp(lengths, 0, L)`` bytes, starting from
    ``states``.  The plain version on the CPU, the ``ac_scan`` kernel on a
    CUDA device."""
    if device_kind(payload, "ac-scan") == "cpu":
        return ac_scan_plain(cac, payload, lengths, states, per_packet=per_packet)
    check_tile(payload, lengths, (("states", states, 1),))
    if states.shape[0] != payload.shape[0]:
        raise ValueError(f"states has {states.shape[0]} rows, payload {payload.shape[0]}")
    _check_same_device(payload, cac.table, cac.emit_bits, cac.out_ptr, cac.out_ids)
    _check_positions(payload)
    n, L = payload.shape
    U = cac.num_unique
    dev = payload.device
    shape = (n, U) if per_packet else (U,)
    out = torch.zeros(shape, dtype=torch.int32, device=dev)
    new_states = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out, new_states
    LIBRARY.call("msm_ac_scan", payload.data_ptr(), lengths.data_ptr(), states.data_ptr(),
                 new_states.data_ptr(), cac.table.data_ptr(), cac.table.element_size(),
                 cac.emit_bits.data_ptr(), cac.out_ptr.data_ptr(), cac.out_ids.data_ptr(),
                 out.data_ptr(), n, L, cac.num_states, U, int(per_packet),
                 dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["ac_scan"] += 1
    return out, new_states


def kmp_scan(kmp: CompiledKMP, payload: torch.Tensor, lengths: torch.Tensor, *,
             per_packet: bool = False) -> torch.Tensor:
    """int32[P] totals, or int32[n, P] with ``per_packet``, over one
    ``uint8[n, L]`` tile: the plain version on the CPU, the ``kmp_scan``
    kernel on a CUDA device."""
    if device_kind(payload, "kmp-scan") == "cpu":
        return kmp_scan_plain(kmp, payload, lengths, per_packet=per_packet)
    check_tile(payload, lengths, ())
    _check_same_device(payload, kmp.table, kmp.accept)
    _check_positions(payload)
    n, L = payload.shape
    P, M, _ = kmp.table.shape
    dev = payload.device
    out = torch.zeros((n, P) if per_packet else (P,), dtype=torch.int32, device=dev)
    if n == 0 or P == 0:
        return out
    LIBRARY.call("msm_kmp_scan", payload.data_ptr(), lengths.data_ptr(), kmp.table.data_ptr(),
                 kmp.table.element_size(), kmp.accept.data_ptr(), out.data_ptr(), n, L, P, M,
                 int(kmp.accept_host.max()), int(per_packet), dev.index or 0,
                 torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["kmp_scan"] += 1
    return out


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
):
    """Count every overlapping occurrence of every pattern in every payload,
    on ``cac``'s device.

    Returns int32 counts over unique patterns (``[U]`` or ``[N, U]``), or
    over the original pattern list when ``dup_map`` is given, as a tensor;
    with ``return_states=True`` also the int32[N] final states for
    carried-state streaming.
    """
    dev = cac.device
    payloads = _tensor(payloads, torch.uint8, dev)
    lengths = _tensor(lengths, torch.int32, dev)
    n = payloads.shape[0]
    states = (torch.zeros(n, dtype=torch.int32, device=dev) if initial_states is None
              else _tensor(initial_states, torch.int32, dev))
    counts, new_states = ac_scan(cac, payloads, lengths, states, per_packet=per_packet)
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
