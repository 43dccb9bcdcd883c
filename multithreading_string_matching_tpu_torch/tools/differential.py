"""Randomized on-chip differential soak of every hand-written kernel.

Counterpart of ``bench/tpu_differential.py``::

    python -m multithreading_string_matching_tpu_torch.tools.differential
        [--cases N] [--seconds S] [--seed K] [--device cuda|cpu] [--case I] [--out DIR]
        [--targets A,B,...] [--edges]

The CPU tests prove only the kernels' semantics, through their plain
versions; only the card shows a kernel as it is built.  A fixed list of
hand-picked cases covers the kernels' boundaries (segment, group, tile,
hash bucket, probe-mask count) only by luck, so this tool rolls random
content and random shapes, case after case, through each kernel entry
point (:data:`TARGETS`, one per row of PERF.md's kernel table) and holds
the result equal to

- the kernel's plain PyTorch version on the same CUDA tensors, exactly
  (``window_find``'s triples row for row, in order), and
- on every third case of each entry point, the pure-Python ``bytes.find``
  oracle (``tools/oracle.py``).  The plain versions share the table
  builders with the kernels (``WindowProgram``, ``partition``,
  ``bit_tables``, the AC and KMP compilers); the oracle shares nothing.
  Oracle cases are drawn at smaller shapes, so the Python loops stay
  cheap: a table builder's fault does not depend on the tile's size, and
  the large tiles are held to the plain version.

Case ``I`` of seed ``K`` runs entry point ``TARGETS[I % 12]`` on inputs
drawn from ``numpy.random.default_rng([K, I])`` alone: the same seed gives
the same cases, and ``--case I`` runs one of them again.  ``--cases N``
(default 64) is the least number of cases each entry point gets;
``--seconds S`` goes on rolling whole rounds until S seconds have passed.
On the first divergence (or any exception inside a case) the tool prints a
reproducer (seed, case, entry point, shape, the patterns as hex), writes
the case's inputs to ``DIR/<target>-<seed>-<case>.npz`` (``--out``,
default ``soak_out``, git-ignored) and re-raises: the run exits non-zero.

On the card (``--device cuda``, the default; without a card it exits
non-zero) every input lies between two poisoned guard bands (``Case.tensor``:
the case's pattern bytes around payloads, huge lengths, all-wildcard table
rows), so a read past an input changes the result, and each kernel call
must also add exactly its launches to the
wrappers' ``LAUNCHES`` counters, and a run of at least
:data:`COVERAGE_CASES` cases per entry point must have reached the edges
the generators aim at (``mxu_count`` at wgmma widths 96 and 256, a
``window_find`` rerun, KMP groups of 16 or more patterns).  ``--device cpu``
runs the plain versions against the oracle at smaller shapes: it tests
only the harness.  Refusals are checks of their own, never counted as
cases: nine probe masks (``ValueError``, card only), an out-of-range
``reps`` (card only), AC start states outside ``[0, dead]`` and a tile
past ``split_tiles``' position limit.

The summary prints one line per entry point (cases, oracle-checked cases,
seconds) and, on the card, the card's name and power limit.  ``--targets``
soaks only the named entry points (each still on its own case indices, so a
case replays the same inputs either way).  ``--edges`` runs, instead of the
soak, the cases at the int32 position limit of ``tools/edges.py``: every
entry point at its largest accepted launch and refused just past it, the
slicing paths past 2^31 positions and a count past 2^31.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.tools import oracle

TARGETS = (
    "window_count_totals",           # PERF.md kernel table row 1
    "window_count_rows",             # row 2
    "window_count_totals_repeated",  # row 3
    "window_count_halo",             # row 4
    "table_filter_count_totals",     # row 5
    "table_filter_count_rows",       # row 6
    "shard_table_kernel_counts",     # row 7
    "shard_table_kernel_rows",       # row 8
    "mxu_count",                     # row 9
    "window_find",                   # new
    "ac_scan",                       # new
    "kmp_scan",                      # new
)
DEFAULT_CASES = 64
# Runs with at least this many cases per entry point check the coverage of
# the generators' edges (on the card).
COVERAGE_CASES = 32
ORACLE_EVERY = 3
MAX_PATTERN_LEN = 99  # the reference's fscanf cap
# csrc/probe.cuh hashes at most 8 distinct non-zero probe masks a launch.
EIGHT_MASKS = (0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF, 0xFF00, 0xFF0000, 0xFF000000, 0x00FF00FF)
NINTH_MASK = 0xFFFF0000
FIND_TILE = 16384  # csrc/window_find.cu: positions of one flattened tile
# Poisoned bytes before and after every input on the card (a multiple of
# 16, so inputs keep the alignment that vector loads and TMA copies need).
GUARD_BYTES = 512


class Divergence(AssertionError):
    """A kernel disagreed with its plain version or with the oracle, or a
    refusal did not happen."""


class Budget(NamedTuple):
    """Shape limits of a run: the card takes full-size tiles; the CPU runs
    the plain versions at small ones."""

    positions: int      # most n * L of one tile
    patterns: int       # most patterns of one set
    big_automata: bool  # AC tables of more than 2^15 and 2^16 states


BUDGETS = {"cuda": Budget(256 * 4096, 3072, True), "cpu": Budget(8192, 160, False)}


@dataclass
class Case:
    """One case: its entry point, its inputs (numpy arrays, patterns and
    small parameters, all drawn from ``default_rng([seed, index])``) and
    whether the oracle checks it."""

    seed: int
    index: int
    device: torch.device
    rng: np.random.Generator
    patterns: List[bytes] = field(default_factory=list)
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)
    params: Dict[str, object] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)

    @property
    def target(self) -> str:
        return TARGETS[self.index % len(TARGETS)]

    @property
    def k(self) -> int:
        """The case's number among its entry point's cases."""
        return self.index // len(TARGETS)

    @property
    def oracle(self) -> bool:
        return self.k % ORACLE_EVERY == 0

    @property
    def budget(self) -> Budget:
        return BUDGETS[self.device.type]

    def shape(self) -> str:
        parts = [f"{k}{list(a.shape)}" for k, a in self.arrays.items()]
        parts += [f"{k}={v}" for k, v in self.params.items()]
        return " ".join(parts + [f"patterns={len(self.patterns)}"])

    def digest(self) -> str:
        """A hash of everything the case feeds the kernel."""
        h = hashlib.sha256()
        for p in self.patterns:
            h.update(len(p).to_bytes(4, "little") + p)
        for k in sorted(self.arrays):
            a = np.ascontiguousarray(self.arrays[k])
            h.update(f"{k}{a.dtype}{a.shape}".encode() + a.tobytes())
        h.update(repr(sorted(self.params.items())).encode())
        return h.hexdigest()

    def tensor(self, name: str) -> torch.Tensor:
        """Input ``name`` on the case's device; on the card a view into a
        buffer whose :data:`GUARD_BYTES` before and after it hold poison
        (:meth:`poison`), so that a kernel reading past its input counts
        what it read there instead of the zeros or stale bytes that
        usually lie around a fresh tensor."""
        a = self.arrays[name]
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        a = np.ascontiguousarray(a)
        if self.device.type != "cuda":
            return torch.from_numpy(a).to(self.device)
        return guarded(a, self.poison(name, GUARD_BYTES // a.itemsize, a.dtype), self.device)

    def poison(self, name: str, count: int, dtype) -> np.ndarray:
        """What lies around an input on the card: the case's pattern bytes
        around payloads, lengths of 2^30 around lengths, all-wildcard
        table rows (mask 0, length 1) around tables, 0 around ``ms``."""
        if dtype == np.uint8:
            blob = b"".join(self.patterns) or b"\xff"
            return np.resize(np.frombuffer(blob, np.uint8), count)
        value = {"lengths": 2**30, "eff": 2**30, "lens": 1}.get(name.rstrip("0123456789"), 0)
        return np.full(count, value, dtype)

    def save(self, out: pathlib.Path) -> pathlib.Path:
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{self.target}-{self.seed}-{self.index}.npz"
        blob = b"".join(self.patterns)
        np.savez(path, patterns_blob=np.frombuffer(blob, np.uint8),
                 patterns_len=np.array([len(p) for p in self.patterns], np.int32),
                 **self.arrays, **{f"param_{k}": np.asarray(v) for k, v in self.params.items()})
        return path


def guarded(a: np.ndarray, poison: np.ndarray, device) -> torch.Tensor:
    """``a`` on ``device`` as a contiguous view into one buffer that holds
    ``poison`` right before and right after it."""
    g = poison.size
    flat = np.empty(a.size + 2 * g, a.dtype)
    flat[:g] = flat[-g:] = poison
    flat[g : g + a.size] = a.reshape(-1)
    return torch.from_numpy(flat).to(device)[g : g + a.size].view(a.shape)


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _launch_counters() -> Dict[str, int]:
    from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
    from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
    from multithreading_string_matching_tpu_torch.ops import mxu as mx
    from multithreading_string_matching_tpu_torch.ops import scan as sc

    return {k: v for d in (cw.LAUNCHES, ct.LAUNCHES, mx.LAUNCHES, sc.LAUNCHES)
            for k, v in d.items()}


def counted(case: Case, fn: Callable, expect: Dict[str, int]):
    """``fn()``, checking that it added exactly ``expect[key]`` launches to
    each listed counter on the card (none on the CPU)."""
    before = _launch_counters()
    out = fn()
    after = _launch_counters()
    for key, n in expect.items():
        want = n if case.device.type == "cuda" else 0
        if after[key] - before[key] != want:
            raise Divergence(f"{key}: {after[key] - before[key]} launches, expected {want}")
    return out


def same(what: str, got, want) -> None:
    """Raise :class:`Divergence` unless ``got`` equals ``want`` exactly
    (tensors, arrays or lists of integers)."""
    g = torch.as_tensor(np.asarray(got.cpu() if torch.is_tensor(got) else got)).long()
    w = torch.as_tensor(np.asarray(want.cpu() if torch.is_tensor(want) else want)).long()
    if g.numel() == 0 and w.numel() == 0:
        return
    if g.shape != w.shape:
        raise Divergence(f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    bad = (g != w).nonzero()
    if bad.numel():
        at = [tuple(i.tolist()) for i in bad[:4]]
        raise Divergence(f"{what}: {bad.shape[0]} entries differ, first at {at}: "
                         f"got {[g[i].item() for i in at]}, want {[w[i].item() for i in at]}")


def refused(case: Case, fn: Callable, what: str, *, card_only: bool = True) -> None:
    """``fn()`` must raise ``ValueError`` and launch nothing (on the CPU a
    ``card_only`` refusal is not checked: the plain versions validate
    less)."""
    if card_only and case.device.type != "cuda":
        return
    before = _launch_counters()
    try:
        fn()
    except ValueError:
        if _launch_counters() != before:
            raise Divergence(f"{what}: refused after launching") from None
        return
    raise Divergence(f"{what}: not refused")


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------


def _pick_len(rng, max_len: int = MAX_PATTERN_LEN) -> int:
    r = rng.random()
    if r < 0.55:
        return int(rng.integers(1, min(8, max_len) + 1))
    if r < 0.85 or max_len <= 32:
        return int(rng.integers(1, min(32, max_len) + 1))
    return int(rng.integers(33, max_len + 1))


def symbols(rng, nul: bool):
    """``(pattern symbols, payload symbols)``: mostly 2-5 symbols, so that
    matches overlap and probe keys collide; sometimes the full alphabet,
    NUL bytes inside payloads included.  Patterns get NUL only when
    ``nul``."""
    if rng.random() < 0.15:
        full = np.arange(256, dtype=np.uint8)
        return (full if nul else full[1:]), full
    sym = rng.choice(np.arange(1, 256), size=int(rng.integers(2, 6)), replace=False)
    sym = sym.astype(np.uint8)
    if nul:
        sym[0] = 0
        return sym, sym
    return sym, (np.append(sym, 0).astype(np.uint8) if rng.random() < 0.3 else sym)


def pattern_set(rng, sym, count: int, *, nul: bool, max_len: int = MAX_PATTERN_LEN
                ) -> List[bytes]:
    """``count`` patterns over ``sym`` of 1..``max_len`` bytes (word-count
    classes 1..25), sometimes sharing a prefix, sometimes with duplicates;
    with ``nul`` at least one holds a NUL and one ends in one."""
    prefix = b""
    if rng.random() < 0.3:
        prefix = bytes(rng.choice(sym, size=int(rng.integers(1, 13))).tolist())
    pats = []
    for _ in range(count):
        m = _pick_len(rng, max_len)
        p = bytes(rng.choice(sym, size=m).tolist())
        if prefix and rng.random() < 0.5:
            p = (prefix + p)[:m]
        pats.append(p)
    if nul:
        i = int(rng.integers(len(pats)))
        b = bytearray(pats[i])
        b[int(rng.integers(len(b)))] = 0
        pats[i] = bytes(b)
        j = int(rng.integers(len(pats)))
        pats[j] = pats[j][: max_len - 1] + b"\x00"
    if len(pats) > 1 and rng.random() < 0.3:
        pats += [pats[int(i)] for i in rng.integers(0, len(pats), size=int(rng.integers(1, 4)))]
    return pats


def tile_shape(rng, budget: Budget, small: bool, *, n_max: int = 256, l_max: int = 4096):
    """``(n, L)``: zero rows or width now and then, widths that are not a
    multiple of 4 or 16, a third of them over ``l_max / 4``, at most
    ``budget.positions`` positions (4,096 for an oracle case)."""
    cap = min(budget.positions, 4096 if small else budget.positions)
    r = rng.random()
    if r < 0.04:
        return 0, int(rng.integers(0, 64))
    if r < 0.08:
        return int(rng.integers(1, 8)), 0
    if rng.random() < 0.3:  # a third of the tiles wide
        L = int(rng.integers(l_max // 4, l_max + 1))
    else:
        L = int(np.exp(rng.uniform(0, np.log(l_max))))
    if rng.random() < 0.3:
        L = max(1, L - L % 16 + int(rng.choice([1, 3, 13, 15])))
    n = int(rng.integers(1, n_max + 1))
    while n > 1 and n * L > cap:
        n //= 2
    if n * L > cap:
        L = max(1, cap // n)
    return n, L


def lengths_for(rng, n: int, L: int, pats, payload, *, inside: bool) -> np.ndarray:
    """Row lengths: 0, 1, exactly a pattern's length (the pattern at column
    0), the full width and random ones; unless ``inside``, also below 0 and
    past the width."""
    out = rng.integers(0, L + 1, size=n).astype(np.int32)
    kind = rng.integers(0, 8, size=n)
    out[kind == 0] = 0
    out[kind == 1] = min(1, L)
    out[kind == 2] = L
    for r in np.flatnonzero(kind == 3):
        p = pats[int(rng.integers(len(pats)))] if pats else b""
        if 0 < len(p) <= L:
            payload[r, : len(p)] = np.frombuffer(p, np.uint8)
            out[r] = len(p)
    if not inside:
        out[kind == 4] = rng.integers(-8, 1, size=int((kind == 4).sum()))
        out[kind == 5] = L + rng.integers(1, 9, size=int((kind == 5).sum()))
    return out


def planted_tile(rng, n: int, L: int, pats, pay_sym, *, inside: bool, dirty: bool,
                 plants: Optional[int] = None, rows=None):
    """``(payload uint8[n, L], lengths int32[n])``: random bytes of
    ``pay_sym`` with patterns planted (in ``rows`` only, when given; some
    across the row's length), zero past each length unless ``dirty``."""
    payload = rng.choice(pay_sym, size=(n, L)).astype(np.uint8)
    rows = np.arange(n) if rows is None else np.asarray(rows)
    if plants is None:
        plants = int(rng.integers(0, min(3 * n, 4096) + 2))
    if rows.size and L and pats:
        for _ in range(plants):
            p = pats[int(rng.integers(len(pats)))]
            if len(p) <= L:
                r = int(rows[int(rng.integers(rows.size))])
                o = int(rng.integers(0, L - len(p) + 1))
                payload[r, o : o + len(p)] = np.frombuffer(p, np.uint8)
    lengths = lengths_for(rng, n, L, pats, payload, inside=inside)
    if not dirty:
        cols = np.arange(L)[None, :]
        payload[cols >= lengths[:, None]] = 0
    return payload, lengths


def texts_of(payload: np.ndarray, lengths: np.ndarray) -> List[bytes]:
    """Each row's first ``clamp(length, 0, L)`` bytes."""
    L = payload.shape[1]
    return [payload[r, : max(0, min(int(lengths[r]), L))].tobytes()
            for r in range(payload.shape[0])]


def _bucket_keys(case: Case, pay_sym, count: int) -> List[bytes]:
    """``count`` 4-byte patterns whose probe keys share one hash bucket of
    a launch over ``count`` patterns (the built library's
    ``msm_probe_bucket``, on the card); on the CPU the first ``count`` of
    the same candidates."""
    rng = case.rng
    cands = list(dict.fromkeys(bytes(rng.choice(pay_sym, size=4).tolist())
                               for _ in range(8 * count)))
    if case.device.type != "cuda":
        return cands[:count]
    from multithreading_string_matching_tpu_torch.ops.cuda_window import probe_bucket

    groups: Dict[int, List[bytes]] = {}
    for p in cands:
        groups.setdefault(probe_bucket(int.from_bytes(p, "little"), 0, count), []).append(p)
    best = max(groups.values(), key=len)
    case.notes["bucket"] = len(best)
    return best[:count]


def window_patterns(case: Case, *, nul: bool, variant: str):
    """``(patterns, payload symbols)`` of one window-family case:
    ``random``; ``rs`` (``b"rs%06d"``-shaped sets, up to 3,072 patterns
    on one probe key); ``one_key`` (patterns sharing their first 4 bytes);
    ``bucket`` (4-byte keys in one hash bucket)."""
    rng, b = case.rng, case.budget
    if variant == "rs":
        tag = bytes(rng.choice(np.arange(97, 123), size=2).tolist())
        count = int(rng.integers(64, b.patterns + 1))
        pats = [tag + b"%06d" % i for i in range(count)]
        return pats, np.frombuffer(tag + b"0123456789", np.uint8)
    sym, pay = symbols(rng, nul)
    if variant == "one_key":
        key = bytes(rng.choice(sym, size=4).tolist())
        count = int(rng.integers(16, min(512, b.patterns) + 1))
        pats = [key + bytes(rng.choice(sym, size=int(rng.integers(0, 29))).tolist())
                for _ in range(count)]
        return pats, pay
    if variant == "bucket":
        return _bucket_keys(case, pay, min(64, b.patterns)), pay
    count = int(rng.integers(1, 61)) if rng.random() < 0.85 else int(rng.integers(61, 400))
    return pattern_set(rng, sym, min(count, b.patterns), nul=nul), pay


def mask_tables(rng, pay_sym, U: int, K: int, masks_in_col0):
    """Hand-made ``(words, masks, lens)`` (uint32[U, K], uint32[U, K],
    int32[U]) whose column 0 holds the given probe masks (each used at
    least once) and full masks elsewhere, words drawn from ``pay_sym``."""
    masks = np.full((U, K), 0xFFFFFFFF, np.uint32)
    order = np.concatenate([np.arange(len(masks_in_col0)),
                            rng.integers(0, len(masks_in_col0), size=U - len(masks_in_col0))])
    masks[:, 0] = np.asarray(masks_in_col0, np.uint32)[order]
    raw = rng.choice(pay_sym, size=(U, 4 * K)).astype(np.uint8)
    words = raw.view("<u4").reshape(U, K) & masks
    lens = rng.integers(1, 4 * K + 1, size=U).astype(np.int32)
    return words.astype(np.uint32), masks, lens


def gen_window(case: Case, *, find: bool = False) -> None:
    """Patterns (or hand-made tables with eight probe masks) and a planted
    tile for the window kernels and ``window_find``."""
    rng, k = case.rng, case.k
    nul = k % 5 == 4
    variant = {1: "rs", 2: "one_key", 3: "bucket", 5: "masks8"}.get(k % 8, "random")
    if variant == "masks8" and case.oracle:
        variant = "random"
    small = case.oracle
    if variant == "masks8":
        _, pay = symbols(rng, False)
        U, K = int(rng.integers(8, 40)), int(rng.integers(1, 6))
        w, m, ln = mask_tables(rng, pay, U, K, EIGHT_MASKS)
        case.arrays.update(words=w, masks=m, lens=ln)
        n, L = tile_shape(rng, case.budget, False)
        pats = [bytes(w[u].view(np.uint8)[: ln[u]]) for u in range(U)]
        payload, lengths = planted_tile(rng, n, L, pats, pay, inside=False, dirty=True)
    else:
        pats, pay = window_patterns(case, nul=nul, variant=variant)
        case.patterns = pats
        if find and k % 4 == 2:
            payload, lengths = _sparse_find_tile(case, pats, pay)
        else:
            if find and k % 4 == 1:
                pay = pay[: 2]  # dense: every position may match
            n, L = tile_shape(rng, case.budget, small)
            payload, lengths = planted_tile(rng, n, L, pats, pay, inside=small,
                                            dirty=rng.random() < 0.5)
    case.params["variant"] = variant
    if case.target == "window_count_totals_repeated":
        case.params["reps"] = int(rng.integers(2, 9))
    case.arrays.update(payload=payload, lengths=lengths)


def _sparse_find_tile(case: Case, pats, pay):
    """A tile of several 16,384-position flattened tiles whose matches lie
    in every other one: hit-free tiles between hit tiles, for
    ``window_find``'s look-back."""
    rng = case.rng
    positions = 4 * FIND_TILE if case.oracle or case.device.type != "cuda" else \
        int(rng.integers(3 * FIND_TILE, case.budget.positions + 1))
    positions = min(positions, max(case.budget.positions, 2 * FIND_TILE))
    L = int(rng.integers(256 if case.oracle else 1, 2049))
    n = max(1, positions // L)
    used = np.unique(np.concatenate([np.frombuffer(p, np.uint8) for p in pats]))
    filler = np.setdiff1d(np.arange(1, 256, dtype=np.uint8), used)[:3]
    payload = rng.choice(filler if filler.size else pay, size=(n, L)).astype(np.uint8)
    hit_rows = np.flatnonzero(((np.arange(n) * L) // FIND_TILE) % 2 == 0)
    for _ in range(int(rng.integers(1, 64))):
        p = pats[int(rng.integers(len(pats)))]
        if len(p) <= L:
            r = int(hit_rows[int(rng.integers(hit_rows.size))])
            o = int(rng.integers(0, L - len(p) + 1))
            payload[r, o : o + len(p)] = np.frombuffer(p, np.uint8)
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    lengths[rng.random(n) < 0.5] = L
    return payload, lengths


def window_tables(case: Case):
    """``(words, masks, lens)`` int32 tensors on the case's device and the
    unique patterns (None for hand-made tables)."""
    from multithreading_string_matching_tpu_torch.ops.window import WindowProgram

    if "words" in case.arrays:
        return (case.tensor("words"), case.tensor("masks"), case.tensor("lens")), None
    wp = WindowProgram.build(case.patterns)
    return wp.tables(case.device), list(wp.unique_patterns)


def nine_mask_tables(case: Case, K: int):
    rng = np.random.default_rng([case.seed, case.index, 9])
    w, m, ln = mask_tables(rng, np.arange(1, 256, dtype=np.uint8), 12, K,
                           EIGHT_MASKS + (NINTH_MASK,))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(case.device)
    return t(w), t(m), t(ln)


# ---------------------------------------------------------------------------
# Runners: one per entry point
# ---------------------------------------------------------------------------


def _tile(case: Case):
    return case.tensor("payload"), case.tensor("lengths")


def _launches(p, U: int) -> int:
    return int(p.shape[0] > 0 and p.shape[1] > 0 and U > 0)


def run_window(case: Case) -> int:
    from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
    from multithreading_string_matching_tpu_torch.ops.window import window_count

    (words, masks, lens), uniq = window_tables(case)
    p, ln = _tile(case)
    U = words.shape[0]
    target = case.target
    if target == "window_count_rows":
        got = counted(case, lambda: cw.window_count_rows(p, ln, words, masks, lens),
                      {"window_count_rows": _launches(p, U)})
        same("kernel vs plain", got, window_count(words, masks, lens, p, ln, per_packet=True))
    else:
        reps = case.params.get("reps", 1)
        key = "window_count_totals" if reps == 1 else "window_count_totals_repeated"
        got = counted(case, lambda: cw.window_count_totals(p, ln, words, masks, lens, reps),
                      {key: _launches(p, U)})
        same("kernel vs plain", got, reps * window_count(words, masks, lens, p, ln))
    if case.params["variant"] == "masks8":
        refused(case, lambda: cw.window_count_totals(p, ln, *nine_mask_tables(case, 2)),
                "nine probe masks")
    if target == "window_count_totals_repeated" and p.numel():
        n, L = p.shape
        over = -(-(2**31) // (n * L))
        if over <= 65535:
            refused(case, lambda: cw.window_count_totals(p, ln, words, masks, lens, over),
                    f"reps={over} over {n} x {L}")
        refused(case, lambda: cw.window_count_totals(p, ln, words, masks, lens, 65536),
                "reps=65536")
    if case.oracle and uniq is not None:
        texts = texts_of(case.arrays["payload"], case.arrays["lengths"])
        if target == "window_count_rows":
            same("kernel vs oracle", got, oracle.oracle_matrix(texts, uniq))
        else:
            same("kernel vs oracle", got, [reps * c for c in oracle.oracle_counts(texts, uniq)])
        return 1
    return 0


def gen_halo(case: Case) -> None:
    """A flow-round tile ``[halo | bytes]`` with matches planted across the
    halo boundary, random ``eff``, ``ms`` and ``min_end``."""
    rng = case.rng
    nul = case.k % 5 == 4
    sym, pay = symbols(rng, nul)
    pats = pattern_set(rng, sym, int(rng.integers(1, 40)), nul=nul)
    case.patterns = pats
    n, C = tile_shape(rng, case.budget, case.oracle)
    H = int(rng.integers(0, min(C, MAX_PATTERN_LEN) + 1)) if C else 0
    W = C
    x = rng.choice(pay, size=(n, W)).astype(np.uint8)
    for _ in range(int(rng.integers(0, 3 * n + 2)) if W and n else 0):
        p = pats[int(rng.integers(len(pats)))]
        if len(p) <= W:
            lo, hi = max(0, H - len(p) + 1), min(H, W - len(p))
            o = int(rng.integers(lo, hi + 1)) if lo <= hi and rng.random() < 0.7 else \
                int(rng.integers(0, W - len(p) + 1))
            x[int(rng.integers(n)), o : o + len(p)] = np.frombuffer(p, np.uint8)
    eff = rng.integers(0, W + 1, size=n).astype(np.int32)
    eff[rng.random(n) < 0.3] = W
    ms = rng.integers(0, H + 1, size=n).astype(np.int32)
    wide = rng.random(n) < 0.1
    ms[wide] = rng.integers(0, W + 1, size=int(wide.sum()))
    case.arrays.update(x=x, eff=eff, ms=ms)
    case.params["min_end"] = int(rng.integers(0, W + 1)) if rng.random() < 0.2 else H


def run_halo(case: Case) -> int:
    from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
    from multithreading_string_matching_tpu_torch.ops.window import window_count_halo_plain

    (words, masks, lens), uniq = window_tables(case)
    x, eff, ms = case.tensor("x"), case.tensor("eff"), case.tensor("ms")
    H = case.params["min_end"]
    got = counted(case, lambda: cw.window_count_halo(x, eff, ms, words, masks, lens, H),
                  {"window_count_halo": _launches(x, words.shape[0])})
    same("kernel vs plain", got, window_count_halo_plain(x, eff, ms, H, (words, masks, lens)))
    if not case.oracle:
        return 0
    xa, ea, ma = case.arrays["x"], case.arrays["eff"], case.arrays["ms"]
    want = [0] * len(uniq)
    for r in range(xa.shape[0]):
        t = xa[r, : int(ea[r])].tobytes()
        for u, pat in enumerate(uniq):
            want[u] += sum(1 for i in oracle.starts(t, pat) if i >= ma[r] and i + len(pat) > H)
    same("kernel vs oracle", got, want)
    return 1


def gen_table(case: Case) -> None:
    """A set for the table and filter kernels: random (several word-count
    classes), ``rs``-shaped, a shared prefix, filter words present in the
    payload without their patterns, or hand-made tables with eight probe
    masks in the probe column."""
    rng, k = case.rng, case.k
    nul = k % 5 == 4
    variant = {1: "rs", 2: "one_key", 3: "absent", 5: "masks8"}.get(k % 8, "random")
    if variant == "masks8" and case.oracle:
        variant = "random"
    case.params["variant"] = variant
    if case.target == "table_filter_count_totals":
        case.params["reps"] = int(rng.choice([1, 1, 3]))
    if variant == "masks8":
        _, pay = symbols(rng, False)
        U, K = int(rng.integers(8, 40)), int(rng.integers(1, 9))
        w, m, ln = mask_tables(rng, pay, U, K, EIGHT_MASKS)
        case.arrays.update(words=w, masks=m, lens=ln)
        pats = [bytes(w[u].view(np.uint8)) for u in range(U)]
        n, L = tile_shape(rng, case.budget, False)
        payload, lengths = planted_tile(rng, n, L, pats, pay, inside=False, dirty=True)
    elif variant == "absent":
        sym, pay = symbols(rng, False)
        pats = pattern_set(rng, sym, int(rng.integers(2, 40)), nul=False)
        case.patterns = pats
        # each pattern's words planted one by one, the whole pattern never
        pieces = [p[j : j + 4] for p in pats for j in range(0, len(p) - 3, 4)] or \
            [p[:-1] for p in pats if len(p) > 1] or [b"\x01"]
        n, L = tile_shape(rng, case.budget, case.oracle)
        payload, lengths = planted_tile(rng, n, L, pieces, pay, inside=case.oracle,
                                        dirty=rng.random() < 0.5)
    else:
        pats, pay = window_patterns(case, nul=nul, variant=variant)
        case.patterns = pats
        n, L = tile_shape(rng, case.budget, case.oracle)
        payload, lengths = planted_tile(rng, n, L, pats, pay, inside=case.oracle,
                                        dirty=rng.random() < 0.5)
    case.arrays.update(payload=payload, lengths=lengths)


def run_table(case: Case) -> int:
    from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
    from multithreading_string_matching_tpu_torch.ops.table import (
        filter_count,
        partition,
        table_count,
    )
    from multithreading_string_matching_tpu_torch.ops.window import WindowProgram

    rows = case.target == "table_filter_count_rows"
    p, ln = _tile(case)
    has_tile = int(p.shape[0] > 0 and p.shape[1] > 0)
    reps = case.params.get("reps", 1)
    built = {}
    for form, plain in (("table", table_count), ("filter", filter_count)):
        name = f"{form}_count_{'rows' if rows else 'totals'}"
        kernel = getattr(ct, name)
        key = name if reps == 1 else f"{name}_repeated"
        if "words" in case.arrays:  # hand-made: one class, K = width
            w, m, l = case.tensor("words"), case.tensor("masks"), case.tensor("lens")
            K = w.shape[1]
            if form == "filter":
                w, m = torch.cat([w, w[:, :1]], 1).contiguous(), torch.cat([m, m[:, :1]], 1).contiguous()
            classes, inv = [(K, (w, m, l))], None
        else:
            wp = WindowProgram.build(case.patterns)
            cls, inv, _ = partition(wp, form == "filter")
            classes = [(c.K, c.tables(case.device)) for c in cls]
        outs = []
        for K, tabs in classes:
            args = (p, ln, *tabs, K) if rows else (p, ln, *tabs, K, reps)
            got = counted(case, lambda: kernel(*args), {key: has_tile})
            want = plain(*tabs, p, ln, K, per_row=rows) * reps
            same(f"{form} K={K}: kernel vs plain", got, want)
            outs.append(got)
        built[form] = torch.cat(outs, dim=-1) if inv is None else torch.cat(outs, dim=-1)[..., inv]
        if case.params["variant"] == "masks8":
            nine = nine_mask_tables(case, 3)
            if form == "filter":
                nine = (torch.cat([nine[0], nine[0][:, :1]], 1).contiguous(),
                        torch.cat([nine[1], nine[1][:, :1]], 1).contiguous(), nine[2])
            refused(case, lambda: kernel(p, ln, *nine, 3), f"{form}: nine probe masks")
    same("table vs filter", built["table"], built["filter"])
    if case.oracle and "words" not in case.arrays:
        uniq = list(WindowProgram.build(case.patterns).unique_patterns)
        texts = texts_of(case.arrays["payload"], case.arrays["lengths"])
        want = oracle.oracle_matrix(texts, uniq) if rows else \
            [reps * c for c in oracle.oracle_counts(texts, uniq)]
        same("kernels vs oracle", built["table"], want)
        return 1
    return 0


def gen_shard(case: Case) -> None:
    """A set cut into shards at random: a random order of its unique
    patterns, a random shard count, table or filter form."""
    rng = case.rng
    gen_table(case)
    if case.params["variant"] == "masks8":
        for name in ("words", "masks", "lens"):
            del case.arrays[name]
        sym, _ = symbols(rng, False)
        case.patterns = pattern_set(rng, sym, int(rng.integers(1, 60)), nul=False)
        case.params["variant"] = "random"
    U = len(dict.fromkeys(case.patterns))
    case.arrays["order"] = rng.permutation(U).astype(np.int64)
    case.params["shards"] = int(rng.integers(1, 9))
    case.params["filtered"] = bool(rng.random() < 0.5)


def run_shard(case: Case) -> int:
    from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
    from multithreading_string_matching_tpu_torch.ops.table import filter_count, table_count
    from multithreading_string_matching_tpu_torch.ops.window import WindowProgram
    from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
        build_pattern_shards,
    )

    rows = case.target == "shard_table_kernel_rows"
    filtered = case.params["filtered"]
    p, ln = _tile(case)
    wp = WindowProgram.build(case.patterns)
    order = case.arrays["order"]
    shuffled = WindowProgram.build([wp.unique_patterns[i] for i in order])
    plan = build_pattern_shards(shuffled, case.params["shards"], filtered=filtered)
    kernel = ct.ShardTableKernel(plan.K, plan.S, plan.use_fit, filtered, case.device)
    plain = filter_count if filtered else table_count
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(case.device)
    key = f"shard_{'filter' if filtered else 'table'}_count_{'rows' if rows else 'totals'}"
    has_tile = int(p.shape[0] > 0 and p.shape[1] > 0)
    parts = []
    for d in range(plan.n_shards):
        blk = slice(d * plan.S, (d + 1) * plan.S)
        w, m, l = t(plan.words[blk]), t(plan.masks[blk]), t(plan.lens[blk])
        fn = kernel.rows if rows else kernel.counts
        got = counted(case, lambda: fn(w, m, l, p, ln), {key: has_tile})
        same(f"shard {d}: kernel vs plain", got,
             plain(w, m, l.reshape(-1), p, ln, plan.K, per_row=rows))
        parts.append(got.cpu().numpy())
    gathered = plan.gather(np.concatenate(parts, axis=-1))
    merged = np.zeros_like(gathered)
    merged[..., order] = gathered
    whole = ct.CudaTableMatcher(wp, case.device, filtered=filtered)
    tiles = [(p, ln)]
    want = (whole.count_tiles_per_row(tiles, expand_duplicates=False)[0] if rows
            else whole.count_tiles(tiles, expand_duplicates=False))
    same("merged shards vs unsharded class kernels", merged, want)
    if case.oracle:
        texts = texts_of(case.arrays["payload"], case.arrays["lengths"])
        uniq = list(wp.unique_patterns)
        same("merged shards vs oracle", merged,
             oracle.oracle_matrix(texts, uniq) if rows else oracle.oracle_counts(texts, uniq))
        return 1
    return 0


def gen_mxu(case: Case) -> None:
    """A NUL-free set of patterns of at most 99 bytes inside ``mxu_count``'s
    contract, on rows zero past their lengths: sets that select wgmma
    width N = 96 (81-96 short patterns) and N = 256 (241-256), sets with
    patterns over 16 bytes (the generic kernel), and random ones."""
    rng, k = case.rng, case.k
    sym, pay = symbols(rng, False)
    variant = ("n96", "n256", "generic", "random")[k % 4]
    if variant == "n96":
        pats = pattern_set(rng, sym, int(rng.integers(81, 97)), nul=False, max_len=16)
    elif variant == "n256" and case.budget.patterns >= 256:
        pats = pattern_set(rng, sym, int(rng.integers(241, 257)), nul=False, max_len=8)
    elif variant == "generic":
        pats = pattern_set(rng, sym, int(rng.integers(1, 40)), nul=False)
        pats.append(bytes(rng.choice(sym, size=int(rng.integers(17, 100))).tolist()))
    else:
        variant = "random"
        pats = pattern_set(rng, sym, int(rng.integers(1, 128)), nul=False)
    case.patterns = pats
    case.params.update(variant=variant, reps=int(rng.choice([1, 1, 3])),
                       live=bool(rng.random() < 0.8))
    n, L = tile_shape(rng, case.budget, case.oracle)
    payload, lengths = planted_tile(rng, n, L, pats, pay, inside=True, dirty=False)
    case.arrays.update(payload=payload, lengths=lengths)


def run_mxu(case: Case) -> int:
    from multithreading_string_matching_tpu_torch.ops import mxu as mx

    P_np, tgt_np, m_max = mx.bit_tables(case.patterns)
    P = torch.from_numpy(P_np).to(case.device)
    tgt = torch.from_numpy(tgt_np.reshape(-1)).to(case.device)
    p, _ = _tile(case)
    U, reps = len(case.patterns), case.params["reps"]
    live = U if case.params["live"] else None
    key = "mxu_count" if reps == 1 else "mxu_count_repeated"
    got = counted(case, lambda: mx.mxu_count(p, P, tgt, reps, live=live),
                  {key: int(p.shape[0] > 0 and p.shape[1] > 0)})
    same("kernel vs plain", got, mx.mxu_count_plain(P, tgt, m_max, p) * reps)
    if case.device.type == "cuda":
        C = -(-P_np.shape[1] // mx.K_STEP) * mx.K_STEP
        case.notes["width"] = mx.tile_shape(live or P_np.shape[0], C)[0]
    if case.oracle:
        texts = texts_of(case.arrays["payload"], case.arrays["lengths"])
        want = [reps * c for c in oracle.oracle_counts(texts, case.patterns)]
        same("kernel vs oracle", got, want + [0] * (got.shape[0] - U))
        return 1
    return 0


def gen_find(case: Case) -> None:
    gen_window(case, find=True)
    case.params["forced_cap"] = bool(case.k % 2 == 1)
    case.params["cap_fraction"] = float(case.rng.random())


def run_find(case: Case) -> int:
    from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
    from multithreading_string_matching_tpu_torch.ops.window import window_find_plain

    (words, masks, lens), uniq = window_tables(case)
    p, ln = _tile(case)
    U = words.shape[0]
    want = window_find_plain(words, masks, lens, p, ln)
    M, n = want.shape[0], p.shape[0]
    launches = _launches(p, U)
    got = counted(case, lambda: cw.window_find(p, ln, words, masks, lens),
                  {"window_find": launches, "window_find_rerun": launches * int(M > n)})
    same("triples: kernel vs plain", got, want)
    if case.params["forced_cap"] and M:
        cap = int(case.params["cap_fraction"] * M)
        got = counted(case, lambda: cw.window_find(p, ln, words, masks, lens, cap=cap),
                      {"window_find": launches, "window_find_rerun": launches})
        same(f"triples at cap={cap}: kernel vs plain", got, want)
        case.notes["rerun"] = 1
    if case.params["variant"] == "masks8":
        refused(case, lambda: cw.window_find(p, ln, *nine_mask_tables(case, 2)),
                "nine probe masks")
    if case.oracle and uniq is not None:
        texts = texts_of(case.arrays["payload"], case.arrays["lengths"])
        same("triples: kernel vs oracle", got, oracle.match_positions(texts, uniq))
        return 1
    return 0


def _scan_tiles(case: Case, pats, pay, *, narrow: bool = False):
    """1-3 tiles (three in every third case) for a DFA scan, lengths from
    -8 to past the width (the scans clamp them)."""
    rng = case.rng
    count = 3 if case.k % 3 == 0 else int(rng.integers(1, 3))
    for i in range(count):
        if narrow:
            L = int(rng.integers(1, 17))
            n = int(rng.integers(1, 65)) if case.oracle else \
                int(rng.integers(8192, max(8193, min(1 << 17, case.budget.positions // L))))
        else:
            n, L = tile_shape(rng, case.budget, case.oracle, l_max=2048)
        payload, lengths = planted_tile(rng, n, L, pats, pay, inside=False,
                                        dirty=rng.random() < 0.5)
        case.arrays[f"payload{i}"] = payload
        case.arrays[f"lengths{i}"] = lengths
    case.params["tiles"] = count


def _tiles_of(case: Case):
    return [(case.tensor(f"payload{i}"), case.tensor(f"lengths{i}"))
            for i in range(case.params["tiles"])]


def gen_ac(case: Case) -> None:
    """An automaton (random patterns; every 32nd case one of more than
    2^15 or 2^16 states on the card; every 6th with an extra state the
    root does not reach, so its depth is None), a list of tiles, small
    segments in half the cases, and start states: the root, random ones in
    ``[0, dead]``, or (oracle cases) the states after random histories."""
    rng, k = case.rng, case.k
    nul = k % 5 == 4
    sym, pay = symbols(rng, nul)
    big = case.budget.big_automata and k % 32 in (13, 29)
    if big:
        count = 360 if k % 32 == 13 else 700
        full = np.arange(1, 256)
        pats = [bytes(rng.choice(full, size=MAX_PATTERN_LEN).tolist()) for _ in range(count)]
        pay = np.arange(256, dtype=np.uint8)
    else:
        pats = pattern_set(rng, sym, int(rng.integers(1, 60)), nul=nul)
    case.patterns = pats
    case.params["unreached"] = bool(k % 6 == 1 and not big)
    case.params["seg_bytes"] = int(rng.integers(1, 81)) if rng.random() < 0.5 else 0
    case.params["per_packet"] = bool(rng.random() < 0.5)
    _scan_tiles(case, pats, pay)
    starts = "history" if case.oracle else ("root", "random")[int(rng.integers(2))]
    case.params["starts"] = starts
    for i in range(case.params["tiles"]):
        n = case.arrays[f"payload{i}"].shape[0]
        if starts == "history":
            lens = rng.integers(0, 121, size=n)
            hist = np.zeros((n, 120), np.uint8)
            for r in range(n):
                hist[r, : lens[r]] = rng.choice(pay, size=int(lens[r]))
                if pats and rng.random() < 0.3:  # end inside a pattern
                    p = pats[int(rng.integers(len(pats)))]
                    tail = np.frombuffer(p[: int(rng.integers(0, len(p)))], np.uint8)
                    m = min(tail.size, int(lens[r]))
                    if m:
                        hist[r, lens[r] - m : lens[r]] = tail[tail.size - m :]
            case.arrays[f"history{i}"] = hist
            case.arrays[f"history_len{i}"] = lens.astype(np.int32)
        elif starts == "random":
            case.arrays[f"states_draw{i}"] = rng.random(n)


def compiled_ac(case: Case):
    """``(CompiledAC, AhoCorasick)``; with ``unreached`` the table gains a
    state that the root does not reach (random row, random emits)."""
    from multithreading_string_matching_tpu_torch.models.aho_corasick import AhoCorasick
    from multithreading_string_matching_tpu_torch.ops.scan import CompiledAC

    ac = AhoCorasick.build(case.patterns)
    if not case.params["unreached"]:
        return CompiledAC.from_automaton(ac, case.device), ac
    rng = np.random.default_rng([case.seed, case.index, 1])
    S = ac.dead_state
    goto = np.empty((S + 2, 256), np.int32)
    goto[:S] = ac.goto[:S]
    goto[S] = rng.integers(0, S + 1, size=256)  # live states and itself
    goto[S + 1] = S + 1
    emit = np.zeros((S + 2, ac.emit.shape[1]), np.int32)
    emit[:S] = ac.emit[:S]
    emit[S] = rng.random(ac.emit.shape[1]) < 0.5
    return CompiledAC.from_numpy(goto, emit, ac.dup_map, device=case.device), ac


def _walk(goto: np.ndarray, s: int, data: bytes) -> int:
    for c in data:
        s = int(goto[s, c])
    return s


def run_ac(case: Case) -> int:
    from multithreading_string_matching_tpu_torch.ops import scan as sc

    cac, ac = compiled_ac(case)
    tiles = _tiles_of(case)
    pp = case.params["per_packet"]
    seg = case.params["seg_bytes"] or None
    starts = case.params["starts"]
    states = None
    if starts == "random":
        states = [torch.from_numpy((case.arrays[f"states_draw{i}"] * (cac.dead + 1))
                                   .astype(np.int32)).to(case.device)
                  for i in range(len(tiles))]
    elif starts == "history":
        states = [torch.tensor([_walk(ac.goto, 0, h[: int(n)].tobytes())
                                for h, n in zip(case.arrays[f"history{i}"],
                                                case.arrays[f"history_len{i}"])],
                               dtype=torch.int32, device=case.device)
                  for i in range(len(tiles))]
    work = sum(p.shape[0] for p, _ in tiles)
    single = len(tiles) == 1 and states is not None
    if single:
        got, new = counted(case, lambda: sc.ac_scan(cac, *tiles[0], states[0], per_packet=pp,
                                                    seg_bytes=seg), {"ac_scan": int(work > 0)})
        new = [new]
    else:
        out = counted(case, lambda: sc.ac_scan_tiles(cac, tiles, per_packet=pp, states=states,
                                                     seg_bytes=seg), {"ac_scan": int(work > 0)})
        got, new = out if states is not None else (out, None)
    outs, news = [], []
    for i, (p, l) in enumerate(tiles):
        st = states[i] if states is not None else torch.zeros(p.shape[0], dtype=torch.int32,
                                                              device=case.device)
        c, s = sc.ac_scan_plain(cac, p, l, st, per_packet=pp)
        outs.append(c)
        news.append(s)
    same("counts: kernel vs plain", got, torch.cat(outs) if pp else sum(outs))
    if new is not None:
        for i, (a, b) in enumerate(zip(new, news)):
            same(f"states of tile {i}: kernel vs plain", a, b)
    if case.k % 4 == 2 and tiles:
        p, l = tiles[0]
        bad = torch.full((p.shape[0],), cac.dead + 1 + case.k % 7, dtype=torch.int32,
                         device=case.device)
        if p.shape[0]:
            bad[0] = -1 - case.k % 5
            refused(case, lambda: sc.ac_scan_tiles(cac, [(p, l)], states=[bad]),
                    "start states outside [0, dead]", card_only=False)
    if case.k % 8 == 7:
        refused(case, lambda: sc.split_tiles([(1 << 16, 1 << 15)]), "2^31 positions",
                card_only=False)
    if not case.oracle:
        return 0
    uniq = list(ac.unique_patterns)
    want = [] if pp else [0] * len(uniq)
    for i in range(len(tiles)):
        pay, lens = case.arrays[f"payload{i}"], case.arrays[f"lengths{i}"]
        hist, hlen = case.arrays.get(f"history{i}"), case.arrays.get(f"history_len{i}")
        ends = []
        for r, t in enumerate(texts_of(pay, lens)):
            h = hist[r, : int(hlen[r])].tobytes() if hist is not None else b""
            row = [sum(1 for s in oracle.starts(h + t, u) if s + len(u) > len(h)) for u in uniq]
            if pp:
                want.append(row)
            else:
                want = [a + b for a, b in zip(want, row)]
            ends.append(_walk(ac.goto, 0, h + t))
        if new is not None:
            same(f"tile {i}: end states vs the automaton's walk", new[i], ends)
    same("counts: kernel vs oracle", got, want if want else np.zeros((0, len(uniq))))
    return 1


def gen_kmp(case: Case) -> None:
    """1, 27-33, 64 or 2-64 patterns (duplicates kept: KMP counts the full
    list), tiles of 8,192 to 131,072 narrow rows in every other case on the
    card, so that a launch runs groups of several patterns, up to 32
    (``kmp_groups``)."""
    rng, k = case.rng, case.k
    nul = k % 5 == 4
    sym, pay = symbols(rng, nul)
    count = (1, int(rng.integers(27, 34)), 64, int(rng.integers(2, 65)))[k % 4]
    narrow = k % 2 == 1 and case.budget.big_automata
    # Short patterns in half the narrow cases: a group's staged DFAs fit
    # 32 slots only when they have few states.
    max_len = 12 if narrow and rng.random() < 0.5 else MAX_PATTERN_LEN
    pats = pattern_set(rng, sym, count, nul=nul, max_len=max_len)[:count]
    if count > 2 and rng.random() < 0.3:
        pats[-1] = pats[0]
    case.patterns = pats
    case.params["per_packet"] = bool(rng.random() < 0.5)
    _scan_tiles(case, pats, pay, narrow=narrow)


def run_kmp(case: Case) -> int:
    from multithreading_string_matching_tpu_torch.models.kmp import stack_kmp_dfas
    from multithreading_string_matching_tpu_torch.ops import scan as sc

    kmp = sc.CompiledKMP.from_numpy(*stack_kmp_dfas(case.patterns), device=case.device)
    tiles = _tiles_of(case)
    pp = case.params["per_packet"]
    rows = sum(p.shape[0] for p, _ in tiles)
    got = counted(case, lambda: sc.kmp_scan_tiles(kmp, tiles, per_packet=pp)
                  if len(tiles) > 1 else sc.kmp_scan(kmp, *tiles[0], per_packet=pp),
                  {"kmp_scan": int(rows > 0)})
    outs = [sc.kmp_scan_plain(kmp, p, l, per_packet=pp) for p, l in tiles]
    same("kernel vs plain", got, torch.cat(outs) if pp else sum(outs))
    if rows and kmp.table.element_size() == 1:
        case.notes["slots"] = sc.kmp_groups(kmp.accept_host[kmp.order_host], rows)[1]
    if not case.oracle:
        return 0
    texts = [t for i in range(len(tiles))
             for t in texts_of(case.arrays[f"payload{i}"], case.arrays[f"lengths{i}"])]
    same("kernel vs oracle", got, oracle.oracle_matrix(texts, case.patterns) if pp
         else oracle.oracle_counts(texts, case.patterns))
    return 1


GENERATORS: Dict[str, Callable[[Case], None]] = {
    "window_count_totals": gen_window, "window_count_rows": gen_window,
    "window_count_totals_repeated": gen_window, "window_count_halo": gen_halo,
    "table_filter_count_totals": gen_table, "table_filter_count_rows": gen_table,
    "shard_table_kernel_counts": gen_shard, "shard_table_kernel_rows": gen_shard,
    "mxu_count": gen_mxu, "window_find": gen_find, "ac_scan": gen_ac, "kmp_scan": gen_kmp,
}
RUNNERS: Dict[str, Callable[[Case], int]] = {
    "window_count_totals": run_window, "window_count_rows": run_window,
    "window_count_totals_repeated": run_window, "window_count_halo": run_halo,
    "table_filter_count_totals": run_table, "table_filter_count_rows": run_table,
    "shard_table_kernel_counts": run_shard, "shard_table_kernel_rows": run_shard,
    "mxu_count": run_mxu, "window_find": run_find, "ac_scan": run_ac, "kmp_scan": run_kmp,
}


# ---------------------------------------------------------------------------
# The soak loop
# ---------------------------------------------------------------------------


def make_case(seed: int, index: int, device) -> Case:
    """Case ``index`` of ``seed``: its inputs drawn, nothing run."""
    case = Case(seed, index, torch.device(device), np.random.default_rng([seed, index]))
    GENERATORS[case.target](case)
    return case


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' but CUDA is not available; pass --device cpu to "
                           "soak the harness against the plain versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def run_case(seed: int, index: int, device, out: pathlib.Path, log=print) -> Case:
    """Draw and run one case.  On any failure print a reproducer, write the
    inputs to ``out`` and re-raise."""
    case = Case(seed, index, torch.device(device), np.random.default_rng([seed, index]))
    try:
        GENERATORS[case.target](case)
        case.notes["oracle"] = RUNNERS[case.target](case)
    except Exception as exc:
        path = case.save(out)
        log(f"DIVERGENCE in {case.target}: {type(exc).__name__}: {exc}\n"
            f"  seed={seed} case={index} device={case.device} oracle={case.oracle}\n"
            f"  shape: {case.shape()}\n"
            f"  patterns (hex): {[p.hex() for p in case.patterns]}\n"
            f"  inputs: {path}\n"
            f"  again: python -m multithreading_string_matching_tpu_torch.tools.differential "
            f"--seed {seed} --case {index} --device {case.device.type}")
        raise
    return case


def parse_targets(spec: Optional[str]) -> tuple:
    """The entry points a comma-separated ``spec`` names (all for ``None``
    or an empty one), in :data:`TARGETS` order; raises on an unknown name."""
    if not spec:
        return TARGETS
    names = {t.strip() for t in spec.split(",") if t.strip()}
    unknown = names - set(TARGETS)
    if unknown:
        raise ValueError(f"unknown entry points {sorted(unknown)}; choose from {TARGETS}")
    return tuple(t for t in TARGETS if t in names)


def soak(seed: int, cases: int = DEFAULT_CASES, seconds: float = 0.0, device="cuda",
         out="soak_out", log=print, targets=TARGETS) -> Dict[str, dict]:
    """At least ``cases`` cases per entry point of ``targets``, then whole
    rounds until ``seconds`` have passed (case ``I`` is still
    ``TARGETS[I % 12]``'s: the indices of other entry points are skipped).
    Returns ``{target: {"cases", "oracle", "seconds", ...notes}}``; raises on
    the first divergence."""
    device = check_device(device)
    out = pathlib.Path(out)
    stats = {t: {"cases": 0, "oracle": 0, "seconds": 0.0} for t in targets}
    seen: Dict[str, set] = {"width": set(), "slots": set(), "rerun": set(), "bucket": set()}
    t0 = time.perf_counter()
    index = 0
    while index < cases * len(TARGETS) or (
            index % len(TARGETS) or time.perf_counter() - t0 < seconds):
        if TARGETS[index % len(TARGETS)] not in stats:
            index += 1
            continue
        t1 = time.perf_counter()
        case = run_case(seed, index, device, out, log)
        st = stats[case.target]
        st["cases"] += 1
        st["oracle"] += case.notes["oracle"]
        st["seconds"] += time.perf_counter() - t1
        for k in seen:
            if k in case.notes:
                seen[k].add(case.notes[k])
        index += 1
    edges = []
    if "mxu_count" in stats:
        stats["mxu_count"]["widths"] = sorted(seen["width"])
        edges += [("mxu_count at wgmma width 96", 96 in seen["width"]),
                  ("mxu_count at wgmma width 256", 256 in seen["width"])]
    if "kmp_scan" in stats:
        stats["kmp_scan"]["slots"] = sorted(seen["slots"])
        edges.append(("KMP groups of 16 or more patterns", max(seen["slots"], default=0) >= 16))
    if "window_find" in stats:
        stats["window_find"]["reruns_forced"] = bool(seen["rerun"])
        edges.append(("a window_find rerun", bool(seen["rerun"])))
    if device.type == "cuda" and cases >= COVERAGE_CASES:
        for what, ok in edges:
            if not ok:
                raise Divergence(f"the generators never reached {what}")
    return stats


def summary_lines(stats: Dict[str, dict], seed: int, device, card: str) -> List[str]:
    lines = []
    for t in stats:
        st = stats[t]
        extra = {k: v for k, v in st.items() if k not in ("cases", "oracle", "seconds")}
        lines.append(f"differential {t:<29} cases {st['cases']:4d}  oracle {st['oracle']:4d}  "
                     f"{st['seconds']:9.3f} s{'  ' + str(extra) if extra else ''}  [{card}]")
    total = sum(st["cases"] for st in stats.values())
    lines.append(f"differential clean: {total} cases, 0 divergences, seed={seed}, "
                 f"device={device} [{card}]")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", type=int, default=DEFAULT_CASES,
                    help="least cases per entry point")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="go on rolling whole rounds until this many seconds have passed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--case", type=int, default=None, help="run this one case only")
    ap.add_argument("--out", default="soak_out", help="where a divergent case's inputs go")
    ap.add_argument("--targets", default=None,
                    help="comma-separated entry points to soak (default: all 12)")
    ap.add_argument("--edges", action="store_true",
                    help="run the cases at the 2^31 position limit (tools/edges.py) instead")
    ap.add_argument("--edge-limit", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    targets = parse_targets(args.targets)
    if device.type == "cuda":
        from multithreading_string_matching_tpu_torch.utils.timing import card_line

        card = card_line()
    else:
        card = "cpu: plain versions only"
    if args.edges:
        from multithreading_string_matching_tpu_torch.tools import edges

        t0 = time.perf_counter()
        records = edges.run_edges(device, args.edge_limit or edges.LIMIT,
                                  log=lambda line: print(f"{line} [{card}]", flush=True))
        cases = sum(1 for r in records if "result" in r)
        print(f"edges clean: {cases} cases, {time.perf_counter() - t0:.3f} s [{card}]")
        return 0
    if args.case is not None:
        case = run_case(args.seed, args.case, device, pathlib.Path(args.out))
        print(f"case {args.case} ({case.target}, {case.shape()}): clean [{card}]")
        return 0
    stats = soak(args.seed, args.cases, args.seconds, device, args.out, targets=targets)
    for line in summary_lines(stats, args.seed, device.type, card):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
