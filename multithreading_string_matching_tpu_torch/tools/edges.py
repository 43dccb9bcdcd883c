"""Cases at the int32 position limit, with results known by construction.

Run through ``tools/differential.py --edges``::

    python -m multithreading_string_matching_tpu_torch.tools.differential --edges

The kernels count in int32, so the wrappers take at most ``2^31 - 1``
positions a launch (``check_totals_bound``, ``ops/scan.split_tiles``), and
the paths that feed more slice it (``Matcher.find_matches`` and
``parallel/mesh.sliced_summary`` by ``SUMMARY_MAX_POSITIONS``, the DFA
scans by ``split_tiles`` runs) or drain first (``PackedTileCounter`` every
``DRAIN_POSITIONS``).  The soak's tiles stay under 2^20 positions, so this
module puts every one of those limits on the card:

- each of the 12 kernel entry points (``differential.TARGETS``) at the
  largest launch its wrapper accepts (``n * L = 2^31 - L``; ``reps * n * L
  = 2^31 - 2L`` for the repeated form), and the shape just past it, which
  must be refused with ``ValueError`` before any launch; the per-row forms
  have no position limit (a row counts at most ``L`` matches) and take a
  tile past 2^31 positions;
- one input past 2^31 positions through each path that slices:
  ``ac_scan_tiles`` and ``kmp_scan_tiles`` (two runs), ``find_matches``
  and ``count_rows_summary`` (two slices each);
- one count past 2^31: ``b"z"`` over 257 all-``z`` [4096 x 2048] tiles fed
  to ``PackedTileCounter``, exact in int64.

The tile is built on the card: ``torch.full`` of a filler byte that no
pattern holds, [2^20 + 1, 2048] (2 GiB), with patterns planted at the first
position, at the end of the last row of every view, across the last row
boundary of every view, at the first position past each slice and the last
one before it, and across row lengths that cut a pattern, are 0, negative
or past the width.  A pattern never spans a filler byte, so only the
planted rows can match: the expected counts, rows, triples and end states
come from the pure-Python oracle over those rows alone, never from the
plain versions (they would take minutes over 2 GiB).  ``limit`` shrinks
the geometry for the CPU tests (the plain versions; refusals and launch
counts are checked on the card only).
"""

from __future__ import annotations

import time
import types
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.tools import oracle
from multithreading_string_matching_tpu_torch.tools.differential import (
    Divergence,
    counted,
    refused,
    same,
)

LIMIT = 2**31   # the wrappers' int32 position limit
FILLER = 0x2E   # "." in no pattern
# Word counts 1, 1, 1, 3 and 4 (table classes K = 1, 3, 4; wgmma's
# generic form for the 14-byte one); the last ends in "XY", so it and a
# slice's last "XY" may share a row end.
PATTERNS = (b"Q", b"XY", b"EDGE", b"EDGE-CASE!", b"end-of-row-XY")
LONG = PATTERNS[-1]
COUNT_PATTERN = b"z"


@dataclass(frozen=True)
class Geometry:
    """The views of one tile of ``n_buf`` rows of ``L`` bytes: ``n_max``
    rows hold ``limit - L`` positions (the largest totals launch),
    ``n_max + 1`` exactly ``limit`` (refused), ``n_buf`` ``limit + L``;
    ``n_rep`` rows scanned twice hold ``limit - 2L``; ``half`` splits the
    whole tile into two scan runs; ``H`` is the halo cases' ``min_end``."""

    limit: int
    L: int

    @property
    def n_max(self) -> int:
        return self.limit // self.L - 1

    @property
    def n_buf(self) -> int:
        return self.limit // self.L + 1

    @property
    def n_rep(self) -> int:
        return self.limit // (2 * self.L) - 1

    @property
    def half(self) -> int:
        return self.n_buf // 2

    @property
    def H(self) -> int:
        return 8


def geometry(limit: int = LIMIT) -> Geometry:
    L = 2048 if limit >= 2**24 else 64
    if limit % (2 * L) or limit // L < 16:
        raise ValueError(f"limit {limit} does not divide into rows of {L} bytes")
    return Geometry(limit, L)


def plants(g: Geometry) -> Dict[int, List[Tuple[int, bytes]]]:
    """``{row: [(column, bytes)]}``: what is planted where (overlapping
    plants agree byte for byte)."""
    L = g.L
    out: Dict[int, List[Tuple[int, bytes]]] = {}
    put = lambda r, c, b: out.setdefault(r, []).append((c, b))
    put(0, 0, b"EDGE-CASE!")                        # the first position
    for e in (g.n_rep - 1, g.n_max - 1, g.n_buf - 1):
        put(e, L - len(LONG), LONG)                 # the last bytes of a view
        put(e - 1, L - 2, b"ED")                    # across its last row boundary
        put(e, 0, b"GE")
    for b in (g.n_max, g.half):
        put(b, 0, b"Q")                             # the first position past a slice
        put(b - 1, L - 2, b"XY")                    # the last one before it
    half = L // 2
    put(1, half - 5, b"EDGE")                       # ends at the row's length
    put(1, half - 1, b"XY")                         # across it
    put(2, 0, b"Q")                                 # length 0
    put(3, 0, b"XY")                                # a negative length
    put(4, L - len(LONG), LONG)                     # a length past the width
    return out


def lengths_of(g: Geometry) -> Dict[int, int]:
    """The rows whose length is not ``L``."""
    return {1: g.L // 2, 2: 0, 3: -5, 4: g.L + 7}


def row_bytes(g: Geometry) -> Dict[int, bytes]:
    """Each planted row's ``L`` bytes."""
    rows = {}
    for r, items in plants(g).items():
        b = bytearray([FILLER]) * g.L
        for c, data in items:
            for i, x in enumerate(data):
                if b[c + i] not in (FILLER, x):
                    raise ValueError(f"plants disagree at row {r}, column {c + i}")
                b[c + i] = x
        rows[r] = bytes(b)
    return rows


def texts(g: Geometry, rows: int, *, clamp: bool = True) -> Dict[int, bytes]:
    """``{row: text}`` of the planted rows below ``rows``: each row's first
    ``clamp(length, 0, L)`` bytes, or all ``L`` without ``clamp`` (the mxu
    kernel reads no lengths)."""
    lens = lengths_of(g)
    out = {}
    for r, b in row_bytes(g).items():
        if r < rows:
            n = max(0, min(lens.get(r, g.L), g.L)) if clamp else g.L
            out[r] = b[:n]
    return out


def expected_totals(g: Geometry, rows: int, pats, *, clamp: bool = True) -> List[int]:
    return oracle.oracle_counts(list(texts(g, rows, clamp=clamp).values()), pats)


def expected_rows(g: Geometry, rows: int, pats) -> Dict[int, List[int]]:
    return {r: oracle.oracle_counts([t], pats) for r, t in texts(g, rows).items()}


def expected_triples(g: Geometry, rows: int, uniq) -> List[Tuple[int, int, int]]:
    tx = texts(g, rows)
    return sorted((r, i, u) for r, t in tx.items() for u, p in enumerate(uniq)
                  for i in oracle.starts(t, p))


def halo_inputs(g: Geometry, rows: int):
    """``(eff, ms)`` int32 numpy vectors of a halo case over ``rows`` rows:
    ``eff`` the clamped lengths; ``ms`` 0 but on the last row, where it
    skips the long pattern and keeps its "XY"."""
    eff = np.full(rows, g.L, np.int32)
    for r, n in lengths_of(g).items():
        if r < rows:
            eff[r] = max(0, min(n, g.L))
    ms = np.zeros(rows, np.int32)
    ms[rows - 1] = g.L - 4
    return eff, ms


def expected_halo(g: Geometry, rows: int, uniq) -> List[int]:
    """The halo kernel's contract over the planted rows: a match at ``i``
    counts iff ``i >= ms[r]``, ``i + m <= eff[r]`` and ``i + m > H``."""
    eff, ms = halo_inputs(g, rows)
    full = {r: b for r, b in row_bytes(g).items() if r < rows}
    return [sum(1 for r, b in full.items() for i in oracle.starts(b[: eff[r]], p)
                if i >= ms[r] and i + len(p) > g.H) for p in uniq]


def host_tile(g: Geometry) -> Tuple[np.ndarray, np.ndarray]:
    """The whole tile and its lengths as numpy arrays."""
    payload = np.full((g.n_buf, g.L), FILLER, np.uint8)
    for r, b in row_bytes(g).items():
        payload[r] = np.frombuffer(b, np.uint8)
    lengths = np.full(g.n_buf, g.L, np.int32)
    for r, n in lengths_of(g).items():
        lengths[r] = n
    return payload, lengths


def device_tile(g: Geometry, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same tile built on ``device``: filled there, the planted rows
    copied in."""
    payload = torch.full((g.n_buf, g.L), FILLER, dtype=torch.uint8, device=device)
    rows = row_bytes(g)
    idx = torch.tensor(sorted(rows), dtype=torch.long, device=device)
    payload[idx] = torch.from_numpy(
        np.stack([np.frombuffer(rows[r], np.uint8) for r in sorted(rows)])).to(device)
    lengths = torch.full((g.n_buf,), g.L, dtype=torch.int32, device=device)
    for r, n in lengths_of(g).items():
        lengths[r] = n
    return payload, lengths


def _rows_check(what: str, got: torch.Tensor, want: Dict[int, List[int]], width: int) -> None:
    """Per-row counts: the planted rows exact, every other row zero (the
    column sums equal the planted rows' sums, and counts are >= 0)."""
    rows = sorted(want)
    same(f"{what}: planted rows", got[torch.tensor(rows, device=got.device)],
         [want[r] for r in rows])
    sums = [sum(want[r][u] for r in rows) for u in range(width)]
    same(f"{what}: column sums", got.sum(dim=0, dtype=torch.int64), sums)


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------


class Edges:
    """One run: the tile, its views, the tables, and the records."""

    def __init__(self, device, limit: int = LIMIT, log=print):
        from multithreading_string_matching_tpu_torch.ops.window import WindowProgram

        self.device = torch.device(device)
        if self.device.type == "cuda" and limit != LIMIT:
            raise ValueError(f"on the card the limit is the wrappers' own, {LIMIT}")
        self.g = geometry(limit)
        self.log = log
        self.case = types.SimpleNamespace(device=self.device)
        self.records: List[dict] = []
        self.wp = WindowProgram.build(list(PATTERNS))
        self.uniq = list(self.wp.unique_patterns)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            self.base = torch.cuda.memory_allocated(self.device)
        self.tables = self.wp.tables(self.device)
        self.p, self.l = device_tile(self.g, self.device)

    def view(self, rows: int):
        return self.p[:rows], self.l[:rows]

    def record(self, name: str, shape, launches: int, result: str, t0: float) -> None:
        n, L = shape
        rec = {"case": name, "shape": [int(n), int(L)], "positions": int(n) * int(L),
               "launches": int(launches), "result": result,
               "seconds": round(time.perf_counter() - t0, 4)}
        self.records.append(rec)
        self.log(f"edges {name}: [{n} x {L}] = {int(n) * int(L)} positions, {launches} "
                 f"launch(es): {result}")

    def refuse(self, name: str, fn, shape) -> None:
        t0 = time.perf_counter()
        refused(self.case, fn, name)
        self.record(name, shape, 0, "refused" if self.device.type == "cuda"
                    else "refusal checked on the card only", t0)

    # -- the window family ---------------------------------------------------

    def window(self) -> None:
        from multithreading_string_matching_tpu_torch.ops import cuda_window as cw

        g, U = self.g, len(self.uniq)
        w, m, ln = self.tables
        p, l = self.view(g.n_max)
        t0 = time.perf_counter()
        got = counted(self.case, lambda: cw.window_count_totals(p, l, w, m, ln),
                      {"window_count_totals": 1})
        same("window_count_totals at the limit", got, expected_totals(g, g.n_max, self.uniq))
        self.record("window_count_totals at the limit", p.shape, 1, "exact", t0)
        over, lo = self.view(g.n_max + 1)
        self.refuse("window_count_totals past the limit",
                    lambda: cw.window_count_totals(over, lo, w, m, ln), over.shape)

        t0 = time.perf_counter()
        got = counted(self.case, lambda: cw.window_count_rows(self.p, self.l, w, m, ln),
                      {"window_count_rows": 1})
        _rows_check("window_count_rows past the limit", got,
                    expected_rows(g, g.n_buf, self.uniq), U)
        self.record("window_count_rows past the limit (no limit: a row counts at most L)",
                    self.p.shape, 1, "exact", t0)

        p2, l2 = self.view(g.n_rep)
        t0 = time.perf_counter()
        got = counted(self.case, lambda: cw.window_count_totals(p2, l2, w, m, ln, 2),
                      {"window_count_totals_repeated": 1})
        same("window_count_totals reps=2 at the limit", got,
             [2 * c for c in expected_totals(g, g.n_rep, self.uniq)])
        self.record("window_count_totals_repeated reps=2 at the limit", p2.shape, 1, "exact", t0)
        p3, l3 = self.view(g.n_rep + 1)
        self.refuse("window_count_totals_repeated reps=2 past the limit",
                    lambda: cw.window_count_totals(p3, l3, w, m, ln, 2), p3.shape)

        eff_np, ms_np = halo_inputs(g, g.n_max)
        eff = torch.from_numpy(eff_np).to(self.device)
        ms = torch.from_numpy(ms_np).to(self.device)
        t0 = time.perf_counter()
        got = counted(self.case, lambda: cw.window_count_halo(p, eff, ms, w, m, ln, g.H),
                      {"window_count_halo": 1})
        same("window_count_halo at the limit", got, expected_halo(g, g.n_max, self.uniq))
        self.record("window_count_halo at the limit", p.shape, 1, "exact", t0)
        eff_o = torch.cat([eff, eff[-1:]])
        ms_o = torch.cat([ms, ms[-1:]])
        self.refuse("window_count_halo past the limit",
                    lambda: cw.window_count_halo(over, eff_o, ms_o, w, m, ln, g.H), over.shape)

        t0 = time.perf_counter()
        got = counted(self.case, lambda: cw.window_find(p, l, w, m, ln),
                      {"window_find": 1, "window_find_rerun": 0})
        same("window_find at the limit", got, expected_triples(g, g.n_max, self.uniq))
        self.record("window_find at the limit", p.shape, 1, "exact", t0)
        self.refuse("window_find past the limit",
                    lambda: cw.window_find(over, lo, w, m, ln), over.shape)

    # -- the table family ----------------------------------------------------

    def table(self) -> None:
        from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
        from multithreading_string_matching_tpu_torch.ops.table import partition
        from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
            build_pattern_shards,
        )

        g, U = self.g, len(self.uniq)
        p, l = self.view(g.n_max)
        over, lo = self.view(g.n_max + 1)
        for form in ("table", "filter"):
            cls, inv, _ = partition(self.wp, form == "filter")
            classes = [(c.K, c.tables(self.device)) for c in cls]
            totals_fn = getattr(ct, f"{form}_count_totals")
            rows_fn = getattr(ct, f"{form}_count_rows")
            t0 = time.perf_counter()
            outs = [counted(self.case, lambda: totals_fn(p, l, *tabs, K),
                            {f"{form}_count_totals": 1}) for K, tabs in classes]
            same(f"{form}_count_totals at the limit", torch.cat(outs)[inv],
                 expected_totals(g, g.n_max, self.uniq))
            self.record(f"{form}_count_totals at the limit ({len(classes)} classes)", p.shape,
                        len(classes), "exact", t0)
            K, tabs = classes[0]
            self.refuse(f"{form}_count_totals past the limit",
                        lambda: totals_fn(over, lo, *tabs, K), over.shape)
            t0 = time.perf_counter()
            outs = [counted(self.case, lambda: rows_fn(self.p, self.l, *tabs, K),
                            {f"{form}_count_rows": 1}) for K, tabs in classes]
            _rows_check(f"{form}_count_rows past the limit", torch.cat(outs, dim=1)[:, inv],
                        expected_rows(g, g.n_buf, self.uniq), U)
            self.record(f"{form}_count_rows past the limit (no limit)", self.p.shape,
                        len(classes), "exact", t0)

            plan = build_pattern_shards(self.wp, 2, filtered=form == "filter")
            kernel = ct.ShardTableKernel(plan.K, plan.S, plan.use_fit, form == "filter",
                                         self.device)
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(self.device)
            blocks = [tuple(t(a[d * plan.S:(d + 1) * plan.S]) for a in
                            (plan.words, plan.masks, plan.lens)) for d in range(plan.n_shards)]
            key = f"shard_{form}_count"
            t0 = time.perf_counter()
            parts = [counted(self.case, lambda: kernel.counts(*b, p, l), {f"{key}_totals": 1})
                     for b in blocks]
            same(f"{key}_totals at the limit", plan.gather(torch.cat(parts).cpu().numpy()),
                 expected_totals(g, g.n_max, self.uniq))
            self.record(f"ShardTableKernel.counts ({form}) at the limit, {plan.n_shards} shards",
                        p.shape, plan.n_shards, "exact", t0)
            self.refuse(f"ShardTableKernel.counts ({form}) past the limit",
                        lambda: kernel.counts(*blocks[0], over, lo), over.shape)
            t0 = time.perf_counter()
            parts = [counted(self.case, lambda: kernel.rows(*b, self.p, self.l),
                             {f"{key}_rows": 1}) for b in blocks]
            merged = torch.from_numpy(plan.gather(torch.cat(parts, dim=1).cpu().numpy()))
            _rows_check(f"{key}_rows past the limit", merged,
                        expected_rows(g, g.n_buf, self.uniq), U)
            self.record(f"ShardTableKernel.rows ({form}) past the limit (no limit)",
                        self.p.shape, plan.n_shards, "exact", t0)

    # -- the tensor-core kernel ------------------------------------------------

    def mxu(self) -> None:
        from multithreading_string_matching_tpu_torch.ops import mxu as mx

        g = self.g
        P_np, tgt_np, _ = mx.bit_tables(list(PATTERNS))
        P = torch.from_numpy(P_np).to(self.device)
        tgt = torch.from_numpy(tgt_np.reshape(-1)).to(self.device)
        p, _ = self.view(g.n_max)
        t0 = time.perf_counter()
        got = counted(self.case, lambda: mx.mxu_count(p, P, tgt, live=len(PATTERNS)),
                      {"mxu_count": 1})
        want = expected_totals(g, g.n_max, list(PATTERNS), clamp=False)
        same("mxu_count at the limit", got[: len(PATTERNS)], want)
        self.record("mxu_count at the limit (full rows: no lengths)", p.shape, 1, "exact", t0)
        over, _ = self.view(g.n_max + 1)
        self.refuse("mxu_count past the limit",
                    lambda: mx.mxu_count(over, P, tgt, live=len(PATTERNS)), over.shape)

    # -- the DFA scans ---------------------------------------------------------

    def scans(self) -> None:
        from multithreading_string_matching_tpu_torch.models.aho_corasick import AhoCorasick
        from multithreading_string_matching_tpu_torch.models.kmp import stack_kmp_dfas
        from multithreading_string_matching_tpu_torch.ops import scan as sc

        g = self.g
        ac = AhoCorasick.build(list(PATTERNS))
        cac = sc.CompiledAC.from_automaton(ac, self.device)
        auniq = list(ac.unique_patterns)
        p, l = self.view(g.n_max)
        over, lo = self.view(g.n_max + 1)
        halves = [(self.p[: g.half], self.l[: g.half]), (self.p[g.half:], self.l[g.half:])]
        runs = len(sc.split_tiles([tuple(t.shape) for t, _ in halves], g.limit))
        launches = runs if self.device.type == "cuda" else 0

        t0 = time.perf_counter()
        zero = torch.zeros(g.n_max, dtype=torch.int32, device=self.device)
        got, states = counted(self.case, lambda: sc.ac_scan(cac, p, l, zero), {"ac_scan": 1})
        same("ac_scan at the limit", got, expected_totals(g, g.n_max, auniq))
        ends = {}
        for r, t in texts(g, g.n_max).items():
            s = 0
            for c in t:
                s = int(ac.goto[s, c])
            ends[r] = s
        rows = sorted(ends)
        same("ac_scan end states of the planted rows",
             states[torch.tensor(rows, device=self.device)], [ends[r] for r in rows])
        same("ac_scan end states: the other rows at the root",
             int((states != 0).sum()), sum(1 for s in ends.values() if s))
        self.record("ac_scan at the limit (end states too)", p.shape, 1, "exact", t0)
        zero_o = torch.zeros(g.n_max + 1, dtype=torch.int32, device=self.device)
        self.refuse("ac_scan past the limit", lambda: sc.ac_scan(cac, over, lo, zero_o),
                    over.shape)
        for pp in (False, True):
            t0 = time.perf_counter()
            got = counted(self.case, lambda: sc.ac_scan_tiles(cac, halves, per_packet=pp),
                          {"ac_scan": runs})
            if pp:
                _rows_check("ac_scan_tiles rows past the limit", got,
                            expected_rows(g, g.n_buf, auniq), len(auniq))
            else:
                same("ac_scan_tiles past the limit", got, expected_totals(g, g.n_buf, auniq))
            self.record(f"ac_scan_tiles{' per packet' if pp else ''} past the limit "
                        f"({runs} split_tiles runs)", self.p.shape, launches, "exact", t0)

        kmp = sc.CompiledKMP.from_numpy(*stack_kmp_dfas(list(PATTERNS)), device=self.device)
        t0 = time.perf_counter()
        got = counted(self.case, lambda: sc.kmp_scan(kmp, p, l), {"kmp_scan": 1})
        same("kmp_scan at the limit", got, expected_totals(g, g.n_max, list(PATTERNS)))
        self.record("kmp_scan at the limit", p.shape, 1, "exact", t0)
        self.refuse("kmp_scan past the limit", lambda: sc.kmp_scan(kmp, over, lo), over.shape)
        t0 = time.perf_counter()
        got = counted(self.case, lambda: sc.kmp_scan_tiles(kmp, halves), {"kmp_scan": runs})
        same("kmp_scan_tiles past the limit", got, expected_totals(g, g.n_buf, list(PATTERNS)))
        self.record(f"kmp_scan_tiles past the limit ({runs} split_tiles runs)", self.p.shape,
                    launches, "exact", t0)

    # -- the paths that slice or drain -----------------------------------------

    def slices(self) -> None:
        from multithreading_string_matching_tpu_torch.api import Matcher
        from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
        from multithreading_string_matching_tpu_torch.parallel import mesh as mesh_mod

        g = self.g
        host_p, host_l = host_tile(g)
        n, L = host_p.shape
        step = (mesh_mod.SUMMARY_MAX_POSITIONS - 1) // L
        slices = -(-n // step)
        launches = slices if self.device.type == "cuda" else 0
        m = Matcher(list(PATTERNS), device=self.device)
        t0 = time.perf_counter()
        # The last slice's buffer is sized by the first's match density, so
        # it may be short: a rerun is the wrapper's contract, counted apart.
        reruns = cw.LAUNCHES["window_find_rerun"]
        got = counted(self.case, lambda: m.find_matches(host_p, host_l), {"window_find": slices})
        reruns = cw.LAUNCHES["window_find_rerun"] - reruns
        same("find_matches past the limit", got, expected_triples(g, g.n_buf, self.uniq))
        self.record(f"Matcher.find_matches past the limit ({slices} row slices, {reruns} "
                    f"rerun(s))", host_p.shape, launches + reruns, "exact", t0)

        t0 = time.perf_counter()
        tot, hits = counted(self.case, lambda: mesh_mod.count_rows_summary(
            m, host_p, host_l, mesh_mod.make_mesh([self.device]), engine="pallas"),
            {"window_count_rows": slices})
        same("count_rows_summary totals past the limit", tot,
             expected_totals(g, g.n_buf, self.uniq))
        want_hits = np.zeros(n, bool)
        for r, c in expected_rows(g, g.n_buf, self.uniq).items():
            want_hits[r] = any(c)
        same("count_rows_summary row hits past the limit", hits, want_hits)
        self.record(f"mesh count_rows_summary past the limit ({slices} slices)", host_p.shape,
                    launches, "exact (int64 totals)", t0)
        del host_p, host_l

    def packed_count(self) -> None:
        from multithreading_string_matching_tpu_torch.api import Matcher
        from multithreading_string_matching_tpu_torch.parallel import pipeline

        g = self.g
        width = 2048 if g.limit == LIMIT else 16
        rows = (g.limit >> 8) // width
        feeds = g.limit // (rows * width) + 1
        counter = pipeline.PackedTileCounter(Matcher([COUNT_PATTERN], device=self.device),
                                             tile_rows=rows, pack_width=width)
        tile = np.full((rows, width), COUNT_PATTERN[0], np.uint8)
        lengths = np.full(rows, width, np.int32)
        t0 = time.perf_counter()
        drains = 0
        real = counter._drain

        def drain():
            nonlocal drains
            drains += counter._total is not None
            real()

        counter._drain = drain

        def feed():
            for _ in range(feeds):
                counter.add(tile, lengths)
            return counter.totals()

        got = counted(self.case, feed, {"window_count_totals": feeds})
        want = feeds * rows * width
        if got.dtype != np.int64 or got.tolist() != [want]:
            raise Divergence(f"PackedTileCounter past 2^31 matches: got {got.tolist()} "
                             f"({got.dtype}), want [{want}]")
        if counter.tiles_dispatched != feeds:
            raise Divergence(f"PackedTileCounter dispatched {counter.tiles_dispatched} tiles")
        self.record(f"PackedTileCounter: {want} matches of b'z' (past 2^31) in {feeds} tiles, "
                    f"{drains} drains", (feeds * rows, width),
                    feeds if self.device.type == "cuda" else 0, "exact (int64)", t0)

    def run(self) -> List[dict]:
        """Every case; on the card the last record is the device memory the
        cases added at their peak (above what the process held before)."""
        for part in (self.window, self.table, self.mxu, self.scans):
            part()
        del self.p, self.l
        self.slices()
        self.packed_count()
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device) - self.base
            self.log(f"edges: peak device memory {peak / 2**30:.3f} GiB")
            self.records.append({"case": "peak device memory", "bytes": int(peak)})
        return self.records


def run_edges(device="cuda", limit: int = LIMIT, log=print) -> List[dict]:
    """Every edge case on ``device``; raises :class:`Divergence` on the
    first result that differs or shape that is not refused."""
    return Edges(device, limit, log).run()
