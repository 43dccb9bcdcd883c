"""Pattern-axis sharding: every shard scans every packet with 1/N of the
rule set.

Counterpart of ``multithreading_string_matching_tpu/parallel/
pattern_shard.py`` (all of it but ``make_tile_counter``, which comes with
the packed-tile pipeline, ROADMAP Queue 1 item 7).  The unique patterns are
cut into N contiguous build-order chunks; shard d gets chunk d as its own
table block, on its own device, scans the same payload rows, and the merge
is a concatenation of the shards' counts.  A 2-D ``("packets",
"patterns")`` mesh also cuts the rows: shard (i, j) counts row block i
against table block j, totals are summed over i and concatenated over j.

Every block has the JAX package's common geometry ``[S, K_max(+1)]``
(``ops/table.plan_shard_geometry``), so the plan's arrays equal the JAX
package's.  All patterns run the full ``K_max``-word chain (mask-0 words
past a pattern's end compare true); padded slots carry a length no position
fits, and with the filter the never-fires sentinel, so they count 0, and
``PatternShardPlan.gather`` slices them off.

Engines are the window family: ``'pallas'`` launches the table or filter
kernels through :class:`~multithreading_string_matching_tpu_torch.ops.
cuda_table.ShardTableKernel` (their plain versions on CPU shards),
``'window'`` runs the plain window count.  ``auto``, ``ac`` and ``kmp``
remap to the family the matcher's own engine resolves to (the AC and KMP
automata bake the whole set into one DFA and cannot shard this axis);
counts are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.ops.cuda_table import ShardTableKernel
from multithreading_string_matching_tpu_torch.ops.table import filter_words, plan_shard_geometry
from multithreading_string_matching_tpu_torch.ops.window import window_count
from multithreading_string_matching_tpu_torch.parallel.mesh import (
    Mesh,
    default_devices,
    make_mesh,
    sliced_summary,
    stage,
)

PATTERN_AXIS = "patterns"
PACKET_AXIS = "packets"

# Padded shard slots carry this length so the fit test (pos + len <= L)
# never passes: far above any payload width, far below int32 overflow when
# added to a position.
_NEVER_FIT = np.int32(2**30)


def make_pattern_mesh(devices=None, *, device_type: str = "cuda") -> Mesh:
    """1-D mesh over the pattern axis: every shard scans ALL packets with
    1/N of the rule set."""
    devs = list(devices) if devices is not None else default_devices(device_type)
    return Mesh(devs, (PATTERN_AXIS,))


def make_2d_mesh(packet_shards: int, pattern_shards: int, devices=None, *,
                 device_type: str = "cuda") -> Mesh:
    """2-D mesh: payload rows shard over ``packets``, pattern tables over
    ``patterns``."""
    devs = list(devices) if devices is not None else default_devices(device_type)
    if len(devs) != packet_shards * pattern_shards:
        raise ValueError(
            f"{len(devs)} devices cannot form a {packet_shards}x{pattern_shards} mesh"
        )
    grid = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return Mesh(grid.reshape(packet_shards, pattern_shards), (PACKET_AXIS, PATTERN_AXIS))


def _axes(mesh: Mesh) -> Tuple[str, Optional[str]]:
    """(pattern_axis, packet_axis_or_None): an explicit "patterns" name wins;
    a 1-D mesh's single axis is the pattern axis whatever its name."""
    names = mesh.axis_names
    if PATTERN_AXIS in names:
        others = [a for a in names if a != PATTERN_AXIS]
        if not others:
            return PATTERN_AXIS, None
        if others == [PACKET_AXIS]:
            return PATTERN_AXIS, PACKET_AXIS
        raise ValueError(
            f"pattern-sharded mesh axes must be ('patterns',) or "
            f"('packets', 'patterns'); got {names}"
        )
    if len(names) == 1:
        return names[0], None
    raise ValueError(f"a multi-axis mesh must name its pattern axis 'patterns'; got {names}")


@dataclass(frozen=True)
class PatternShardPlan:
    """Host-built per-shard pattern tables and the build-order gather map.

    Shard d owns unique patterns [d*C, min((d+1)*C, U)), contiguous in
    build order, padded to the common shard size S; the arrays stack the
    shards' blocks, ``[n_shards*S, ...]``."""

    words: np.ndarray    # uint32[n_sh*S, K(+1 with the filter column)]
    masks: np.ndarray    # uint32[n_sh*S, K(+1)]
    lens: np.ndarray     # int32[n_sh*S, 1] (_NEVER_FIT in padded slots)
    n_shards: int
    S: int               # padded patterns per shard
    C: int               # real patterns per shard (the last may be short)
    U: int
    K: int
    use_fit: bool
    filtered: bool

    def valid(self, d: int) -> int:
        """Real patterns in shard d: ``clip(U - d*C, 0, C)``; the last shard
        may be short, or empty with more shards than patterns."""
        return min(self.C, max(self.U - d * self.C, 0))

    def gather(self, full: np.ndarray) -> np.ndarray:
        """[..., n_sh*S] concatenated shard outputs -> [..., U] build-order
        unique counts (drops the padded slots)."""
        full = np.asarray(full)
        parts = [full[..., d * self.S : d * self.S + self.valid(d)]
                 for d in range(self.n_shards) if self.valid(d) > 0]
        return np.concatenate(parts, axis=-1)

    def shard_of_unique(self, u: int) -> Tuple[int, int]:
        """(shard, slot) carrying unique pattern u."""
        return u // self.C, u % self.C


def build_pattern_shards(wp, n_shards: int, *, filtered: bool = False,
                         assume_zero_padded: bool = True) -> PatternShardPlan:
    """Cut a WindowProgram's unique patterns into ``n_shards`` padded table
    blocks.  ``filtered`` appends the filter column K, with the filter
    words ranked over the WHOLE set (a shard-local rarity would mis-rank
    shared prefixes)."""
    U, K = wp.pat_words.shape
    C = -(-U // n_shards)
    S, _pb, _nb = plan_shard_geometry(C)
    use_fit = (not assume_zero_padded) or any(0 in p for p in wp.unique_patterns)
    kw = K + (1 if filtered else 0)
    words = np.zeros((n_shards * S, kw), np.uint32)
    masks = np.zeros((n_shards * S, kw), np.uint32)
    lens = np.full((n_shards * S, 1), _NEVER_FIT, np.int32)
    if filtered:
        fwords, fmasks = filter_words(wp)
        # Never-fires sentinel in padded slots: x & 0 == 1 is false.
        words[:, K] = 1
        masks[:, K] = 0
    for d in range(n_shards):
        lo = d * C
        hi = min(lo + C, U)
        if hi <= lo:
            break
        v = hi - lo
        words[d * S : d * S + v, :K] = wp.pat_words[lo:hi]
        masks[d * S : d * S + v, :K] = wp.pat_masks[lo:hi]
        lens[d * S : d * S + v, 0] = wp.pat_lens[lo:hi]
        if filtered:
            words[d * S : d * S + v, K] = fwords[lo:hi]
            masks[d * S : d * S + v, K] = fmasks[lo:hi]
    return PatternShardPlan(
        words=words, masks=masks, lens=lens, n_shards=n_shards, S=S, C=C,
        U=U, K=K, use_fit=use_fit, filtered=filtered,
    )


def plan_from_reference(ref) -> PatternShardPlan:
    """The port's plan from the JAX package's ``PatternShardPlan`` (its
    arrays as numpy arrays): the shard tables carried across, as
    ``ops/window.program_from_reference`` carries the pattern program.
    Raises on fields that do not describe one plan."""
    words = np.asarray(ref.words, dtype=np.uint32)
    masks = np.asarray(ref.masks, dtype=np.uint32)
    lens = np.asarray(ref.lens, dtype=np.int32)
    n_sh, S, C, U, K = (int(getattr(ref, f)) for f in ("n_shards", "S", "C", "U", "K"))
    filtered = bool(ref.filtered)
    shape = (n_sh * S, K + int(filtered))
    if n_sh < 1 or words.shape != shape or masks.shape != shape or lens.shape != (n_sh * S, 1):
        raise ValueError(
            f"a plan of {n_sh} shards of {S} x K={K}{' + filter' if filtered else ''} "
            f"needs tables {shape} and lens {(n_sh * S, 1)}: got words {words.shape}, "
            f"masks {masks.shape}, lens {lens.shape}"
        )
    if U < 1 or C != -(-U // n_sh) or C > S:
        raise ValueError(f"C={C} is not ceil(U={U} / {n_sh}) within S={S}")
    return PatternShardPlan(words=words, masks=masks, lens=lens, n_shards=n_sh, S=S, C=C,
                            U=U, K=K, use_fit=bool(ref.use_fit), filtered=filtered)


def _resolve_engine(matcher, engine: Optional[str]) -> str:
    """Window family only: auto/ac/kmp take the family of the matcher's own
    engine (``ac``/``kmp`` matchers the window form), decided before the
    matcher is asked to resolve anything it cannot run."""
    engine = engine or "auto"
    if engine in ("auto", "ac", "kmp"):
        engine = "pallas" if matcher._requested_engine(None) == "pallas" else "window"
    if engine not in ("window", "pallas"):
        raise ValueError(
            f"unknown pattern-shard engine {engine!r}: expected "
            "auto/window/pallas (ac/kmp remap to the window family)"
        )
    return engine


def _plan_for(matcher, n_shards: int, filtered: bool) -> PatternShardPlan:
    """The plan, cached on the matcher by (WindowProgram, n_shards,
    filtered); ``swap_patterns`` builds a new WindowProgram, which empties
    the cache."""
    wp = matcher.window
    cache = getattr(matcher, "_pattern_shard_plans", None)
    if cache is None:
        cache = matcher._pattern_shard_plans = {}
    if cache.get("_wp") is not wp:
        cache.clear()
        cache["_wp"] = wp
        # The old plans' staged tables go with them: an id(plan) key could
        # alias a new plan at a freed plan's address and serve the old
        # rule set's tables (swap_patterns twice in a row).
        staged = getattr(matcher, "_pattern_shard_staged", None)
        if staged is not None:
            staged.clear()
    key = (n_shards, filtered)
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = build_pattern_shards(wp, n_shards, filtered=filtered)
    return plan


def _shard_kernel_for(matcher, plan: PatternShardPlan, device) -> ShardTableKernel:
    cache = getattr(matcher, "_pattern_shard_kernels", None)
    if cache is None:
        cache = matcher._pattern_shard_kernels = {}
    key = (plan.K, plan.S, plan.use_fit, plan.filtered, device)
    kern = cache.get(key)
    if kern is None:
        kern = cache[key] = ShardTableKernel(plan.K, plan.S, plan.use_fit, plan.filtered, device)
    return kern


def _grid(mesh: Mesh, pat_ax: str, pkt_ax: Optional[str]):
    """``[(i, j, device)]``: shard (packet block i, table block j) and its
    device; i is 0 without a packet axis."""
    devs = mesh.devices
    if pkt_ax is None:
        return [(0, j, d) for j, d in enumerate(devs.flat)]
    if mesh.axis_names.index(pat_ax) == 0:
        devs = devs.T
    return [(i, j, devs[i, j]) for i in range(devs.shape[0]) for j in range(devs.shape[1])]


def _stage_tables(matcher, plan: PatternShardPlan, mesh: Mesh, grid) -> dict:
    """``{(device, j): (words, masks, lens)}``: table block j on each device
    that counts it, staged once per (plan, mesh).  The entry holds the plan
    it was staged from and serves only that object (an id() key alone
    could alias a new plan at a freed plan's address)."""
    cache = getattr(matcher, "_pattern_shard_staged", None)
    if cache is None:
        cache = matcher._pattern_shard_staged = {}
    key = (id(plan), mesh)
    entry = cache.get(key)
    if entry is None or entry[0] is not plan:
        S = plan.S
        tabs = {}
        for _i, j, dev in grid:
            if (dev, j) not in tabs:
                rows = slice(j * S, (j + 1) * S)
                tabs[(dev, j)] = (
                    stage(plan.words[rows].view(np.int32), np.int32, dev),
                    stage(plan.masks[rows].view(np.int32), np.int32, dev),
                    stage(plan.lens[rows, 0], np.int32, dev),
                )
        entry = cache[key] = (plan, tabs)
    return entry[1]


@dataclass
class _Call:
    plan: PatternShardPlan
    engine: str
    grid: list
    tables: dict     # (device, j) -> (words, masks, lens)
    rows: dict       # (device, i) -> (payloads, lengths): each row block once per device
    block: int       # rows per packet block
    kernels: dict    # device -> ShardTableKernel ('pallas')

    def local(self, i: int, j: int, dev, per_row: bool) -> torch.Tensor:
        """Shard (i, j)'s int32[S] totals, or int32[rows, S] per row."""
        w, m, ln = self.tables[(dev, j)]
        p, l = self.rows[(dev, i)]
        if self.engine == "pallas":
            kern = self.kernels[dev]
            return kern.rows(w, m, ln, p, l) if per_row else kern.counts(w, m, ln, p, l)
        K = self.plan.K
        return window_count(w[:, :K], m[:, :K], ln, p, l, per_packet=per_row)


def _prepare_call(matcher, payloads, lengths, mesh: Mesh, engine) -> _Call:
    """Resolve the engine; build or reuse the plan, kernels and staged
    tables; fold and pad the rows, and stage each row block once per
    device that counts it (a pattern mesh of four shards on one card holds
    one copy of the payload)."""
    pat_ax, pkt_ax = _axes(mesh)
    engine = _resolve_engine(matcher, engine)
    filtered = engine == "pallas" and matcher._pallas_filter_selected()
    plan = _plan_for(matcher, mesh.shape[pat_ax], filtered)
    grid = _grid(mesh, pat_ax, pkt_ax)
    payloads = matcher._maybe_fold(np.asarray(payloads))
    lengths = np.asarray(lengths)
    n_pkt = mesh.shape[pkt_ax] if pkt_ax is not None else 1
    n = payloads.shape[0]
    n_pad = -(-max(n, 1) // n_pkt) * n_pkt
    if n_pad != n:
        payloads = np.pad(payloads, ((0, n_pad - n), (0, 0)))
        lengths = np.pad(lengths, (0, n_pad - n))
    block = n_pad // n_pkt
    rows = {}
    for i, _j, dev in grid:
        if (dev, i) not in rows:
            rs = slice(i * block, (i + 1) * block)
            rows[(dev, i)] = (stage(payloads[rs], np.uint8, dev), stage(lengths[rs], np.int32, dev))
    kernels = ({dev: _shard_kernel_for(matcher, plan, dev) for _i, _j, dev in grid}
               if engine == "pallas" else {})
    return _Call(plan, engine, grid, _stage_tables(matcher, plan, mesh, grid), rows, block,
                 kernels)


def _concat_totals(call: _Call, parts: dict) -> np.ndarray:
    """int32[n_sh*S]: each table block's totals summed over the packet
    blocks, the blocks concatenated."""
    return np.concatenate([
        torch.stack([t.cpu() for t in parts[j]]).sum(dim=0, dtype=torch.int32).numpy()
        for j in range(call.plan.n_shards)
    ])


def count_matches_pattern_sharded(
    matcher,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    engine: Optional[str] = None,
    expand_duplicates: bool = True,
) -> np.ndarray:
    """Totals with the PATTERN axis sharded over the mesh (and the packet
    axis too, on a 2-D ``('packets', 'patterns')`` mesh); equal to the
    one-device count for any shard count."""
    call = _prepare_call(matcher, payloads, lengths, mesh, engine)
    parts: dict = {}
    for i, j, dev in call.grid:  # launch every shard, then gather
        parts.setdefault(j, []).append(call.local(i, j, dev, per_row=False))
    uniq = call.plan.gather(_concat_totals(call, parts))
    if expand_duplicates:
        uniq = uniq[matcher.window.dup_map]
    return uniq


def count_rows_pattern_sharded(
    matcher,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    engine: Optional[str] = None,
    expand_duplicates: bool = True,
) -> np.ndarray:
    """Per-packet counts [N, U or P] with the pattern columns sharded (and
    the rows, on a 2-D mesh)."""
    n = int(np.shape(payloads)[0])
    call = _prepare_call(matcher, payloads, lengths, mesh, engine)
    S, B = call.plan.S, call.block
    outs = [(i, j, call.local(i, j, dev, per_row=True)) for i, j, dev in call.grid]
    n_pkt = max(i for i, _j, _d in call.grid) + 1
    full = np.zeros((n_pkt * B, call.plan.n_shards * S), np.int32)
    for i, j, rows in outs:
        full[i * B:(i + 1) * B, j * S:(j + 1) * S] = rows.cpu().numpy()
    uniq = call.plan.gather(full[:n])
    if expand_duplicates:
        uniq = uniq[:, matcher.window.dup_map]
    return uniq


def count_rows_summary_pattern_sharded(
    matcher,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    engine: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(unique totals int64[U] build order, row_hits bool[N])``: the
    pattern-sharded form of ``mesh.count_rows_summary``, reduced on each
    shard's device.  Totals are int32 there: feeds of
    ``mesh.SUMMARY_MAX_POSITIONS`` positions or more are sliced
    (``mesh.sliced_summary``)."""

    def once(payloads, lengths):
        n = int(np.shape(payloads)[0])
        call = _prepare_call(matcher, payloads, lengths, mesh, engine)
        tots: dict = {}
        hits: dict = {}
        for i, j, dev in call.grid:
            rows = call.local(i, j, dev, per_row=True)
            tots.setdefault(j, []).append(rows.sum(dim=0, dtype=torch.int32))
            # A row-hit flag must not fire on a padded slot: only this
            # shard's own valid columns count.
            hit = (rows[:, : call.plan.valid(j)] > 0).any(dim=1)
            hits[i] = hit.cpu() if i not in hits else hits[i] | hit.cpu()
        uniq = call.plan.gather(_concat_totals(call, tots)).astype(np.int64)
        flags = torch.cat([hits[i] for i in sorted(hits)]).numpy()
        return uniq, flags[:n]

    pkt_ax = _axes(mesh)[1]
    return sliced_summary(once, payloads, lengths, mesh.shape[pkt_ax] if pkt_ax else 1,
                          len(matcher.window.unique_patterns))


def resolve_shard_mesh(shard_axis: str, n_dev: Optional[int] = None, *,
                       device_type: str = "cuda") -> Mesh:
    """The default mesh for a ``--shard-axis`` choice over the first
    ``n_dev`` default devices of ``device_type``: 1-D packets, 1-D
    patterns, or the most-square 2-D split for 'both'."""
    devs = default_devices(device_type)
    if n_dev is not None:
        devs = devs[:n_dev]
    if shard_axis == "patterns":
        return make_pattern_mesh(devs)
    if shard_axis == "both":
        n = len(devs)
        a = int(np.sqrt(n))
        while n % a:
            a -= 1
        # The pattern axis takes the larger factor.
        return make_2d_mesh(a, n // a, devs)
    return make_mesh(devs)


def choose_shard_axis(matcher, n_dev: int) -> str:
    """'patterns' when the rule set takes the table kernels (the regime
    where dividing U per device beats dividing packets), 'packets'
    otherwise, and always with one device.  The CLI's ``--shard-axis
    auto``."""
    if n_dev <= 1:
        return "packets"
    _, _, total_words = matcher._pattern_stats()
    return "patterns" if matcher._pallas_table_selected(total_words) else "packets"
