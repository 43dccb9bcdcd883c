"""The DFA scan kernels' host-side plans, against the plain versions and the
JAX package on the CPU.

The CUDA kernels (``csrc/scan.cu``) cannot run here, so what they compute
beyond the plain version is modelled in numpy from the same plans the
wrappers hand them, and held equal to ``ac_scan_plain`` / ``kmp_scan_plain``
and to the JAX package's scans:

- ``ac_scan`` cuts each row into segments of C bytes (``ac_segment_bytes``);
  segment j > 0 warms up from the root D bytes early (D: the automaton's
  greatest state depth), a dead lane stays dead, and the segment that holds
  byte nv - 1 (segment 0 when nv == 0) owns the final state;
- ``kmp_scan`` stages groups of patterns (``kmp_groups``) as interleaved
  uint8 slots whose accept state is relabelled to the group's last state;
- the tile-list wrappers plan descriptors and split lists at 2^31
  positions, and on the CPU run the plain version tile by tile.

Counts and states are integers: every comparison is exact (tolerance 0).
Shapes stay small: the model and the plain versions loop in Python.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from oracle import count_overlapping
from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.models import aho_corasick as jac
from multithreading_string_matching_tpu.models import kmp as jkmp
from multithreading_string_matching_tpu.ops import scan as jscan
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)

STANDIN = load_patterns(pathlib.Path(__file__).resolve().parent.parent
                        / "multithreading_string_matching_tpu_torch" / "data"
                        / "strings_standin.txt")
BOUNDARY = [b"abcdefghij", b"hij", b"cdefg", b"a", b"jab", b"ja", b"defghijabc"]
LONG = [b"ab" * 20, b"ba", b"abab", b"b" * 3]


def _ac(pats):
    ac = jac.AhoCorasick.build(pats)
    return ac, jscan.CompiledAC.from_automaton(ac), tscan.CompiledAC.from_numpy(
        ac.goto, ac.emit, ac.dup_map)


def segment_model(ac, cac, payload, lengths, states, seg_bytes=None):
    """What one ``ac_scan`` launch computes, segment by segment, with the
    kernel's C, D, dead-lane rule and final-state owner: (int32[n, U]
    counts, int32[n] final states); each lane's final state must be
    written by exactly one segment."""
    n, L = payload.shape
    C = tscan.ac_segment_bytes(cac.depth, L, seg_bytes)
    D = int(cac.depth or 0)  # what the wrapper hands the kernel
    segs = max(1, -(-L // C))
    counts = np.zeros((n, ac.emit.shape[1]), np.int64)
    final = np.full(n, -7, np.int64)
    writers = np.zeros(n, np.int64)
    for r in range(n):
        nv = int(np.clip(lengths[r], 0, L))
        for j in range(segs):
            lo = j * C
            if j > 0 and lo >= nv:
                continue
            hi = min(lo + C, nv)
            s = int(states[r])
            if s != cac.dead:
                w = lo - D
                if w > 0:
                    s = 0
                else:
                    w = 0
                for i in range(w, lo):
                    s = ac.goto[s, payload[r, i]]
                for i in range(lo, hi):
                    s = ac.goto[s, payload[r, i]]
                    counts[r] += ac.emit[s]
            if hi == nv:
                final[r] = s
                writers[r] += 1
    assert (writers == 1).all()
    return counts.astype(np.int32), final.astype(np.int32)


def _rows(seed, n, L, alphabet, plant=(), at=()):
    """uint8[n, L] from ``alphabet``, with each pattern of ``plant``
    written at each start of ``at`` (clipped to the row)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    p = letters[rng.integers(0, len(letters), size=(n, L))].astype(np.uint8)
    for r in range(n):
        for pat, start in zip(plant, at):
            s = int(start(r))
            if 0 <= s and s + len(pat) <= L:
                p[r, s:s + len(pat)] = np.frombuffer(pat, np.uint8)
    return p


def _states_at_every_depth(cac, ac, n, rng):
    """Carried in-table states: each depth of the automaton in turn, plus
    the root and the dead state."""
    depths = tscan.state_depths(ac.goto)
    by_depth = [np.flatnonzero(depths == d) for d in range(cac.depth + 1)]
    out = np.array([rng.choice(by_depth[r % len(by_depth)]) for r in range(n)], np.int32)
    out[::11] = cac.dead
    return out


def _check_model(ac, jc, c, payload, lengths, states, seg_bytes=None):
    model, model_st = segment_model(ac, c, payload, lengths, states, seg_bytes)
    plain, plain_st = tscan.ac_scan_plain(c, torch.from_numpy(payload),
                                          torch.from_numpy(lengths),
                                          torch.from_numpy(states), per_packet=True)
    want, want_st = jscan.count_matches_ac(jc, payloads=payload, lengths=lengths,
                                           initial_states=states, per_packet=True,
                                           return_states=True)
    assert np.array_equal(model, plain.numpy()) and np.array_equal(model, np.asarray(want))
    assert np.array_equal(model_st, plain_st.numpy())
    assert np.array_equal(model_st, np.asarray(want_st))
    return model


# -- the AC segment schedule -------------------------------------------------


@pytest.mark.parametrize("seg_bytes", [None, 16, 23])
def test_segment_model_matches_straddling_every_boundary(seg_bytes):
    """Matches planted across every segment boundary, at offsets C - D .. C
    + D from it, from the root and from carried states at every depth."""
    ac, jc, c = _ac(BOUNDARY)
    D = c.depth
    L = 300
    C = tscan.ac_segment_bytes(D, L, seg_bytes)
    n = 2 * D + 1
    bounds = range(C, L, C)
    plant = [BOUNDARY[0]] * len(bounds) + [BOUNDARY[-1]] * len(bounds)
    at = ([lambda r, b=b: b - D + r for b in bounds]
          + [lambda r, b=b: b - len(BOUNDARY[-1]) + (r % (D + 1)) for b in bounds])
    payload = _rows(1, n, L, b"abcdefghij", plant, at)
    lengths = np.full(n, L, np.int32)
    lengths[-3:] = [L - 1, C, C + 1]
    model = _check_model(ac, jc, c, payload, lengths, np.zeros(n, np.int32), seg_bytes)
    assert model.sum() > 200
    states = _states_at_every_depth(c, ac, n, np.random.default_rng(2))
    _check_model(ac, jc, c, payload, lengths, states, seg_bytes)


@pytest.mark.parametrize("seg_bytes", [8, 16, None])
def test_segment_model_pattern_longer_than_a_segment(seg_bytes):
    """A 40-byte pattern (D = 40) over segments of 8 or 16 bytes: warm-ups
    that reach before byte 0 start from the lane's own state."""
    ac, jc, c = _ac(LONG)
    assert c.depth == 40
    L = 200
    payload = _rows(3, 24, L, b"ab", [LONG[0]] * 3, [lambda r: r, lambda r: 60 + 3 * r,
                                                      lambda r: 150 - r])
    lengths = np.random.default_rng(4).integers(-5, L + 10, 24).astype(np.int32)
    states = _states_at_every_depth(c, ac, 24, np.random.default_rng(5))
    model = _check_model(ac, jc, c, payload, lengths, states, seg_bytes)
    assert model[:, 0].sum() > 10  # the long pattern itself


@pytest.mark.parametrize("seg_bytes", [None, 16, 53])
def test_segment_model_without_a_depth(seg_bytes):
    """A table with a state the root does not reach has no depth: a row is
    one segment whatever ``seg_bytes`` asks.  Small segments started from
    the root without a warm-up and missed the matches across their starts
    (``tools/differential.py`` on the card, seed 1, case 22: an automaton
    over two symbols, carried states, 53-byte segments)."""
    import types

    from multithreading_string_matching_tpu_torch.models.aho_corasick import AhoCorasick

    rng = np.random.default_rng(22)
    ac = AhoCorasick.build(BOUNDARY + LONG)
    S = ac.dead_state
    goto = np.empty((S + 2, 256), np.int32)
    goto[:S] = ac.goto[:S]
    goto[S] = rng.integers(0, S + 1, size=256)  # the unreached state
    goto[S + 1] = S + 1
    emit = np.zeros((S + 2, ac.emit.shape[1]), np.int32)
    emit[:S] = ac.emit[:S]
    emit[S] = rng.random(ac.emit.shape[1]) < 0.5
    c = tscan.CompiledAC.from_numpy(goto, emit, ac.dup_map)
    assert c.depth is None and c.dead == S + 1
    payload = _rows(23, 24, 300, b"abcdefghij", BOUNDARY, [lambda r: 13 * r + 40])
    lengths = rng.integers(-3, 310, size=24).astype(np.int32)
    states = rng.integers(0, c.dead + 1, size=24).astype(np.int32)
    states[::4] = S
    model, model_st = segment_model(types.SimpleNamespace(goto=goto, emit=emit), c, payload,
                                    lengths, states, seg_bytes)
    plain, plain_st = tscan.ac_scan_plain(c, torch.from_numpy(payload),
                                          torch.from_numpy(lengths),
                                          torch.from_numpy(states), per_packet=True)
    assert plain.sum() > 0
    assert np.array_equal(model, plain.numpy()) and np.array_equal(model_st, plain_st.numpy())


def test_segment_model_dead_lanes_and_lengths_past_either_end():
    """Dead lanes in every position (they stay dead and count nothing),
    lengths <= 0 (the state is held, segment 0 writes it) and past L."""
    ac, jc, c = _ac(BOUNDARY)
    n, L = 40, 257
    payload = _rows(6, n, L, b"abcdefghij")
    lengths = np.random.default_rng(7).integers(-9, L + 9, n).astype(np.int32)
    lengths[:4] = [0, -1, L, L + 100]
    states = np.random.default_rng(8).integers(0, c.dead + 1, n).astype(np.int32)
    states[::3] = c.dead
    model = _check_model(ac, jc, c, payload, lengths, states, 16)
    assert not model[::3].any() and model.sum() > 100
    _, final = segment_model(ac, c, payload, lengths, states, 16)
    assert (final[::3] == c.dead).all() and final[1] == states[1]


@pytest.mark.parametrize("per_packet", [False, True])
def test_segment_model_standin_nocase(per_packet):
    """The stand-in set case-folded: the matcher's automaton over folded
    bytes, against the JAX matcher with ``case_insensitive``."""
    m = Matcher(STANDIN, engine="ac", case_insensitive=True, device="cpu")
    jm = JaxMatcher(STANDIN, engine="ac", case_insensitive=True)
    rng = np.random.default_rng(9)
    n, L = 24, 400
    alphabet = b"LinuxHTPlinuxhtp /:.\x00"
    pats = [p.upper() for p in STANDIN[:20]]
    payload = _rows(10, n, L, alphabet, pats,
                    [lambda r, k=k: (37 * k + 5 * r) % L for k in range(20)])
    lengths = rng.integers(-3, L + 5, n).astype(np.int32)
    c = m.cac
    assert c.depth == max(len(p) for p in m.ac.unique_patterns)
    folded = m._maybe_fold(payload)
    model, _ = segment_model(m.ac, c, folded, lengths, np.zeros(n, np.int32), 16)
    want = np.asarray(jm.count(payload, lengths, per_packet=per_packet))
    got = m.count(payload, lengths, per_packet=per_packet)
    model = model[:, m.ac.dup_map]
    assert np.array_equal(got, want) and model.sum() > 20
    assert np.array_equal(model if per_packet else model.sum(axis=0), want)


def test_state_depth_is_the_warm_up_bound():
    """The property the segments rest on: after any text, the state is the
    one reached from the root over the text's last ``depth(state)`` bytes,
    and no state is deeper than ``CompiledAC.depth``."""
    rng = np.random.default_rng(11)
    for pats in (BOUNDARY, LONG, STANDIN, [b"aaaa", b"aa", b"a"]):
        ac, _, c = _ac(pats)
        depths = tscan.state_depths(ac.goto)
        assert depths[-1] == -1 and (depths[:-1] >= 0).all()
        assert c.depth == depths.max() == max(len(p) for p in ac.unique_patterns)
        alphabet = np.frombuffer(b"".join(pats)[:64] + b"xyz", np.uint8)
        for _ in range(20):
            text = alphabet[rng.integers(0, len(alphabet), 80)]
            s = 0
            for b in text:
                s = ac.goto[s, b]
            t = 0
            for b in text[len(text) - depths[s]:]:
                t = ac.goto[t, b]
            assert t == s


def test_kernel_table_carries_the_emit_bit(monkeypatch):
    """The kernel's table is the goto table with the emitting bit of each
    entry's target state: bit 15 of uint16 tables up to 32,768 states, bit
    31 of int32 tables; larger uint16 tables are the goto table itself and
    the kernel reads the bitmap.  ``table`` (and ``goto_flat``) stay JAX's."""
    ac, jc, c = _ac(STANDIN)
    goto = ac.goto.reshape(-1)
    emits = ac.emit.sum(axis=1) > 0
    assert c.kflag and c.ktable.dtype == torch.int16
    kt = c.ktable.numpy().view(np.uint16).astype(np.int64)
    assert np.array_equal(kt & 0x7FFF, goto) and np.array_equal(kt >> 15, emits[goto])
    assert np.array_equal(c.goto_flat.numpy(), np.asarray(jc.goto_flat))
    monkeypatch.setattr(tscan, "FLAG16_STATES", 64)
    c16 = tscan.CompiledAC.from_automaton(ac)
    assert not c16.kflag and c16.ktable is c16.table
    assert not c16.to("cpu").kflag
    monkeypatch.setattr(tscan, "UINT16_STATES", 64)
    c32 = tscan.CompiledAC.from_automaton(ac)
    assert c32.kflag and c32.ktable.dtype == torch.int32
    kt = c32.ktable.numpy().view(np.uint32).astype(np.int64)
    assert np.array_equal(kt & 0x7FFFFFFF, goto) and np.array_equal(kt >> 31, emits[goto])


# -- the planners ----------------------------------------------------------------


def test_ac_segment_bytes():
    seg = tscan.ac_segment_bytes
    assert seg(12, 1280) == 64           # the stand-in set: max(64, 48)
    assert seg(32, 1280) == 128          # the 3,072 rules' deepest state
    assert seg(17, 1280) == 80           # 68, rounded up to 16
    assert seg(300, 700) == 700          # a 300-byte pattern: one segment a row
    assert seg(12, 40) == 40 and seg(12, 0) == 1
    assert seg(None, 900) == 900         # no depth: one segment a row
    assert seg(None, 900, 53) == 900     # ... whatever seg_bytes asks
    assert seg(12, 1280, 16) == 16 and seg(12, 10, 16) == 10
    with pytest.raises(ValueError):
        seg(12, 100, 0)


def test_tile_descriptors():
    """Each tile's first global work item (segments a row times rows before
    it), first output row, C and segments a row; the tensors' addresses."""
    tiles = [(torch.zeros((n, L), dtype=torch.uint8), torch.zeros(n, dtype=torch.int32))
             for n, L in ((8, 200), (16, 64), (4, 0), (3, 13))]
    states = [torch.zeros(p.shape[0], dtype=torch.int32) for p, _ in tiles]
    desc, total = tscan.tile_descriptors(tiles, lambda L: tscan.ac_segment_bytes(12, L),
                                         states_in=states)
    assert desc.dtype == tscan.TILE_DTYPE and desc.itemsize == 64
    assert desc["C"].tolist() == [64, 64, 1, 13]
    assert desc["segs"].tolist() == [4, 1, 1, 1]
    assert desc["first"].tolist() == [0, 32, 48, 52] and total == 55
    assert desc["row0"].tolist() == [0, 8, 24, 28]
    assert desc["n"].tolist() == [8, 16, 4, 3] and desc["L"].tolist() == [200, 64, 0, 13]
    assert desc["payload"].tolist() == [p.data_ptr() for p, _ in tiles]
    assert desc["states_in"].tolist() == [s.data_ptr() for s in states]
    assert (desc["states_out"] == 0).all()
    kd, rows = tscan.tile_descriptors(tiles)  # kmp: a row a work item
    assert rows == 31 and kd["first"].tolist() == kd["row0"].tolist() == [0, 8, 24, 28]
    assert (kd["segs"] == 1).all() and (kd["C"] == 0).all()


def test_split_tiles_at_the_int32_bound():
    split = tscan.split_tiles
    big = (2**20, 1024)                  # 2^30 positions
    assert split([big, big, big]) == [range(0, 1), range(1, 2), range(2, 3)]
    assert split([big, (2**20, 1023), big]) == [range(0, 2), range(2, 3)]
    assert split([(53, 1280)] * 53) == [range(0, 53)]
    assert split([(3, 4), (3, 4), (3, 4)], limit=24) == [range(0, 1), range(1, 2),
                                                        range(2, 3)]
    assert split([(3, 4), (3, 3), (3, 4)], limit=24) == [range(0, 2), range(2, 3)]
    assert split([]) == []
    with pytest.raises(ValueError, match="overflows"):
        split([(2**21, 1024)])


def test_kmp_groups():
    """As few groups as registers (32 slots) and shared memory allow, but
    enough lanes to fill the card; every pattern in a group of at most
    ``slots``; the stand-in set in 4 groups over a pass."""
    _, accept = jkmp.stack_kmp_dfas(STANDIN)
    acc = np.sort(accept)
    groups, slots, smem = tscan.kmp_groups(acc, 100_000)
    assert (groups, slots) == (4, 28) and smem == (acc[-1] + 1) * 28 * 256
    assert smem <= tscan.KMP_SMEM_BYTES
    groups, slots, _ = tscan.kmp_groups(acc, 2048)       # 32 groups to fill the card
    assert groups == 32 and slots == 4
    assert tscan.kmp_groups(acc, 2048, fill_lanes=16384)[:2] == (8, 16)
    assert tscan.kmp_groups(acc, 10)[:2] == (97, 1)
    wide = np.sort(np.r_[np.full(40, 5), [255]])           # 256 states: one slot fits
    groups, slots, smem = tscan.kmp_groups(wide, 100_000)
    assert (groups, slots, smem) == (41, 1, 256 * 256)
    for P in (1, 5, 33, 97, 200):
        acc = np.sort(np.random.default_rng(P).integers(1, 30, P))
        for rows in (1, 700, 10**6):
            groups, slots, smem = tscan.kmp_groups(acc, rows)
            bounds = (np.arange(groups + 1) * P) // groups
            assert bounds[-1] == P and (np.diff(bounds) >= 1).all()
            assert np.diff(bounds).max() <= slots <= 32 and slots in tscan.KMP_GROUP_SIZES
            assert smem <= tscan.KMP_SMEM_BYTES or groups == P


def kmp_group_model(dfas, accept, payload, lengths, rows):
    """What one ``kmp_scan`` launch computes from its groups: each group's
    DFAs staged as the kernel stages them (slot k's state s at row s, its
    accept state relabelled to R - 1, empty slots zero), every row walked
    once a group, counting a slot where it reaches R - 1: int32[n, P]."""
    order = np.argsort(accept, kind="stable")
    acc = accept[order]
    P = len(accept)
    groups, slots, smem = tscan.kmp_groups(acc, rows)
    n, L = payload.shape
    out = np.zeros((n, P), np.int32)
    for g in range(groups):
        lo, hi = g * P // groups, (g + 1) * P // groups
        R = int(acc[hi - 1]) + 1
        assert R * slots * 256 <= smem
        staged = np.zeros((R, slots, 256), np.int64)
        for k, p in enumerate(order[lo:hi]):
            m = int(accept[p])
            for s in range(R):
                src = m if s == R - 1 else (s if s < m else -1)
                if src >= 0:
                    row = dfas[p, src].astype(np.int64)
                    staged[s, k] = np.where(row == m, R - 1, row)
        for r in range(n):
            st = np.zeros(slots, np.int64)
            cnt = np.zeros(slots, np.int64)
            for b in payload[r, : int(np.clip(lengths[r], 0, L))]:
                st = staged[st, np.arange(slots), b]
                cnt += st == R - 1
            out[r, order[lo:hi]] = cnt[: hi - lo]
    return out


@pytest.mark.parametrize("name,rows", [("small", 4), ("standin", 100_000), ("standin", 2000),
                                       ("random", 64)])
def test_kmp_group_model(name, rows):
    pats = {"small": [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"a\x00b", b"\x00"],
            "standin": STANDIN,
            "random": [bytes(np.random.default_rng(i).integers(97, 100, 1 + i % 9).tolist())
                       for i in range(60)]}[name]
    dfas, accept = jkmp.stack_kmp_dfas(pats)
    n, L = 12, 150
    payload = _rows(12, n, L, b"abc\x00LinuxHTP /", pats[:6],
                    [lambda r, k=k: 20 * k + r for k in range(6)])
    lengths = np.random.default_rng(13).integers(-4, L + 4, n).astype(np.int32)
    model = kmp_group_model(dfas, accept, payload, lengths, rows)
    kmp = tscan.CompiledKMP.from_numpy(dfas, accept)
    plain = tscan.kmp_scan_plain(kmp, torch.from_numpy(payload), torch.from_numpy(lengths),
                                 per_packet=True)
    want = np.asarray(jscan.count_matches_kmp(dfas, accept, payload, lengths, per_packet=True))
    assert np.array_equal(model, plain.numpy()) and np.array_equal(model, want)
    assert model.sum() > 0
    assert np.array_equal(kmp.order_host, np.argsort(accept, kind="stable"))


# -- the tile-list wrappers on the CPU -------------------------------------------


def _tiles(seed, shapes, pats, alphabet=b"abc\x00LinuxHTP /"):
    rng = np.random.default_rng(seed)
    out = []
    for k, (n, L) in enumerate(shapes):
        p = _rows(seed + k, n, L, alphabet, pats[:4],
                  [lambda r, j=j: (13 * j + r) % max(1, L) for j in range(4)])
        lengths = rng.integers(-3, L + 6, n).astype(np.int32)
        out.append((p, lengths))
    return out


SHAPES = [(8, 64), (16, 128), (3, 13), (5, 0), (8, 200)]


@pytest.mark.parametrize("per_packet", [False, True])
def test_ac_scan_tiles_equals_per_tile_and_jax(per_packet):
    ac, jc, c = _ac(STANDIN)
    tiles = _tiles(20, SHAPES, STANDIN)
    tt = [(torch.from_numpy(p), torch.from_numpy(l)) for p, l in tiles]
    got = tscan.ac_scan_tiles(c, tt, per_packet=per_packet)
    per_tile = [tscan.ac_scan(c, p, l, torch.zeros(p.shape[0], dtype=torch.int32),
                              per_packet=per_packet)[0] for p, l in tt]
    jax_tiles = [np.asarray(jscan.count_matches_ac(jc, p, l, per_packet=per_packet))
                 for p, l in tiles]
    assert got.dtype == torch.int32
    if per_packet:
        assert got.shape == (sum(n for n, _ in SHAPES), c.num_unique)
        assert np.array_equal(got.numpy(), torch.cat(per_tile).numpy())
        assert np.array_equal(got.numpy(), np.concatenate(jax_tiles))
    else:
        assert np.array_equal(got.numpy(), sum(t.numpy() for t in per_tile))
        assert np.array_equal(got.numpy(), np.sum(jax_tiles, axis=0))
    assert got.sum() > 10
    # Carried states: counts and new states, tile by tile, as JAX's.
    rng = np.random.default_rng(21)
    states = [rng.integers(0, c.dead + 1, p.shape[0]).astype(np.int32) for p, _ in tiles]
    got, new = tscan.ac_scan_tiles(c, tt, per_packet=True,
                                   states=[torch.from_numpy(s) for s in states])
    rows = 0
    for (p, l), s, ns in zip(tiles, states, new):
        want, want_st = jscan.count_matches_ac(jc, p, l, initial_states=s, per_packet=True,
                                               return_states=True)
        assert np.array_equal(got[rows:rows + p.shape[0]].numpy(), np.asarray(want))
        assert np.array_equal(ns.numpy(), np.asarray(want_st))
        rows += p.shape[0]
    empty = tscan.ac_scan_tiles(c, [], per_packet=per_packet)
    assert empty.shape == ((0, c.num_unique) if per_packet else (c.num_unique,))


@pytest.mark.parametrize("per_packet", [False, True])
def test_kmp_scan_tiles_equals_per_tile_and_jax(per_packet):
    dfas, accept = jkmp.stack_kmp_dfas(STANDIN)
    kmp = tscan.CompiledKMP.from_numpy(dfas, accept)
    tiles = _tiles(30, SHAPES, STANDIN)
    tt = [(torch.from_numpy(p), torch.from_numpy(l)) for p, l in tiles]
    got = tscan.kmp_scan_tiles(kmp, tt, per_packet=per_packet)
    jax_tiles = [np.asarray(jscan.count_matches_kmp(dfas, accept, p, l, per_packet=per_packet))
                 for p, l in tiles]
    per_tile = [tscan.kmp_scan(kmp, p, l, per_packet=per_packet) for p, l in tt]
    if per_packet:
        assert np.array_equal(got.numpy(), np.concatenate(jax_tiles))
        assert np.array_equal(got.numpy(), torch.cat(per_tile).numpy())
    else:
        assert np.array_equal(got.numpy(), np.sum(jax_tiles, axis=0))
        assert np.array_equal(got.numpy(), sum(t.numpy() for t in per_tile))
    assert got.dtype == torch.int32 and got.sum() > 10


@pytest.mark.parametrize("engine", ["ac", "kmp"])
def test_matcher_passes_scatter_rows_back(engine):
    """``count`` (bucket tiles cut from the payloads) and ``count_prepared``
    (staged tiles) through the tile list: totals and per-packet rows in
    input order, equal to the JAX matcher's."""
    rng = np.random.default_rng(40)
    n, L = 300, 260
    payload = _rows(41, n, L, b"LinuxHTP /:.abc", STANDIN[:8],
                    [lambda r, k=k: (31 * k + r) % L for k in range(8)])
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    m = Matcher(STANDIN, engine=engine, device="cpu")
    jm = JaxMatcher(STANDIN, engine=engine)
    for per_packet in (False, True):
        want = np.asarray(jm.count(payload, lengths, per_packet=per_packet, n_tile=64))
        got = m.count(payload, lengths, per_packet=per_packet, n_tile=64)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        prep = m.prepare(payload, lengths, n_tile=64)
        assert len(prep.tiles) > 3
        assert np.array_equal(m.count_prepared(prep, per_packet=per_packet), want)
    texts = [payload[i, : lengths[i]].tobytes() for i in range(20)]
    oracle = np.array([[count_overlapping(t, p) for p in STANDIN] for t in texts])
    assert np.array_equal(m.count(payload[:20], lengths[:20], per_packet=True), oracle)
