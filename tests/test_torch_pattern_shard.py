"""The torch package's pattern-axis sharding against the JAX package's:
totals, per-row counts and summaries on pattern and 2-D meshes of 1, 2, 4
and 8 shards, both engines, the plan's arrays, the shard kernels' plain
versions (against the JAX ``ShardTableKernel`` in interpret mode), the
engine remap, and ``swap_patterns`` twice in a row.

JAX runs on its 8-device CPU mesh; the port runs CPU meshes of the same
shard counts (N shards on the one CPU device).  Inputs are made from seeds
with numpy; counts are integers, so every comparison is exact (tolerance
0).  The shard kernels themselves need a card: tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.ops import pallas_table as jpt
from multithreading_string_matching_tpu.parallel import pattern_shard as jps
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
from multithreading_string_matching_tpu_torch.ops.table import plan_shard_geometry
from multithreading_string_matching_tpu_torch.ops.window import WindowProgram, count_matches_window
from multithreading_string_matching_tpu_torch.parallel import pattern_shard as ps

torch.set_num_threads(1)


def _mk_batch(rng, n=48, L=256, alphabet=(0x61, 0x67), zero_fill=True):
    payloads = rng.integers(*alphabet, size=(n, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    if zero_fill:
        cols = np.arange(L)[None, :]
        payloads = np.where(cols < lengths[:, None], payloads, 0).astype(np.uint8)
    return payloads, lengths


def _mk_patterns(rng, count, lens=(2, 9), alphabet=(0x61, 0x67)):
    return [bytes(rng.integers(*alphabet, size=rng.integers(*lens)).tolist())
            for _ in range(count)]


def _jmesh(n):
    return jps.make_pattern_mesh(jax.devices()[:n])


def _pmesh(n):
    return ps.make_pattern_mesh(["cpu"] * n)


def _both(pats, **kw):
    return Matcher(pats, device="cpu", **kw), JaxMatcher(pats, **kw)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("engine", ["window", "pallas"])
def test_totals_equal_jax(n_shards, engine):
    rng = np.random.default_rng(50 + n_shards)
    pats = _mk_patterns(rng, 37) + [b"aa", b"aa"]  # duplicates expand
    m, jm = _both(pats)
    payloads, lengths = _mk_batch(rng)
    want = np.asarray(jps.count_matches_pattern_sharded(jm, payloads, lengths, _jmesh(n_shards),
                                                        engine=engine))
    got = ps.count_matches_pattern_sharded(m, payloads, lengths, _pmesh(n_shards), engine=engine)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, m.count(payloads, lengths, engine="window")) and got.sum() > 0


@pytest.mark.parametrize("engine", ["window", "pallas"])
def test_rows_equal_jax(engine):
    rng = np.random.default_rng(60)
    m, jm = _both(_mk_patterns(rng, 21))
    payloads, lengths = _mk_batch(rng, n=24, L=128)
    want = np.asarray(jps.count_rows_pattern_sharded(jm, payloads, lengths, _jmesh(4),
                                                     engine=engine))
    got = ps.count_rows_pattern_sharded(m, payloads, lengths, _pmesh(4), engine=engine)
    assert got.shape == (24, 21) and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (3, 2)])
@pytest.mark.parametrize("engine", ["window", "pallas"])
def test_2d_mesh_equals_jax(engine, shape):
    """packets x patterns: rows padded to the packet axis (40 rows over 3
    packet shards too), block (i, j) per shard, totals summed over i."""
    rng = np.random.default_rng(61)
    m, jm = _both(_mk_patterns(rng, 19))
    payloads, lengths = _mk_batch(rng, n=40, L=128)
    jmesh = jps.make_2d_mesh(*shape, jax.devices()[: shape[0] * shape[1]])
    pmesh = ps.make_2d_mesh(*shape, ["cpu"] * (shape[0] * shape[1]))
    assert pmesh.shape == {"packets": shape[0], "patterns": shape[1]}
    want = np.asarray(jps.count_matches_pattern_sharded(jm, payloads, lengths, jmesh, engine=engine))
    assert np.array_equal(ps.count_matches_pattern_sharded(m, payloads, lengths, pmesh,
                                                           engine=engine), want)
    want_rows = np.asarray(jps.count_rows_pattern_sharded(jm, payloads, lengths, jmesh,
                                                          engine=engine))
    assert np.array_equal(ps.count_rows_pattern_sharded(m, payloads, lengths, pmesh,
                                                        engine=engine), want_rows)


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("engine", ["window", "pallas"])
def test_summary_equals_jax(engine, n_shards):
    rng = np.random.default_rng(62)
    m, jm = _both(_mk_patterns(rng, 23))
    payloads, lengths = _mk_batch(rng, n=32, L=128)
    jt, jh = jps.count_rows_summary_pattern_sharded(jm, payloads, lengths, _jmesh(n_shards),
                                                    engine=engine)
    tot, hits = ps.count_rows_summary_pattern_sharded(m, payloads, lengths, _pmesh(n_shards),
                                                      engine=engine)
    assert tot.dtype == np.int64 and np.array_equal(tot, np.asarray(jt))
    assert np.array_equal(hits, np.asarray(jh)) and 0 < hits.sum() < 32
    rows = count_matches_window(m.window, payloads, lengths, per_packet=True,
                                expand_duplicates=False).numpy()
    assert np.array_equal(tot, rows.sum(axis=0)) and np.array_equal(hits, rows.sum(axis=1) > 0)


def test_summary_slices_big_feeds_like_jax(monkeypatch):
    from multithreading_string_matching_tpu.parallel import mesh as jmesh_mod
    from multithreading_string_matching_tpu_torch.parallel import mesh as mesh_mod

    rng = np.random.default_rng(70)
    m, jm = _both(_mk_patterns(rng, 11))
    payloads, lengths = _mk_batch(rng, n=29, L=64)
    want = ps.count_rows_summary_pattern_sharded(m, payloads, lengths, ps.make_2d_mesh(
        2, 2, ["cpu"] * 4), engine="pallas")
    for mod in (mesh_mod, jmesh_mod):
        monkeypatch.setattr(mod, "SUMMARY_MAX_POSITIONS", 5 * 64)  # ~4-row slices
    got = ps.count_rows_summary_pattern_sharded(m, payloads, lengths, ps.make_2d_mesh(
        2, 2, ["cpu"] * 4), engine="pallas")
    jt, jh = jps.count_rows_summary_pattern_sharded(jm, payloads, lengths, jps.make_2d_mesh(
        2, 2, jax.devices()[:4]), engine="window")
    for a, b in ((got[0], want[0]), (got[0], np.asarray(jt)), (got[1], want[1]),
                 (got[1], np.asarray(jh))):
        assert np.array_equal(a, b)
    monkeypatch.setattr(mesh_mod, "SUMMARY_MAX_POSITIONS", 64)
    with pytest.raises(ValueError, match="int32 bound"):
        ps.count_rows_summary_pattern_sharded(m, payloads, lengths, ps.make_2d_mesh(
            2, 1, ["cpu"] * 2))


@pytest.mark.parametrize("zero_fill", [True, False])
def test_nul_patterns_use_fit(zero_fill):
    """NUL sets: exact fit masks; the port's kernels apply the fit mask
    always, so rows not zero-filled past their length count right too."""
    rng = np.random.default_rng(63)
    pats = [b"a\x00b", b"\x00\x00", b"ab", b"ba"]
    m, jm = _both(pats)
    payloads, lengths = _mk_batch(rng, n=16, L=64, alphabet=(0x61, 0x63))
    payloads[0, :4] = [0x61, 0x00, 0x62, 0x00]
    payloads[1, :4] = [0x00, 0x00, 0x00, 0x61]
    lengths[:2] = np.maximum(lengths[:2], 8)
    if not zero_fill:
        payloads[:, -8:] = 0x61
    want = np.asarray(jm.count(payloads, lengths, engine="window"))
    assert want[0] > 0 and want[1] > 0
    for engine in ("window", "pallas"):
        got = ps.count_matches_pattern_sharded(m, payloads, lengths, _pmesh(4), engine=engine)
        assert np.array_equal(got, want), engine
        if zero_fill:
            assert np.array_equal(got, np.asarray(jps.count_matches_pattern_sharded(
                jm, payloads, lengths, _jmesh(4), engine=engine)))


def test_more_shards_than_patterns():
    """8 shards of 3 patterns: shards 3-7 are empty blocks; the summary's
    hit flags still ignore every padded slot."""
    rng = np.random.default_rng(64)
    m, jm = _both([b"ab", b"cd", b"abc"])
    payloads, lengths = _mk_batch(rng, n=8, L=64, alphabet=(0x61, 0x65))
    want = np.asarray(jps.count_matches_pattern_sharded(jm, payloads, lengths, _jmesh(8)))
    got = ps.count_matches_pattern_sharded(m, payloads, lengths, _pmesh(8))
    assert np.array_equal(got, want) and np.array_equal(got, m.count(payloads, lengths))
    plan = ps.build_pattern_shards(m.window, 8)
    assert [plan.valid(d) for d in range(8)] == [1, 1, 1, 0, 0, 0, 0, 0]
    tot, hits = ps.count_rows_summary_pattern_sharded(m, payloads, lengths, _pmesh(8))
    jt, jh = jps.count_rows_summary_pattern_sharded(jm, payloads, lengths, _jmesh(8))
    assert np.array_equal(tot, np.asarray(jt)) and np.array_equal(hits, np.asarray(jh))


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_plan_arrays_equal_jax(n_shards, filtered):
    rng = np.random.default_rng(71 + n_shards)
    pats = _mk_patterns(rng, 40, lens=(1, 13)) + [b"a\x00b"]
    wp, jwp = WindowProgram.build(pats), JaxMatcher(pats).window
    plan = ps.build_pattern_shards(wp, n_shards, filtered=filtered)
    jplan = jps.build_pattern_shards(jwp, n_shards, filtered=filtered)
    for carried in (plan, ps.plan_from_reference(jplan)):
        for f in ("words", "masks", "lens"):
            got, want = getattr(carried, f), getattr(jplan, f)
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        for f in ("n_shards", "S", "C", "U", "K", "use_fit", "filtered"):
            assert getattr(carried, f) == getattr(jplan, f), f
        full = np.arange(n_shards * plan.S)
        assert np.array_equal(carried.gather(full), jplan.gather(full))


def test_plan_geometry_equals_jax():
    for C in [0, 1, 2, 15, 16, 17, 100, 127, 128, 129, 255, 256, 1000, 1024, 3072]:
        assert plan_shard_geometry(C) == jpt.plan_shard_geometry(C), C


def test_plan_from_reference_refuses_inconsistent_fields():
    import dataclasses

    jplan = jps.build_pattern_shards(JaxMatcher([b"ab", b"cde", b"fghij"]).window, 2)
    plan = ps.plan_from_reference(jplan)
    assert np.array_equal(plan.gather(np.arange(2 * plan.S)), [0, 1, jplan.S])
    for bad in (dict(words=jplan.words[:, :1]), dict(lens=jplan.lens[:-1]), dict(C=1),
                dict(filtered=True), dict(n_shards=3)):
        with pytest.raises(ValueError):
            ps.plan_from_reference(dataclasses.replace(jplan, **bad))


def test_filtered_tables_match_plain(monkeypatch):
    """The filter column changes nothing about the counts; both forms equal
    the JAX package's."""
    rng = np.random.default_rng(65)
    m, jm = _both(_mk_patterns(rng, 40, lens=(4, 12)))
    payloads, lengths = _mk_batch(rng, n=16, L=128)
    want = np.asarray(jm.count(payloads, lengths, engine="window"))
    got_filt = ps.count_matches_pattern_sharded(m, payloads, lengths, _pmesh(4), engine="pallas")
    monkeypatch.setenv("MSM_PALLAS_FILTER", "0")
    got_plain = ps.count_matches_pattern_sharded(m, payloads, lengths, _pmesh(4), engine="pallas")
    jgot = np.asarray(jps.count_matches_pattern_sharded(jm, payloads, lengths, _jmesh(4),
                                                        engine="pallas"))
    assert np.array_equal(got_plain, want) and np.array_equal(got_filt, want)
    assert np.array_equal(jgot, want)
    assert set(m._pattern_shard_plans) == {"_wp", (4, True), (4, False)}


def test_ac_kmp_remap_and_bad_engine():
    """engine='ac'/'kmp', and a matcher built with engine='ac' or 'kmp',
    count on the window family (the matcher itself counts them with its
    DFA scans, to the same counts); a bogus engine raises ValueError."""
    rng = np.random.default_rng(66)
    payloads, lengths = _mk_batch(rng, n=8, L=64)
    m, jm = _both([b"ab", b"bc"])
    want = np.asarray(jm.count(payloads, lengths, engine="ac"))
    for engine in ("ac", "kmp", "auto", None):
        got = ps.count_matches_pattern_sharded(m, payloads, lengths, _pmesh(2), engine=engine)
        assert np.array_equal(got, want), engine
        assert ps._resolve_engine(m, engine) == "pallas"
    for own in ("ac", "kmp"):
        mo, jmo = _both([b"ab", b"bc"], engine=own)
        assert ps._resolve_engine(mo, None) == jps._resolve_engine(jmo, None) == "window"
        got = ps.count_matches_pattern_sharded(mo, payloads, lengths, _pmesh(2))
        assert np.array_equal(got, want), own
        assert np.array_equal(mo.count(payloads, lengths), want), own
    with pytest.raises(ValueError, match="pattern-shard engine"):
        ps.count_matches_pattern_sharded(m, payloads, lengths, _pmesh(2), engine="bogus")


def test_nocase_folds():
    m, jm = _both([b"AbC", b"xyz"], case_insensitive=True)
    payloads = np.zeros((4, 64), np.uint8)
    payloads[0, :6] = np.frombuffer(b"aBcXYZ", np.uint8)
    lengths = np.array([6, 0, 0, 0], np.int32)
    want = np.asarray(jps.count_matches_pattern_sharded(jm, payloads, lengths, _jmesh(2)))
    got = ps.count_matches_pattern_sharded(m, payloads, lengths, _pmesh(2))
    assert np.array_equal(got, want) and got.tolist() == [1, 1]
    rows = ps.count_rows_pattern_sharded(m, payloads, lengths, _pmesh(2))
    assert rows.tolist() == [[1, 1], [0, 0], [0, 0], [0, 0]]


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_choose_shard_axis_equals_jax(n_dev, monkeypatch):
    rng = np.random.default_rng(68)
    small = [b"ab", b"cd"]
    big = _mk_patterns(rng, 700, lens=(8, 9))
    uniform = [b"u%07d" % i for i in range(200)]  # one class of 2 words, 400 words
    for pats in (small, big, uniform):
        m, jm = _both(pats)
        assert ps.choose_shard_axis(m, n_dev) == jps.choose_shard_axis(jm, n_dev)
    assert ps.choose_shard_axis(Matcher(big, device="cpu"), n_dev) == (
        "patterns" if n_dev > 1 else "packets")
    monkeypatch.setenv("MSM_PALLAS_TABLE", "1")
    m, jm = _both(small)
    assert ps.choose_shard_axis(m, n_dev) == jps.choose_shard_axis(jm, n_dev)


def test_gather_roundtrip():
    rng = np.random.default_rng(69)
    wp = WindowProgram.build(_mk_patterns(rng, 13))
    plan = ps.build_pattern_shards(wp, 4)
    U = wp.pat_words.shape[0]
    full = np.full(plan.n_shards * plan.S, -1, np.int64)
    for u in range(U):
        d, slot = plan.shard_of_unique(u)
        full[d * plan.S + slot] = 1000 + u
    assert np.array_equal(plan.gather(full), 1000 + np.arange(U))


def test_swap_patterns_twice_serves_new_tables():
    """Two swaps in a row: every count after a swap uses the new set's
    tables (the staged tables of dropped plans go with them), equal to a
    fresh matcher's and to the JAX package's after the same swaps."""
    rng = np.random.default_rng(72)
    sets = [_mk_patterns(rng, 30, lens=(3, 9)) for _ in range(3)]
    payloads, lengths = _mk_batch(rng, n=24, L=128)
    m, jm = _both(sets[0])
    for k, pats in enumerate(sets):
        if k:
            m.swap_patterns(pats)
            jm.swap_patterns(pats)
        for mesh, jmesh in ((_pmesh(4), _jmesh(4)), (ps.make_2d_mesh(2, 2, ["cpu"] * 4),
                                                     jps.make_2d_mesh(2, 2, jax.devices()[:4]))):
            got = ps.count_matches_pattern_sharded(m, payloads, lengths, mesh, engine="pallas")
            fresh = Matcher(pats, device="cpu").count(payloads, lengths)
            want = np.asarray(jps.count_matches_pattern_sharded(jm, payloads, lengths, jmesh,
                                                                engine="window"))
            assert np.array_equal(got, fresh) and np.array_equal(got, want), k
        staged = m._pattern_shard_staged
        plans = list(m._pattern_shard_plans.values())
        assert staged and all(any(e[0] is p for p in plans) for e in staged.values())


# -- the shard kernels' plain versions against the JAX ShardTableKernel -----

# name: (patterns, n_shards, seed, rows, width, alphabet)
KERNEL_CASES = {
    "padded-slots": ([b"abc", b"bcab", b"cabca", b"ab"], 1, 80, 16, 128, b"abc"),
    "short-in-k8": ([b"a", b"ab", b"abc", b"abcabcabcabcabcabcabcabcabcabca"], 1, 81, 16, 64,
                    b"abc"),
    "mixed-1-32": (None, 2, 82, 16, 64, b"abc"),
}


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_shard_kernel_plain_equals_jax_interpret(case, filtered):
    pats, n_sh, seed, n, L, alphabet = KERNEL_CASES[case]
    rng = np.random.default_rng(seed)
    if pats is None:
        pats = list(dict.fromkeys(
            bytes(rng.integers(97, 100, size=rng.integers(1, 33)).tolist()) for _ in range(24)))
    letters = np.frombuffer(alphabet, np.uint8)
    payloads = letters[rng.integers(0, len(letters), size=(n, L))]
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    payloads = np.where(np.arange(L)[None] < lengths[:, None], payloads, 0).astype(np.uint8)
    plan = ps.build_pattern_shards(WindowProgram.build(pats), n_sh, filtered=filtered)
    jplan = jps.build_pattern_shards(JaxMatcher(pats).window, n_sh, filtered=filtered)
    jk = jpt.ShardTableKernel(jplan.K, jplan.S, jplan.use_fit, filtered, interpret=True,
                              row_tile=16)
    kern = ct.ShardTableKernel(plan.K, plan.S, plan.use_fit, filtered, "cpu")
    p, ln = torch.from_numpy(payloads), torch.from_numpy(lengths)
    before = dict(ct.LAUNCHES)
    for d in range(n_sh):
        rows = slice(d * plan.S, (d + 1) * plan.S)
        tabs = [torch.from_numpy(np.ascontiguousarray(a[rows]).view(np.int32))
                for a in (plan.words, plan.masks)] + [torch.from_numpy(plan.lens[rows])]
        jtabs = [jnp.asarray(a[rows]) for a in (jplan.words, jplan.masks, jplan.lens)]
        valid = plan.valid(d)
        got = kern.counts(*tabs, p, ln).numpy()
        want = np.asarray(jk.counts(*jtabs, jnp.asarray(payloads), jnp.asarray(lengths)))
        assert got.shape == (plan.S,) and np.array_equal(got[:valid], want[:valid])
        assert not got[valid:].any()  # padded slots count 0
        got_rows = kern.rows(*tabs, p, ln).numpy()
        want_rows = np.asarray(jk.rows(*jtabs, jnp.asarray(payloads), jnp.asarray(lengths)))[:n]
        assert np.array_equal(got_rows[:, :valid], want_rows[:, :valid])
        assert np.array_equal(got_rows.sum(axis=0), got) and not got_rows[:, valid:].any()
    assert ct.LAUNCHES == before  # the plain version is not a launch
    assert plan.K == (8 if case != "padded-slots" else 2)


def test_shard_kernel_refuses_bad_blocks():
    with pytest.raises(ValueError, match="1..512"):
        ct.ShardTableKernel(0, 16, False, False, "cpu")
    kern = ct.ShardTableKernel(2, 16, False, True, "cpu")
    w = torch.zeros((16, 3), dtype=torch.int32)
    p, ln = torch.zeros((2, 8), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32)
    assert kern.counts(w, w, torch.zeros((16, 1), dtype=torch.int32), p, ln).shape == (16,)
    with pytest.raises(ValueError, match=r"\[16, 3\]"):
        kern.counts(w[:, :2], w[:, :2], torch.zeros(16, dtype=torch.int32), p, ln)
    with pytest.raises(ValueError, match="lens"):
        kern.rows(w, w, torch.zeros(15, dtype=torch.int32), p, ln)
