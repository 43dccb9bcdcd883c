"""The torch package's packet-axis mesh against the JAX package's
``parallel/mesh.py``: sharded totals, per-row counts and summaries (sliced
feeds too), ``shard_batch``, the table route's build order, sharded flow
rounds, and the refusal of the AC engine.

JAX runs on its 8-device CPU mesh; the port runs CPU meshes of the same
shard counts.  Inputs are made from seeds with numpy; counts are integers,
so every comparison is exact (tolerance 0).
"""

import jax
import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.ops.pallas_table import PallasTableMatcher
from multithreading_string_matching_tpu.ops.pallas_window import PallasWindowMatcher
from multithreading_string_matching_tpu.parallel import mesh as jmesh
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
from multithreading_string_matching_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

PATS = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"abcdefgh", b"abcde", b"a\x00b", b"bca"]
# Mixed word counts in unsorted order, so a class permutation would show.
TABLE_PATS = [b"abcdefghi", b"xy", b"abcd", b"hello", b"zq", b"xy"]


def _batch(seed, n, L, alphabet=b"abc\x00", pats=(), zero_fill=True):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    payloads = letters[rng.integers(0, len(letters), size=(n, L))]
    for r in range(n):
        for p in pats[r % max(len(pats), 1):][:1]:
            o = int(rng.integers(0, L - len(p) + 1))
            payloads[r, o:o + len(p)] = np.frombuffer(p, np.uint8)
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    if zero_fill:
        payloads = np.where(np.arange(L)[None] < lengths[:, None], payloads, 0).astype(np.uint8)
    return payloads, lengths


def _meshes(n):
    return jmesh.make_mesh(jax.devices("cpu")[:n]), pmesh.make_mesh(["cpu"] * n)


@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
@pytest.mark.parametrize("engine", ["window", "pallas"])
def test_count_matches_sharded_equals_jax(engine, ndev):
    payloads, lengths = _batch(1, 61, 96, pats=PATS)
    m, jm = Matcher(PATS, device="cpu"), JaxMatcher(PATS)
    jm_mesh, pm_mesh = _meshes(ndev)
    jkw, pkw = dict(window=jm.window), dict(window=m.window)
    if engine == "pallas":
        jkw["pallas_matcher"] = PallasWindowMatcher(jm.window, row_tile=16, interpret=True,
                                                    assume_zero_padded=True)
        pkw["pallas_matcher"] = cw.CudaWindowMatcher(m.window, "cpu")
    want = np.asarray(jmesh.count_matches_sharded(jm.cac, payloads, lengths, jm_mesh,
                                                  dup_map=jm.window.dup_map, engine=engine, **jkw))
    got = pmesh.count_matches_sharded(None, payloads, lengths, pm_mesh,
                                      dup_map=m.window.dup_map, engine=engine, **pkw)
    assert got.dtype == np.int32 and np.array_equal(got, want) and got.sum() > 0
    assert np.array_equal(got, m.count(payloads, lengths))


@pytest.mark.parametrize("ndev", [2, 8])
def test_table_route_build_order(monkeypatch, ndev):
    """The table kernels count class by class; the sharded totals come back
    in build order (the JAX package's test_parallel.py:74 case)."""
    monkeypatch.setenv("MSM_PALLAS_TABLE", "1")
    m, jm = Matcher(TABLE_PATS, device="cpu"), JaxMatcher(TABLE_PATS)
    rng = np.random.default_rng(7)
    payloads = rng.integers(1, 255, size=(64, 128)).astype(np.uint8)
    for i, p in enumerate(TABLE_PATS):
        for j in range(i + 1):  # pattern i appears in i+1 rows
            payloads[(3 * i + 5 * j) % 64, 8 * i : 8 * i + len(p)] = np.frombuffer(p, np.uint8)
    lengths = np.full(64, 128, np.int32)
    assert isinstance(m.kernels, ct.CudaTableMatcher)
    jm_mesh, pm_mesh = _meshes(ndev)
    want = np.asarray(jmesh.count_matches_sharded(
        jm.cac, payloads, lengths, jm_mesh, dup_map=jm.window.dup_map, engine="pallas",
        pallas_matcher=PallasTableMatcher(jm.window, row_tile=32, interpret=True,
                                          assume_zero_padded=True)))
    got = pmesh.count_matches_sharded(None, payloads, lengths, pm_mesh,
                                      dup_map=m.window.dup_map, engine="pallas",
                                      pallas_matcher=m.kernels)
    assert np.array_equal(got, want) and len(set(got.tolist())) > 3
    assert np.array_equal(got, m.count(payloads, lengths, engine="window"))


@pytest.mark.parametrize("table", ["0", "1"])
@pytest.mark.parametrize("engine", ["window", "pallas"])
def test_count_rows_sharded_equals_jax(monkeypatch, engine, table):
    monkeypatch.setenv("MSM_PALLAS_TABLE", table)
    payloads, lengths = _batch(2, 37, 64, pats=PATS)
    m, jm = Matcher(PATS, device="cpu"), JaxMatcher(PATS)
    want = np.asarray(jmesh.count_rows_sharded(jm, payloads, lengths, _meshes(4)[0],
                                               engine="window"))
    for ndev in (1, 4, 8):
        got = pmesh.count_rows_sharded(m, payloads, lengths, _meshes(ndev)[1], engine=engine)
        assert got.shape == (37, len(PATS)) and np.array_equal(got, want), ndev
    assert isinstance(m.kernels, ct.CudaTableMatcher if table == "1" else cw.CudaWindowMatcher)


@pytest.mark.parametrize("engine", ["window", "pallas"])
def test_count_rows_summary_equals_jax(engine, monkeypatch):
    payloads, lengths = _batch(3, 45, 64, pats=PATS)
    m, jm = Matcher(PATS, device="cpu", case_insensitive=True), JaxMatcher(
        PATS, case_insensitive=True)
    want_t, want_h = jmesh.count_rows_summary(jm, payloads, lengths, _meshes(8)[0],
                                              engine="window")
    for ndev in (2, 8):
        tot, hits = pmesh.count_rows_summary(m, payloads, lengths, _meshes(ndev)[1],
                                             engine=engine)
        assert tot.dtype == np.int64 and np.array_equal(tot, np.asarray(want_t))
        assert np.array_equal(hits, np.asarray(want_h)) and 0 < hits.sum() < 45
    # Sliced feeds: the bound lowered to ~4 rows of 64 positions per slice.
    for mod in (pmesh, jmesh):
        monkeypatch.setattr(mod, "SUMMARY_MAX_POSITIONS", 4 * 64 + 1)
    tot, hits = pmesh.count_rows_summary(m, payloads, lengths, _meshes(2)[1], engine=engine)
    jt, jh = jmesh.count_rows_summary(jm, payloads, lengths, _meshes(2)[0], engine="window")
    assert np.array_equal(tot, np.asarray(want_t)) and np.array_equal(tot, np.asarray(jt))
    assert np.array_equal(hits, np.asarray(want_h)) and np.array_equal(hits, np.asarray(jh))
    monkeypatch.setattr(pmesh, "SUMMARY_MAX_POSITIONS", 64)
    with pytest.raises(ValueError, match="int32 bound"):
        pmesh.count_rows_summary(m, payloads, lengths, _meshes(2)[1])


@pytest.mark.parametrize("n", [0, 1, 7, 8, 13])
def test_shard_batch_equals_jax(n):
    payloads, lengths = _batch(4, n, 16)
    for ndev in (1, 3, 8):
        jm_mesh, pm_mesh = _meshes(ndev)
        got = pmesh.shard_batch(payloads, lengths, pm_mesh)
        want = jmesh.shard_batch(payloads, lengths, jm_mesh)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _round_tile(seed, pats, R, C):
    """A sub-lane round tile ``[halo | bytes]`` with random fills and
    lengths, planted patterns, bytes past a row's length not zero."""
    H = max(max(map(len, pats)) - 1, 1)
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abc\x00", np.uint8)
    x = letters[rng.integers(0, len(letters), size=(R, H + C))]
    for r in range(R):
        p = pats[r % len(pats)]
        o = int(rng.integers(0, H + C - len(p) + 1))
        x[r, o:o + len(p)] = np.frombuffer(p, np.uint8)
    eff = np.minimum(rng.integers(0, C + 1, size=R) + H, H + C).astype(np.int32)
    eff[::5] = 0
    ms = (H - rng.integers(0, H + 1, size=R)).astype(np.int32)
    return x, eff, ms


@pytest.mark.parametrize("ndev", [1, 3, 8])
@pytest.mark.parametrize("engine", ["window", "pallas"])
def test_count_flow_round_sharded_equals_jax(engine, ndev):
    x, eff, ms = _round_tile(5, PATS, 29, 40)
    m, jm = Matcher(PATS, device="cpu"), JaxMatcher(PATS, engine="window")
    want = np.asarray(jmesh.count_flow_round_sharded(jm, x, eff, ms, _meshes(8)[0],
                                                     engine="window"))
    before = dict(cw.LAUNCHES)
    got = pmesh.count_flow_round_sharded(m, x, eff, ms, _meshes(ndev)[1], engine=engine)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want) and want.sum() > 0
    assert cw.LAUNCHES == before  # CPU shards take the plain version


def test_ac_engine_and_count_chunk_sharded_raise():
    """The AC engine and the sharded carried-state chunk (once refused here)
    give the JAX package's counts and states; the guards raise."""
    payloads, lengths = _batch(6, 8, 16, pats=PATS)
    m, jm = Matcher(PATS, device="cpu"), JaxMatcher(PATS)
    jmesh2, mesh = _meshes(2)
    want = np.asarray(jmesh.count_matches_sharded(jm.cac, payloads, lengths, jmesh2,
                                                  dup_map=jm.ac.dup_map))
    assert want.sum() > 0
    for engine in ("ac", "kmp"):
        got = pmesh.count_matches_sharded(m.cac, payloads, lengths, mesh, engine=engine,
                                          dup_map=m.ac.dup_map)
        assert np.array_equal(got, want), engine
    got = pmesh.count_matches_sharded(m.cac, payloads, lengths, mesh, dup_map=m.ac.dup_map)
    assert np.array_equal(got, want)  # the JAX default, ac
    states = np.random.default_rng(2).integers(0, m.cac.num_states, 8).astype(np.int32)
    jc, js = jmesh.count_chunk_sharded(jm.cac, payloads, lengths - 5, states, jmesh2)
    pc, ps_ = pmesh.count_chunk_sharded(m.cac, payloads, lengths - 5, states, mesh)
    assert np.array_equal(pc.numpy(), np.asarray(jc)) and np.array_equal(ps_.numpy(),
                                                                          np.asarray(js))
    with pytest.raises(ValueError, match="cac"):
        pmesh.count_matches_sharded(None, payloads, lengths, mesh)
    with pytest.raises(ValueError, match="pallas_matcher"):
        pmesh.count_matches_sharded(None, payloads, lengths, mesh, engine="pallas")
    with pytest.raises(ValueError, match="window"):
        pmesh.count_matches_sharded(None, payloads, lengths, mesh, engine="window")
    with pytest.raises(ValueError, match="bogus"):
        pmesh.count_matches_sharded(None, payloads, lengths, mesh, engine="bogus")


def test_mesh_object_and_default_devices():
    mesh = pmesh.make_mesh(device_type="cpu")
    assert mesh.axis_names == ("packets",) and mesh.shape == {"packets": 1}
    assert mesh.devices.shape == (1,) and mesh.devices.flat[0] == torch.device("cpu")
    assert pmesh.make_mesh(["cpu"] * 3) == pmesh.Mesh(np.array(["cpu"] * 3, dtype=object),
                                                      ("packets",))
    assert len({pmesh.make_mesh(["cpu"] * 3), pmesh.make_mesh(["cpu"] * 3)}) == 1
    assert pmesh.make_mesh(["cpu"] * 3) != pmesh.make_mesh(["cpu"] * 2)
    with pytest.raises(ValueError):
        pmesh.Mesh([], ("packets",))
    with pytest.raises(ValueError):
        pmesh.Mesh(["cpu", "cpu"], ("packets", "patterns"))
    with pytest.raises(ValueError, match="one type"):
        pmesh.Mesh(["cpu", "meta"], ("packets",))
    with pytest.raises(ValueError, match="device type"):
        pmesh.default_devices("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.make_mesh()  # cuda is the default, and never falls back


def test_surface_copies_per_device_follow_swaps():
    """A mesh shard on another device gets its own copy of the kernels'
    tables, made once, and made again after ``swap_tables``."""
    m = Matcher([b"rs%06d" % i for i in range(600)], device="cpu")
    kern = m.kernels
    assert isinstance(kern, ct.CudaTableMatcher) and kern.on_device("cpu") is kern
    copy = kern.on_device("cpu:0")
    assert copy is not kern and kern.on_device(torch.device("cpu", 0)) is copy
    assert copy.device == torch.device("cpu", 0) and copy.wp is kern.wp
    payloads, lengths = _batch(8, 8, 32, alphabet=b"rs0123")
    assert m.swap_patterns([b"rs%06d" % (i + 7) for i in range(600)])
    assert m.kernels is kern and kern.on_device("cpu:0") is not copy
    mesh = pmesh.make_mesh(["cpu", "cpu:0"])
    got = pmesh.count_matches_sharded(None, payloads, lengths, mesh, dup_map=m.window.dup_map,
                                      engine="pallas", pallas_matcher=m.kernels)
    assert np.array_equal(got, m.count(payloads, lengths, engine="window"))
    win = cw.CudaWindowMatcher(m.window, "cpu")
    assert win.on_device("cpu") is win and win.on_device("cpu:0").wp is win.wp
    assert cw.canonical_device("cuda") == torch.device("cuda", 0)
