"""The torch package's matrix-unit matcher (ops/mxu.py) and its measurement
entry point (tools/mxu_match.py) against ``bench/mxu_match.py``, on the CPU.

``bench/mxu_match.py`` is loaded by path; its ``MxuMatcher`` runs the Pallas
kernel in interpret mode.  Counts are integers: every comparison is exact
(tolerance 0).  The kernel itself is held against the plain version on the
card in tests/test_torch_kernels.py.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.ops import mxu
from multithreading_string_matching_tpu_torch.ops.cuda_table import CudaTableMatcher
from multithreading_string_matching_tpu_torch.tools import mxu_match
from oracle import oracle_counts

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref():
    """``bench/mxu_match.py`` as a module (its ``main`` is not run)."""
    assert jax.default_backend() == "cpu"
    spec = importlib.util.spec_from_file_location("bench_mxu_match", REPO / "bench" / "mxu_match.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _planted(pats, seed, n, L, alphabet=b"abcdefghijklmnopqrstuvwxyz"):
    """Rows of ``alphabet`` with patterns planted, zero past random lengths."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    x = letters[rng.integers(0, len(letters), size=(n, L))]
    for _ in range(3 * n):
        p = pats[int(rng.integers(0, len(pats)))]
        if len(p) <= L:
            r, o = int(rng.integers(0, n)), int(rng.integers(0, L - len(p) + 1))
            x[r, o : o + len(p)] = np.frombuffer(p, np.uint8)
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    x[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return x, lengths


def _packed_tile(pats):
    x, lengths = _planted(pats, 7, 40, 60)
    prep = Matcher(pats, device="cpu").prepare(x, lengths, packed=True, pack_width=256)
    (tile,) = prep.tiles
    assert prep.packed
    return tile[0].numpy(), tile[1].numpy()


# name: (patterns, tile maker)
CASES = {
    "width-200": ([b"ab", b"xyz", b"q"], lambda p: _planted(p, 1, 16, 200)),
    "rows-13-u129": ([b"ab%d" % i for i in range(129)], lambda p: _planted(p, 2, 13, 130)),
    "one-and-32-byte": ([b"a", b"qr" * 16], lambda p: _planted(p, 3, 3, 100, b"aqr")),
    "packed": ([b"abc", b"cab", b"b"], _packed_tile),
}


def test_bit_tables_equal_jax(ref):
    for pats in ([b"ab", b"xyz", b"q"], [b"\xff\x01" * 40], [b"pt%06d" % i for i in range(300)]):
        got, want = mxu.bit_tables(pats), ref._bit_tables(pats)
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_equal_jax_interpret(ref, case):
    pats, make = CASES[case]
    x, lengths = make(pats)
    want = np.asarray(ref.MxuMatcher(pats, interpret=True).count_tiles_repeated([(x, lengths)], 3))
    m = mxu.MxuMatcher(pats, device="cpu")
    before = dict(mxu.LAUNCHES)
    got = m.count_tiles([(x, lengths)])
    assert got.dtype == torch.int32 and got.shape == (len(pats),)
    assert np.array_equal(3 * got.numpy(), want) and want.sum() > 0
    assert np.array_equal(m.count_tiles_repeated([(x, lengths)], 3).numpy(), want)
    assert mxu.LAUNCHES == before  # the CPU runs the plain version


def test_plain_counts_every_position_of_the_width():
    """Positions whose window runs past the width read zero bytes; a tile of
    zero rows counts nothing; totals over tiles add up."""
    pats = [b"ab", b"b", b"ba"]
    P, tgt, m_max = mxu.bit_tables(pats)
    P, tgt = torch.from_numpy(P), torch.from_numpy(tgt)
    x = torch.tensor([[97, 98, 97, 98], [98, 97, 0, 0]], dtype=torch.uint8)
    assert mxu.mxu_count_plain(P, tgt, m_max, x)[:3].tolist() == [2, 3, 2]
    assert mxu.mxu_count(x, P, tgt, reps=2)[:3].tolist() == [4, 6, 4]
    assert not mxu.mxu_count_plain(P, tgt, m_max, x[:0]).any()
    m = mxu.MxuMatcher(pats, device="cpu")
    assert m.count_tiles([(x, None), (x[:0], None), (x[1:], None)]).tolist() == [2, 4, 3]


@pytest.fixture(scope="module")
def corpus():
    return mxu_match.corpus(200)


@pytest.mark.parametrize("set_name", ["standin", "pt768"])
def test_counts_equal_oracle_and_table_on_tool_corpus(corpus, set_name):
    pats = dict(mxu_match.pattern_sets())[set_name]
    m = Matcher(pats, device="cpu")
    prep = m.prepare_batch(corpus, packed="auto")
    got = mxu.MxuMatcher(pats, device="cpu").count_tiles(prep.tiles).numpy()
    table = CudaTableMatcher(m.window, "cpu", assume_zero_padded=True)
    assert np.array_equal(got, table.count_tiles(prep.tiles, expand_duplicates=False).numpy())
    payloads = [corpus.payloads[r, : corpus.lengths[r]].tobytes()
                for r in range(corpus.payloads.shape[0]) if corpus.valid[r]]
    assert got.tolist() == oracle_counts(payloads, pats)
    assert got.sum() > 0


def test_refuses_nul_long_and_empty_sets():
    for pats in ([b"a\x00b"], [b"ab", b"\x00"]):
        with pytest.raises(ValueError, match="NUL"):
            mxu.MxuMatcher(pats, device="cpu")
    with pytest.raises(ValueError):
        mxu.MxuMatcher([b"a" * 100], device="cpu")
    with pytest.raises(ValueError):
        mxu.MxuMatcher([], device="cpu")


def test_cuda_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mxu.MxuMatcher([b"ab"], device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mxu.MxuMatcher([b"ab"])  # cuda is the default
    env = dict(os.environ, MSM_DEVICE="cuda")
    r = subprocess.run([sys.executable, "-m", "multithreading_string_matching_tpu_torch.tools.mxu_match",
                        "--packets", "10"], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and not r.stdout


def test_tool_on_cpu_prints_three_agreeing_rows():
    env = dict(os.environ, MSM_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-m", "multithreading_string_matching_tpu_torch.tools.mxu_match",
                        "--device", "cpu", "--packets", "200"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    rows = [json.loads(line) for line in r.stdout.splitlines()]
    assert [row["patterns"] for row in rows] == [87, 768, 3072]
    assert all(row["device"] == "cpu" and "mxu_bytes_per_sec" not in row for row in rows)
    # pt000000 is planted; the two pt sets hold it, and nothing else occurs.
    assert rows[1]["matches"] == rows[2]["matches"] > 0
