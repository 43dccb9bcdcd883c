"""Match attribution at the ordered find kernel's hard cases, on the CPU.

``Matcher(device="cpu").find_matches`` (the plain version of
``window_find``) against the JAX package's ``Matcher.find_matches`` on the
cases the one-pass kernel (``csrc/window_find.cu``) has to get right: many
patterns matching at one position, a pattern whose bytes would complete
across a row boundary of the flattened tile, rows whose length exceeds the
width with NUL-tailed patterns, widths that are not a multiple of 16 found
in row slices that start at unaligned offsets, and rows of length 0.  Then
the wrapper's capacity logic (``cuda_window.find_with_capacity``) with a
fake launch, and a numpy model of the kernel's order: flat tiles, warp
steps, tile prefixes, and chunked sets written in reverse chunk order.

Inputs are seeded numpy arrays handed to both packages; results are integer
triples: every comparison is exact (tolerance 0).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
from multithreading_string_matching_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
NUL_SET = [b"\x00", b"A\x00", b"\x00\x00", b"AA\x00\x00", b"A\x00\x00\x00\x00"]


def _both(pats, payloads, lengths):
    got = Matcher(pats, device="cpu").find_matches(payloads, lengths)
    want = np.asarray(JaxMatcher(pats).find_matches(payloads, lengths))
    assert got.dtype == np.int64 and got.shape[1:] == (3,)
    assert np.array_equal(got, want)
    return got


def _dense(name):
    rng = np.random.default_rng(sum(name.encode()))
    if name == "all-A":
        p = np.full((9, 37), ord("A"), np.uint8)
        return [b"A", b"AA", b"AAA"], p, np.full(9, 37, np.int32)
    if name == "all-A-ragged-nul":
        p = np.full((11, 29), ord("A"), np.uint8)
        p[:, 20:] = 0
        return [b"AAA", b"A", b"AA"] + NUL_SET, p, rng.integers(0, 33, 11).astype(np.int32)
    if name == "many-at-one-position":
        pats = [b"ab" * k for k in range(1, 9)] + [b"a", b"aba", b"abab" + b"a"]
        p = np.frombuffer(b"ab" * 40, np.uint8)[None].repeat(6, 0).copy()
        return pats, p, np.array([80, 79, 17, 0, 3, 80], np.int32)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["all-A", "all-A-ragged-nul", "many-at-one-position"])
def test_dense_positions_equal_jax(name):
    pats, p, lens = _dense(name)
    got = _both(pats, p, lens)
    key = got[:, 0] * p.shape[1] + got[:, 1]
    assert len(got) > 2 * p.shape[0] and (np.diff(key) == 0).any()


@pytest.mark.parametrize("L", [7, 13, 16, 31])
def test_no_match_across_a_row_boundary(L):
    """Each row ends with a pattern's head and the next row starts with its
    tail: contiguous in the flattened tile, never a match."""
    pats = [b"wxyz", b"vwxyz1", b"z1"]
    rng = np.random.default_rng(L)
    p = rng.integers(ord("a"), ord("f"), size=(8, L)).astype(np.uint8)
    for r in range(7):
        k = 1 + r % 3
        p[r, L - k:] = np.frombuffer(b"wxyz"[:k], np.uint8)
        p[r + 1, : 4 - k] = np.frombuffer(b"wxyz"[k:], np.uint8)
    p[3, 2:6] = np.frombuffer(b"wxyz", np.uint8)  # one real match
    got = _both(pats, p, np.full(8, L, np.int32))
    assert [tuple(t) for t in got] == [(3, 2, 0)]


@pytest.mark.parametrize("L", [5, 12, 19])
def test_lengths_past_the_width_read_zeros(L):
    """lengths > L: a NUL-tailed pattern matches over the zeros past L, not
    over the next row's bytes."""
    rng = np.random.default_rng(100 + L)
    p = rng.choice(np.frombuffer(b"A\x00", np.uint8), size=(10, L)).astype(np.uint8)
    p[:, 0] = ord("A")  # the next row starts with A, never a zero
    lens = rng.integers(L, L + 6, size=10).astype(np.int32)
    lens[::4] = L - 1
    got = _both(NUL_SET, p, lens)
    assert (got[:, 1] + np.array([len(NUL_SET[u]) for u in got[:, 2]]) > L).any()


@pytest.mark.parametrize("L, rows_per_slice", [(13, 3), (29, 5), (37, 1), (100, 7)])
def test_unaligned_row_slices_equal_jax(monkeypatch, L, rows_per_slice):
    """Widths that are not a multiple of 16, found in row slices whose base
    offsets (s * L) fall at every alignment."""
    pats = [b"ab", b"bca", b"cabca", b"a\x00", b"\x00\x00b"]
    rng = np.random.default_rng(L)
    p = rng.choice(np.frombuffer(b"abc\x00", np.uint8), size=(60, L)).astype(np.uint8)
    lens = rng.integers(0, L + 3, size=60).astype(np.int32)
    whole = _both(pats, p, lens)
    monkeypatch.setattr(mesh_mod, "SUMMARY_MAX_POSITIONS", rows_per_slice * L + 1)
    sliced = Matcher(pats, device="cpu").find_matches(p, lens)
    assert np.array_equal(sliced, whole) and len(whole) > 30
    assert len({(s * L) % 16 for s in range(0, 60, rows_per_slice)}) > 1


def test_rows_of_length_zero():
    rng = np.random.default_rng(5)
    p = rng.choice(np.frombuffer(b"ab\x00", np.uint8), size=(20, 24)).astype(np.uint8)
    lens = np.full(20, 24, np.int32)
    lens[::2] = 0
    lens[5] = -3
    got = _both([b"ab", b"\x00", b"b\x00a"], p, lens)
    assert len(got) and set(got[:, 0]) <= {r for r in range(20) if lens[r] > 0}


# -- the capacity logic, with a fake launch -----------------------------------

class FakeLaunch:
    """Stands for the kernel: writes the first ``min(M, cap)`` of ``rows``
    into a fresh buffer and reports M."""

    def __init__(self, rows, recount=None):
        self.rows = torch.as_tensor(np.asarray(rows, np.int64).reshape(-1, 3))
        self.caps = []
        self.recount = recount

    def __call__(self, cap):
        self.caps.append(cap)
        out = torch.full((cap, 3), -1, dtype=torch.int64)
        m = self.rows.shape[0]
        out[: min(m, cap)] = self.rows[:cap]
        if self.recount is not None and len(self.caps) > 1:
            m = self.recount
        return out, m


ROWS = [[0, 1, 2], [0, 1, 3], [4, 0, 0], [9, 7, 1]]


@pytest.mark.parametrize("cap, caps", [(4, [4]), (9, [9]), (2, [2, 4]), (0, [0, 4])])
def test_capacity_exact_or_one_rerun(monkeypatch, cap, caps):
    monkeypatch.setattr(cw, "LAUNCHES", dict(cw.LAUNCHES, window_find=0, window_find_rerun=0))
    launch = FakeLaunch(ROWS)
    got = cw.find_with_capacity(launch, cap)
    assert launch.caps == caps
    assert got.tolist() == ROWS
    assert cw.LAUNCHES["window_find"] == 1
    assert cw.LAUNCHES["window_find_rerun"] == (len(caps) - 1)


def test_capacity_no_matches(monkeypatch):
    monkeypatch.setattr(cw, "LAUNCHES", dict(cw.LAUNCHES, window_find=0, window_find_rerun=0))
    for cap in (0, 5):
        got = cw.find_with_capacity(FakeLaunch(np.zeros((0, 3))), cap)
        assert got.shape == (0, 3) and got.dtype == torch.int64
    assert cw.LAUNCHES["window_find"] == 2 and cw.LAUNCHES["window_find_rerun"] == 0


def test_capacity_rerun_must_agree():
    with pytest.raises(RuntimeError, match="rerun"):
        cw.find_with_capacity(FakeLaunch(ROWS, recount=5), 1)


# -- a numpy model of the kernel's order ----------------------------------------

def _kernel_order(hits, total, tile, warps, chunk):
    """The slots csrc/window_find.cu gives ``hits`` (flat position, u) pairs:
    tiles of ``tile`` positions, each cut into ``warps`` spans walked in
    steps of 32 lanes; a tile's first slot is the sum of earlier tiles'
    counts (the look-back); a set of more than ``chunk`` patterns writes
    chunk by chunk in reverse, each just below its position's end slot."""
    span = tile // warps
    count = np.bincount(hits[:, 0], minlength=total)
    out = np.full((len(hits), 2), -1, np.int64)
    by_pos = {}
    for q, u in hits:
        by_pos.setdefault(int(q), []).append(int(u))
    prefix = 0
    for t0 in range(0, total, tile):
        end = {}
        slot = prefix
        for w0 in range(t0, min(t0 + tile, total), span):
            for s0 in range(w0, min(w0 + span, total), 32):
                lanes = count[s0 : min(s0 + 32, total)]
                ends = slot + np.cumsum(lanes)  # a warp scan of the step's counts
                for i, q in enumerate(range(s0, s0 + len(lanes))):
                    end[q] = int(ends[i])
                slot = int(ends[-1])
        chunks = range((max(hits[:, 1], default=0) // chunk) + 1)
        for c in reversed(chunks):
            for q in range(t0, min(t0 + tile, total)):
                mine = sorted(u for u in by_pos.get(q, []) if u // chunk == c)
                base = end[q] - len(mine)
                for k, u in enumerate(mine):
                    out[base + k] = (q, u)
                end[q] = base
        prefix = slot
    return out


@pytest.mark.parametrize("seed, total, tile, warps, chunk", [
    (1, 5000, 256, 8, 10_000), (2, 4097, 512, 4, 7), (3, 300, 64, 2, 3), (4, 1, 64, 2, 1)])
def test_kernel_order_model_gives_the_sorted_triples(seed, total, tile, warps, chunk):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, total, size=3 * total // 4 + 1)
    u = rng.integers(0, 30, size=len(q))
    hits = np.unique(np.stack([q, u], 1), axis=0)[rng.permutation(len(np.unique(
        np.stack([q, u], 1), axis=0)))]
    got = _kernel_order(hits, total, tile, warps, chunk)
    want = hits[np.lexsort((hits[:, 1], hits[:, 0]))]
    assert np.array_equal(got, want)


# -- the turns tool -----------------------------------------------------------

def test_find_turns_variants_follow_the_source():
    """Every text ``tools/find_turns.py`` replaces occurs in the kernel's
    source, so each variant is the kernel with just that change."""
    from multithreading_string_matching_tpu_torch.tools import find_turns

    source = (cw.CSRC_DIR / "window_find.cu").read_text()
    for _, edits in find_turns.VARIANTS.values():
        assert find_turns.variant_source(source, edits) != source
    with pytest.raises(ValueError, match="not in"):
        find_turns.variant_source(source, [("no such text", "")])


def test_find_turns_imports_no_jax_and_needs_a_card():
    """``tools/find_turns.py`` imports nothing of jax, and without a card it
    exits non-zero and prints no result (it times only on the card)."""
    code = ("import sys\n"
            "import multithreading_string_matching_tpu_torch.tools.find_turns\n"
            "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts without one")
    r = subprocess.run([sys.executable, "-m", "multithreading_string_matching_tpu_torch.tools.find_turns"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and not r.stdout

