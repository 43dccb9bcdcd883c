"""The torch package's plain window count against the JAX package's window
matcher and its Pallas kernel (interpret mode, as tests/test_pallas_window.py
runs it), plus the kernel wrappers' CPU routing and the pattern program.

Outputs are integer counts, so every comparison is exact (tolerance 0).
The CUDA kernels themselves need a card: tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.ops.pallas_window import PallasWindowMatcher
from multithreading_string_matching_tpu.ops.window import WindowProgram as JaxProgram
from multithreading_string_matching_tpu.ops.window import count_matches_window as jax_count
from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
from multithreading_string_matching_tpu_torch.ops.window import (
    WindowProgram,
    count_matches_window,
    count_matches_window_tiles,
    program_from_reference,
    window_count,
)

torch.set_num_threads(1)

DUPS = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"abcdefgh", b"abcde"]
NUL = [b"a\x00b", b"\x00\x00", b"ab", b"\x00", b"b\x00"]
LONG = [b"abcdefghijklmnopq", b"ab", b"bcd"]


def _tile(seed, n, L, alphabet=b"abc\x00"):
    """Random bytes everywhere (rows are NOT zero past their length)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    payloads = letters[rng.integers(0, len(letters), size=(n, L))]
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    if n:
        lengths[0] = 0  # always one zero-length row
    return payloads, lengths


CASES = {
    "dups-128": (DUPS, (1, 16, 128)),
    "dups-width-13": (DUPS, (2, 7, 13)),
    "dups-width-100": (DUPS, (3, 5, 100)),
    "dups-width-130": (DUPS, (4, 9, 130)),
    "nul": (NUL, (5, 12, 61)),
    "longer-than-row": (LONG, (6, 10, 8)),
    "zero-rows": (DUPS, (7, 0, 32)),
}


def _program(pats):
    return WindowProgram.build(pats)


def _plain(pats, payloads, lengths, per_packet):
    words, masks, lens = _program(pats).tables("cpu")
    return window_count(
        words, masks, lens, torch.from_numpy(payloads), torch.from_numpy(lengths),
        per_packet=per_packet,
    ).numpy()


@pytest.mark.parametrize("per_packet", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_jax_window(case, per_packet):
    pats, args = CASES[case]
    payloads, lengths = _tile(*args)
    want = np.asarray(jax_count(JaxProgram.build(pats), payloads, lengths,
                                per_packet=per_packet, expand_duplicates=False))
    got = _plain(pats, payloads, lengths, per_packet)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
    expanded = count_matches_window(_program(pats), payloads, lengths, per_packet=per_packet).numpy()
    want_exp = np.asarray(jax_count(JaxProgram.build(pats), payloads, lengths, per_packet=per_packet))
    assert np.array_equal(expanded, want_exp)


@pytest.mark.parametrize("case", ["dups-128", "dups-width-100", "nul", "longer-than-row", "zero-rows"])
def test_plain_equals_pallas_interpret(case):
    pats, args = CASES[case]
    payloads, lengths = _tile(*args)
    pwm = PallasWindowMatcher(JaxProgram.build(pats), row_tile=8, interpret=True)
    want_tot = np.asarray(pwm.count_tiles([(payloads, lengths)], expand_duplicates=False))
    assert np.array_equal(_plain(pats, payloads, lengths, False), want_tot)
    n = payloads.shape[0]
    want_rows = np.asarray(pwm.count_tiles_per_row([(payloads, lengths)], expand_duplicates=False)[0])[:n]
    assert np.array_equal(_plain(pats, payloads, lengths, True), want_rows)


def test_tiles_equal_pallas_interpret_multi_tile():
    t1, t2 = _tile(11, 16, 128), _tile(12, 5, 100)
    pwm = PallasWindowMatcher(JaxProgram.build(DUPS), row_tile=8, interpret=True)
    want = np.asarray(pwm.count_tiles([t1, t2]))
    tiles = [(torch.from_numpy(p), torch.from_numpy(l)) for p, l in (t1, t2)]
    assert np.array_equal(count_matches_window_tiles(_program(DUPS), tiles).numpy(), want)
    m = cw.CudaWindowMatcher(_program(DUPS), "cpu")
    assert np.array_equal(m.count_tiles([t1, t2]).numpy(), want)
    rows = m.count_tiles_per_row([t1, t2])
    want_rows = pwm.count_tiles_per_row([t1, t2])
    for got, (p, _), w in zip(rows, (t1, t2), want_rows):
        assert np.array_equal(got.numpy(), np.asarray(w)[: p.shape[0]])
    tot, hits = m.count_tile_summary(*t1)
    jtot, jhits = pwm.count_tile_summary(*t1)
    assert np.array_equal(tot.numpy(), np.asarray(jtot))
    assert np.array_equal(hits.numpy(), np.asarray(jhits)[: t1[0].shape[0]])


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrappers_route_cpu_tensors_to_plain(case):
    pats, args = CASES[case]
    payloads, lengths = _tile(*args)
    words, masks, lens = _program(pats).tables("cpu")
    p, ln = torch.from_numpy(payloads), torch.from_numpy(lengths)
    before = dict(cw.LAUNCHES)
    assert np.array_equal(cw.window_count_totals(p, ln, words, masks, lens).numpy(),
                          _plain(pats, payloads, lengths, False))
    assert np.array_equal(cw.window_count_rows(p, ln, words, masks, lens).numpy(),
                          _plain(pats, payloads, lengths, True))
    assert cw.LAUNCHES == before  # the plain version is not a launch


def test_wrappers_refuse_other_devices():
    words, masks, lens = _program(DUPS).tables("cpu")
    p = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no window-count kernel"):
        cw.window_count_totals(p, torch.zeros(2, dtype=torch.int32), words, masks, lens)


@pytest.mark.parametrize("pats", [DUPS, NUL, LONG, [b"rs%06d" % i for i in range(300)]])
def test_program_from_reference_round_trips(pats):
    ref = JaxProgram.build(pats)
    got = program_from_reference(ref.pat_words, ref.pat_masks, ref.pat_lens,
                                 ref.dup_map, ref.max_len, ref.unique_patterns)
    own = WindowProgram.build(pats)
    for field in ("pat_words", "pat_masks", "pat_lens", "dup_map"):
        a, b, c = (getattr(x, field) for x in (got, own, ref))
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert got.max_len == own.max_len == ref.max_len
    assert got.unique_patterns == own.unique_patterns == ref.unique_patterns
    payloads, lengths = _tile(21, 12, 96, alphabet=b"abrs0123\x00")
    want = np.asarray(jax_count(ref, payloads, lengths))
    assert np.array_equal(count_matches_window(got, payloads, lengths).numpy(), want)


def test_program_from_reference_rejects_bad_tables():
    ref = JaxProgram.build(DUPS)
    with pytest.raises(ValueError):
        program_from_reference(ref.pat_words, ref.pat_masks[:, :1], ref.pat_lens,
                               ref.dup_map, ref.max_len, ref.unique_patterns)
    with pytest.raises(ValueError):
        program_from_reference(ref.pat_words, ref.pat_masks, ref.pat_lens,
                               ref.dup_map + 100, ref.max_len, ref.unique_patterns)

