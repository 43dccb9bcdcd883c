"""The operation counts behind ``chip_smoke.py``'s ``bound_ms`` for the
hashed-probe kernels (``csrc/probe.cuh``), held against a position-by-
position count of what the kernel body does, on small CPU tiles.

Per position and pass the kernel tests the word's low 16 bits in a map of
the live keys' low 16 (or, for a 1-byte mask, 8) bits; only where the bit
is set does it look the word up once per distinct probe mask.  A mask whose
low 16 bits are neither 0xFF nor 0xFFFF turns the map off.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu_torch.ops.window import WindowProgram

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tile(seed, n, L, alphabet):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    p = letters[rng.integers(0, len(letters), size=(n, L))]
    return torch.from_numpy(p), torch.from_numpy(rng.integers(0, L + 1, size=n).astype(np.int32))


def _positions(tiles):
    """Every real position's word, bytes past the row's width read as 0."""
    out = []
    for p, l, *s in tiles:
        p = p.numpy()
        for r in range(p.shape[0]):
            row = p[r].tobytes() + b"\x00" * 3
            first = int(s[0][r]) if s else 0
            out += [int.from_bytes(row[i:i + 4], "little") for i in range(first, int(l[r]))]
    return out


def _kernel_lookups(xs, words, masks):
    live = [(int(w), int(m)) for w, m in zip(words, masks) if m and (w & m) == w]
    n_masks = len({m for _, m in live})
    if any((m & 0xFFFF) not in (0xFF, 0xFFFF) for _, m in live):
        return n_masks * len(xs)
    passed = sum(any((x & (m & 0xFFFF)) == (w & (m & 0xFFFF)) for w, m in live) for x in xs)
    return n_masks * passed


PROBE_COLUMNS = {
    # 1-, 2-, 3- and 4-byte word-0 keys: masks 0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF
    "four-masks": ([0x61, 0x6261, 0x636261, 0x64636261, 0x62616362],
                   [0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF]),
    "full-words": ([0x64636261, 0x61646362, 0x61616161], [0xFFFFFFFF] * 3),
    # a mask the 16-bit map cannot hold: every position looks up
    "map-off": ([0x6100, 0x64636261], [0xFF00, 0xFFFFFFFF]),
    # keys that can never fire build nothing: mask 0, bits outside the mask
    "dead-keys": ([0, 1, 0x1FF], [0, 0, 0xFF]),
    "dead-and-live": ([0, 0x62, 0x1FF], [0, 0xFF, 0xFF]),
}


@pytest.mark.parametrize("case", sorted(PROBE_COLUMNS))
def test_lookups_equal_the_kernels_count(smoke, case):
    words, masks = (np.array(v, np.uint32) for v in PROBE_COLUMNS[case])
    tiles = [_tile(1, 9, 40, b"abcd"), _tile(2, 5, 13, b"ab\x00")]
    w = smoke.position_words(tiles)
    xs = _positions(tiles)
    assert sorted(xs) == w.tolist()
    assert smoke.lookups(w, words, masks) == _kernel_lookups(xs, words, masks)


def test_probe_work_and_ops_on_a_window_program(smoke):
    pats = [b"a", b"ab", b"abc", b"abcd", b"bcab", b"dabcda"]
    wp = WindowProgram.build(pats)
    p, l = _tile(3, 12, 50, b"abcd")
    starts = torch.from_numpy(np.random.default_rng(4).integers(0, 10, size=12).astype(np.int32))
    for tiles in ([(p, l)], [(p, l, starts)]):
        w = smoke.position_words(tiles)
        xs = _positions(tiles)
        hits, chain = smoke.probe_work(wp, w, filtered=False)
        want = [sum((x & int(wp.pat_masks[u, 0])) == int(wp.pat_words[u, 0]) for x in xs)
                for u in range(len(pats))]
        assert hits.tolist() == want and sum(want) > 0
        assert chain.tolist() == [-(-len(q) // 4) - 1 for q in wp.unique_patterns]
        passes = [smoke.lookups(w, wp.pat_words[:, 0], wp.pat_masks[:, 0])]
        assert 0 < passes[0] < 4 * len(xs)  # the map lets some positions through, not all
        ops, old = smoke.probe_ops((hits, chain), len(xs), passes)
        verify = 2 * int((hits * chain).sum())
        assert ops == 4 * len(xs) + 4 * passes[0] + 2 * int(hits.sum()) + verify
        assert old == 2 * len(xs) * len(pats) + verify
        # One map test per position and pass: two passes (two classes) pay two.
        two, _ = smoke.probe_ops((hits, chain), len(xs), passes * 2)
        assert two - ops == 4 * len(xs) + 4 * passes[0]
