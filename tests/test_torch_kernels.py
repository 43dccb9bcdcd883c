"""The CUDA kernels of the torch package against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without one.
This file imports no jax, so it also runs where jax is not installed::

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m gpu

Counts are integers: every comparison is exact (tolerance 0).
"""

import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.ops import cuda_table as ct
from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
from multithreading_string_matching_tpu_torch.ops.table import filter_count, partition, table_count
from multithreading_string_matching_tpu_torch.ops.window import (
    WindowProgram,
    window_count,
    window_count_halo_plain,
    window_stream_chunk,
)

pytestmark = pytest.mark.gpu

STANDIN = (
    pathlib.Path(__file__).resolve().parent.parent
    / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"
)
DUPS = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"abcdefgh", b"abcde"]
NUL = [b"a\x00b", b"\x00\x00", b"ab", b"\x00", b"b\x00"]
LONG = [b"abcdefghijklmnopq", b"ab", b"bcd"]
RS = [b"rs%06d" % i for i in range(3072)]

# name: (patterns, seed, rows, width, alphabet)
CASES = {
    "dups-128": (DUPS, 1, 16, 128, b"abc\x00"),
    "dups-width-13": (DUPS, 2, 7, 13, b"abc\x00"),
    "dups-width-100": (DUPS, 3, 5, 100, b"abc\x00"),
    "nul": (NUL, 4, 12, 61, b"ab\x00"),
    "longer-than-row": (LONG, 5, 40, 8, b"abcd"),
    "zero-rows": (DUPS, 6, 0, 32, b"abc"),
    "zero-width": (DUPS, 7, 4, 0, b"abc"),
    "multi-segment": (DUPS, 8, 3, 9000, b"abc"),
    "rs3072-chunked": (RS, 9, 64, 256, b"rs0123"),
    "many-blocks": (DUPS, 10, 9000, 24, b"abc"),
}

_rng = np.random.default_rng(11)
MIXED_K = list(dict.fromkeys(
    bytes(_rng.integers(97, 100, size=_rng.integers(1, 33)).tolist()) for _ in range(300)
))
# Large-set cases for the table kernels: name: (patterns, seed, rows, width, alphabet)
TABLE_CASES = {
    **CASES,
    "mixed-k1-8": (MIXED_K, 12, 64, 300, b"abc"),
    "nul-k1-9": ([b"\x00" * k for k in range(1, 10)] + [b"a\x00b\x00c\x00d"], 13, 40, 90, b"ab\x00"),
    "one-pattern-class": ([b"abcdefghijklmnopq", b"ab", b"abc", b"abcd"], 14, 40, 64, b"abcdefghijklmnopq"),
    "shared-prefix": ([b"pt00%04d" % i for i in range(64)], 15, 64, 128, b"pt0123"),
    "filter-word-without-pattern": ([b"abcdwxyz", b"efghijkl", b"mnopqrst"], 16, 64, 200,
                                    b"wxyzijklqrst"),
    "k-up-to-64": ([b"a" * 36, b"ab" * 32, b"b" * 132, b"ab" * 128], 17, 12, 5000, b"ab"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _tile(seed, n, L, alphabet, dev, plant=()):
    """Random rows of ``alphabet`` (not zero past their lengths); with
    ``plant``, row r also holds ``plant[r % len(plant)]`` where it fits."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    payloads = letters[rng.integers(0, len(letters), size=(n, L))]
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    for r in range(n if plant else 0):
        pat = plant[r % len(plant)]
        if len(pat) <= L:
            o = int(rng.integers(0, L - len(pat) + 1))
            payloads[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    return torch.from_numpy(payloads).to(dev), torch.from_numpy(lengths).to(dev)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_equal_plain(cuda_device, case):
    pats, seed, n, L, alphabet = CASES[case]
    words, masks, lens = WindowProgram.build(pats).tables(cuda_device)
    p, ln = _tile(seed, n, L, alphabet, cuda_device)
    for fn, per_row in ((cw.window_count_totals, False), (cw.window_count_rows, True)):
        got = fn(p, ln, words, masks, lens)
        want = window_count(words, masks, lens, p, ln, per_packet=per_row)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want)


def test_wrappers_count_launches_and_refuse_bad_inputs(cuda_device):
    words, masks, lens = WindowProgram.build(DUPS).tables(cuda_device)
    p, ln = _tile(1, 8, 64, b"abc", cuda_device)
    before = dict(cw.LAUNCHES)
    cw.window_count_totals(p, ln, words, masks, lens)
    cw.window_count_rows(p, ln, words, masks, lens)
    assert cw.LAUNCHES["window_count_totals"] == before["window_count_totals"] + 1
    assert cw.LAUNCHES["window_count_rows"] == before["window_count_rows"] + 1
    with pytest.raises(TypeError):
        cw.window_count_totals(p.long(), ln, words, masks, lens)
    with pytest.raises(ValueError, match="contiguous"):
        cw.window_count_totals(p[:, ::2], ln, words, masks, lens)
    with pytest.raises(ValueError):
        cw.window_count_totals(p, ln.cpu(), words, masks, lens)
    with pytest.raises(ValueError):
        cw.window_count_totals(p, ln[:3], words, masks, lens)


def test_matcher_on_card_equals_plain_on_cpu(cuda_device):
    pats = load_patterns(STANDIN)
    rng = np.random.default_rng(3)
    payloads = rng.integers(0, 256, size=(700, 300)).astype(np.uint8)
    for _ in range(2000):
        pat = pats[int(rng.integers(0, len(pats)))]
        r, o = int(rng.integers(0, 700)), int(rng.integers(0, 300 - len(pat)))
        payloads[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    lengths = rng.integers(0, 301, size=700).astype(np.int32)
    gpu, cpu = Matcher(pats, device=cuda_device), Matcher(pats, device="cpu")
    for staging in ("auto", "packed", "bucketed"):
        got = gpu.count(payloads, lengths, staging=staging)
        assert np.array_equal(got, cpu.count(payloads, lengths, staging=staging))
    assert np.array_equal(gpu.count(payloads, lengths, per_packet=True),
                          cpu.count(payloads, lengths, per_packet=True))
    assert gpu.count(payloads, lengths).sum() > 1000


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_table_kernels_equal_plain(cuda_device, case):
    """The four table/filter kernels, and both totals kernels with reps=3,
    equal their plain versions on every word-count class."""
    pats, seed, n, L, alphabet = TABLE_CASES[case]
    p, ln = _tile(seed, n, L, alphabet, cuda_device, plant=pats)
    for filtered in (False, True):
        plain = filter_count if filtered else table_count
        totals = ct.filter_count_totals if filtered else ct.table_count_totals
        rows = ct.filter_count_rows if filtered else ct.table_count_rows
        for c in partition(WindowProgram.build(pats), filtered)[0]:
            tabs = c.tables(cuda_device)
            want = plain(*tabs, p, ln, c.K)
            assert torch.equal(want, table_count(*tabs, p, ln, c.K))
            for reps in (1, 3):
                got = totals(p, ln, *tabs, c.K, reps=reps)
                torch.cuda.synchronize()
                assert got.dtype == torch.int32 and torch.equal(got, reps * want), (filtered, c.K, reps)
            got = rows(p, ln, *tabs, c.K)
            torch.cuda.synchronize()
            assert torch.equal(got, plain(*tabs, p, ln, c.K, per_row=True)), (filtered, c.K)


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_repeats_equal_plain(cuda_device, case):
    pats, seed, n, L, alphabet = CASES[case]
    words, masks, lens = WindowProgram.build(pats).tables(cuda_device)
    p, ln = _tile(seed, n, L, alphabet, cuda_device)
    before = cw.LAUNCHES["window_count_totals_repeated"]
    got = cw.window_count_totals(p, ln, words, masks, lens, reps=3)
    torch.cuda.synchronize()
    assert torch.equal(got, 3 * window_count(words, masks, lens, p, ln))
    assert cw.LAUNCHES["window_count_totals_repeated"] == before + int(n * L > 0)


def test_table_wrappers_count_launches_and_refuse_bad_inputs(cuda_device):
    (c,) = partition(WindowProgram.build([b"abcdefgh", b"bcdefgha"]), True)[0]
    words, masks, lens = c.tables(cuda_device)
    p, ln = _tile(1, 8, 64, b"abcdefgh", cuda_device)
    before = dict(ct.LAUNCHES)
    ct.filter_count_totals(p, ln, words, masks, lens, c.K)
    ct.filter_count_totals(p, ln, words, masks, lens, c.K, reps=2)
    ct.filter_count_rows(p, ln, words, masks, lens, c.K)
    ct.table_count_totals(p, ln, words, masks, lens, c.K)
    ct.table_count_rows(p, ln, words, masks, lens, c.K)
    for name, added in (("filter_count_totals", 1), ("filter_count_totals_repeated", 1),
                        ("filter_count_rows", 1), ("table_count_totals", 1),
                        ("table_count_rows", 1), ("table_count_totals_repeated", 0)):
        assert ct.LAUNCHES[name] == before[name] + added, name
    with pytest.raises(ValueError, match="filter column"):
        ct.filter_count_totals(p, ln, words[:, :c.K].contiguous(), masks[:, :c.K].contiguous(),
                               lens, c.K)
    with pytest.raises(ValueError, match="reps"):
        ct.table_count_totals(p, ln, words, masks, lens, c.K, reps=0)
    with pytest.raises(TypeError):
        ct.table_count_totals(p.long(), ln, words, masks, lens, c.K)
    with pytest.raises(ValueError):
        ct.table_count_rows(p, ln.cpu(), words, masks, lens, c.K)


def test_large_set_matcher_on_card_equals_plain_on_cpu(cuda_device):
    pats = [b"rs%06d" % i for i in range(700)] + MIXED_K
    rng = np.random.default_rng(4)
    payloads = rng.integers(0, 256, size=(600, 400)).astype(np.uint8)
    for _ in range(3000):
        pat = pats[int(rng.integers(0, len(pats)))]
        r, o = int(rng.integers(0, 600)), int(rng.integers(0, 400 - len(pat)))
        payloads[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    lengths = rng.integers(0, 401, size=600).astype(np.int32)
    gpu, cpu = Matcher(pats, device=cuda_device), Matcher(pats, device="cpu")
    assert gpu.explain()["pallas_kernel"] == "table+filter"
    assert isinstance(gpu.kernels, ct.CudaTableMatcher)
    want = cpu.count(payloads, lengths)
    assert want.sum() > 1000
    for staging in ("auto", "bucketed"):
        assert np.array_equal(gpu.count(payloads, lengths, staging=staging), want)
    assert np.array_equal(gpu.count(payloads, lengths, per_packet=True),
                          cpu.count(payloads, lengths, per_packet=True))


# -- the halo kernel (flow-stream rounds) ------------------------------------

# name: (patterns, seed, rows, halo-free width C, alphabet)
HALO_CASES = {
    "small": ([b"ab", b"bca", b"aaaa", b"abcab"], 21, 64, 64, b"abc"),
    "nul": ([b"a\x00b", b"\x00c", b"ca", b"\x00\x00\x01"], 22, 64, 96, b"abc\x00\x01"),
    "wider-than-a-segment": (DUPS, 23, 12, 5000, b"abc"),
    "sub-lane-width": (load_patterns(STANDIN), 24, 300, 2048,
                       b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ/:. "),
    "rs3072": (RS, 25, 64, 256, b"rs0123"),
}


def _halo_lanes(pats, seed, n, C, alphabet, dev):
    """Rows ``[halo | bytes]`` with random real halo fills, random valid
    lengths (some 0) and planted patterns; bytes past a row's length are
    not zero."""
    wp = WindowProgram.build(pats)
    H = max(int(wp.max_len) - 1, 1)
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    x = letters[rng.integers(0, len(letters), size=(n, H + C))]
    for r in range(n):
        pat = pats[r % len(pats)]
        for _ in range(3):
            o = int(rng.integers(0, H + C - len(pat) + 1))
            x[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    fill = rng.integers(0, H + 1, size=n)
    eff = np.minimum(rng.integers(0, C + 1, size=n) + H, H + C)
    eff[::7] = 0
    ms = (H - fill).astype(np.int32)
    return (wp, H, torch.from_numpy(x).to(dev), torch.from_numpy(eff.astype(np.int32)).to(dev),
            torch.from_numpy(ms).to(dev))


@pytest.mark.parametrize("case", sorted(HALO_CASES))
def test_halo_kernel_equals_plain(cuda_device, case):
    wp, H, x, eff, ms = _halo_lanes(*HALO_CASES[case], cuda_device)
    words, masks, lens = wp.tables(cuda_device)
    before = cw.LAUNCHES["window_count_halo"]
    got = cw.window_count_halo(x, eff, ms, words, masks, lens, H)
    torch.cuda.synchronize()
    assert cw.LAUNCHES["window_count_halo"] == before + 1
    want = window_count_halo_plain(x, eff, ms, H, (words, masks, lens))
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(cw.CudaWindowMatcher(wp, cuda_device).count_tile_halo(x, eff, ms), want)


def test_halo_wrapper_refuses_bad_inputs(cuda_device):
    wp, H, x, eff, ms = _halo_lanes(*HALO_CASES["small"], cuda_device)
    words, masks, lens = wp.tables(cuda_device)
    with pytest.raises(ValueError):
        cw.window_count_halo(x, eff, ms[:3], words, masks, lens, H)
    with pytest.raises(TypeError):
        cw.window_count_halo(x, eff, ms.long(), words, masks, lens, H)
    with pytest.raises(ValueError):
        cw.window_count_halo(x, eff, ms.cpu(), words, masks, lens, H)
    with pytest.raises(ValueError):
        cw.window_count_halo(x, eff, ms, words, masks, lens, -1)


def test_window_stream_chunk_on_card_equals_cpu(cuda_device):
    pats = [b"a\x00b", b"\x00c", b"ca", b"abcab"]
    wp = WindowProgram.build(pats)
    kern = cw.CudaWindowMatcher(wp, cuda_device)
    rng = np.random.default_rng(31)
    payloads = rng.integers(0, 4, size=(16, 300)).astype(np.uint8) + 96
    payloads[rng.random(payloads.shape) < 0.1] = 0
    lengths = rng.integers(0, 301, size=16).astype(np.int32)
    halos = {"cpu": None, "plain": None, "kernel": None}
    before = cw.LAUNCHES["window_count_halo"]
    for start in range(0, 300, 37):
        c = payloads[:, start : start + 37]
        rel = (lengths - start).astype(np.int32)
        want, halos["cpu"] = window_stream_chunk(wp, c, rel, halos["cpu"])
        dc = torch.from_numpy(np.ascontiguousarray(c)).to(cuda_device)
        plain, halos["plain"] = window_stream_chunk(wp, dc, rel, halos["plain"])
        got, halos["kernel"] = window_stream_chunk(wp, dc, rel, halos["kernel"],
                                                   halo_count=kern.count_tile_halo)
        torch.cuda.synchronize()
        assert torch.equal(plain.cpu(), want) and torch.equal(got.cpu(), want)
        assert torch.equal(halos["kernel"].data.cpu(), halos["cpu"].data)
    assert cw.LAUNCHES["window_count_halo"] > before


@pytest.mark.parametrize("pats", [load_patterns(STANDIN), RS[:700]],
                         ids=["standin", "rs700-table-route"])
def test_flow_stream_on_card_equals_cpu(cuda_device, tmp_path, pats):
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
    from multithreading_string_matching_tpu_torch.io.synth import synth_tcp_flows_pcap
    from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher

    rng = np.random.default_rng(41)
    flows = []
    for i in range(40):
        pay = bytearray(rng.integers(0, 256, size=int(rng.integers(2000, 9000)), dtype=np.uint8))
        for _ in range(20):
            p = pats[int(rng.integers(0, len(pats)))]
            o = int(rng.integers(0, len(pay) - len(p)))
            pay[o : o + len(p)] = p
        flows.append(((f"10.3.0.{i + 1}", "10.3.1.1", 5000 + i, 80), bytes(pay)))
    path = tmp_path / "flows.pcap"
    synth_tcp_flows_pcap(path, flows, segment_len=700, interleave_seed=1)
    pcap = read_pcap(path)
    out = {}
    for dev in ("cpu", cuda_device):
        fs = FlowStreamMatcher(Matcher(pats, device=dev), "tcp", engine="window",
                               scan_bytes=20_000)
        before = dict(cw.LAUNCHES)
        for s in range(0, pcap.num_packets, 40):
            fs.feed_pcap_slice(slice_pcap(pcap, s, s + 40))
        fs.flush()
        out[str(dev)] = fs.counts()
        launched = cw.LAUNCHES["window_count_halo"] - before["window_count_halo"]
        assert launched == (fs._round if dev != "cpu" else 0)
    assert np.array_equal(out["cpu"], out[str(cuda_device)]) and out["cpu"].sum() > 100


# -- the pattern-shard kernels (ShardTableKernel) ------------------------------

# name: (patterns, shards, seed, rows, width, alphabet)
SHARD_CASES = {
    "padded-slots": ([b"abc", b"bcab", b"cabca", b"ab"], 1, 51, 64, 256, b"abc"),
    "short-in-k8": ([b"a", b"ab", b"abc", b"abcabcabcabcabcabcabcabcabcabca"], 2, 52, 64, 300,
                    b"abc"),
    "nul-not-zero-filled": (NUL + [b"a\x00b\x00c\x00d"], 3, 53, 40, 90, b"ab\x00"),
    "k-max-64": ([b"a" * 36, b"ab" * 32, b"b" * 132, b"ab" * 128, b"ab", b"b"], 2, 54, 12, 5000,
                 b"ab"),
    "mixed-k1-8": (MIXED_K, 4, 55, 64, 300, b"abc"),
    "rs3072": (RS, 1, 56, 64, 256, b"rs0123"),
}


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shard_kernels_equal_plain(cuda_device, case):
    """Each shard block's totals and per-row counts, table and filter
    forms, equal the plain versions; padded slots count 0; the launches go
    to the shard keys, not the class route's."""
    from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
        build_pattern_shards,
    )

    pats, n_sh, seed, n, L, alphabet = SHARD_CASES[case]
    p, ln = _tile(seed, n, L, alphabet, cuda_device, plant=pats)
    wp = WindowProgram.build(pats)
    for filtered in (False, True):
        plan = build_pattern_shards(wp, n_sh, filtered=filtered)
        kern = ct.ShardTableKernel(plan.K, plan.S, plan.use_fit, filtered, cuda_device)
        plain = filter_count if filtered else table_count
        form = "filter" if filtered else "table"
        before = dict(ct.LAUNCHES)
        found = 0
        for d in range(n_sh):
            rows = slice(d * plan.S, (d + 1) * plan.S)
            w, m = (torch.from_numpy(np.ascontiguousarray(a[rows]).view(np.int32)).to(cuda_device)
                    for a in (plan.words, plan.masks))
            lens = torch.from_numpy(plan.lens[rows]).to(cuda_device)
            want = plain(w, m, lens.view(-1), p, ln, plan.K)
            got = kern.counts(w, m, lens, p, ln)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, want), (form, d)
            assert not got[plan.valid(d):].any()
            got_rows = kern.rows(w, m, lens, p, ln)
            torch.cuda.synchronize()
            assert torch.equal(got_rows, plain(w, m, lens.view(-1), p, ln, plan.K, per_row=True))
            found += int(got.sum())
        assert found > 0
        for k, v in ct.LAUNCHES.items():
            added = n_sh if k in (f"shard_{form}_count_totals", f"shard_{form}_count_rows") else 0
            assert v == before[k] + added, (form, k)


def test_pattern_sharded_virtual_meshes_on_card(cuda_device):
    """A 4-shard and a 2x2 mesh on one card through the pattern-sharded
    entry points, and a 2-shard flow round, equal the CPU's plain counts;
    one shard kernel launch per shard and call."""
    from multithreading_string_matching_tpu_torch.parallel.mesh import (
        count_flow_round_sharded,
        make_mesh,
    )
    from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
        count_matches_pattern_sharded,
        count_rows_pattern_sharded,
        count_rows_summary_pattern_sharded,
        make_2d_mesh,
        make_pattern_mesh,
    )

    pats = RS[:400] + MIXED_K
    rng = np.random.default_rng(57)
    payloads = rng.integers(0, 256, size=(300, 400)).astype(np.uint8)
    for _ in range(1500):
        pat = pats[int(rng.integers(0, len(pats)))]
        r, o = int(rng.integers(0, 300)), int(rng.integers(0, 400 - len(pat)))
        payloads[r, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
    lengths = rng.integers(0, 401, size=300).astype(np.int32)
    gpu, cpu = Matcher(pats, device=cuda_device), Matcher(pats, device="cpu")
    want = cpu.count(payloads, lengths)
    want_rows = cpu.count(payloads, lengths, per_packet=True)
    assert want.sum() > 500
    for mesh, shards in ((make_pattern_mesh([cuda_device] * 4), 4),
                         (make_2d_mesh(2, 2, [cuda_device] * 4), 4)):
        before = dict(ct.LAUNCHES)
        got = count_matches_pattern_sharded(gpu, payloads, lengths, mesh)
        assert np.array_equal(got, want)
        assert ct.LAUNCHES["shard_filter_count_totals"] == before["shard_filter_count_totals"] + shards
        assert ct.LAUNCHES["filter_count_totals"] == before["filter_count_totals"]
        assert np.array_equal(count_rows_pattern_sharded(gpu, payloads, lengths, mesh), want_rows)
        tot, hits = count_rows_summary_pattern_sharded(gpu, payloads, lengths, mesh)
        assert np.array_equal(tot[gpu.window.dup_map], want)
        assert np.array_equal(hits, want_rows.sum(axis=1) > 0)
    wp, H, x, eff, ms = _halo_lanes(*HALO_CASES["small"], "cpu")
    m = Matcher([b"ab", b"bca", b"aaaa", b"abcab"], device=cuda_device)
    before = cw.LAUNCHES["window_count_halo"]
    got = count_flow_round_sharded(m, x.numpy(), eff.numpy(), ms.numpy(),
                                   make_mesh([cuda_device] * 2), engine="pallas")
    torch.cuda.synchronize()
    assert cw.LAUNCHES["window_count_halo"] == before + 2
    assert torch.equal(got.cpu(), window_count_halo_plain(x, eff, ms, H, wp.tables("cpu")))


# -- the matrix-unit kernel (ops/mxu.py) ---------------------------------------

# name: (patterns, seed, rows, width, alphabet)
MXU_CASES = {
    "ragged-width-1000": (load_patterns(STANDIN), 61, 37, 1000,
                          b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ/:. "),
    "width-13": ([b"ab", b"b", b"abcdefgh"], 62, 9, 13, b"abc"),
    "m-max-99": ([b"a", b"ab" * 49 + b"a", b"b" * 99, b"ba"], 63, 20, 517, b"ab"),
    "u-1": ([b"abc"], 64, 50, 300, b"abc"),
    "u-127": ([b"x%03d" % i for i in range(127)], 65, 40, 260, b"x0123"),
    "u-128": ([b"x%03d" % i for i in range(128)], 66, 40, 260, b"x0123"),
    "u-129": ([b"x%03d" % i for i in range(129)], 67, 40, 260, b"x0123"),
    "u-3072": (RS, 68, 64, 256, b"rs0123"),
    "zero-rows": ([b"ab"], 69, 0, 64, b"ab"),
}


@pytest.mark.parametrize("case", sorted(MXU_CASES))
def test_mxu_kernel_equals_plain(cuda_device, case):
    """``mxu_count`` (int8 mma.sync) equals ``mxu_count_plain`` on the card,
    with reps 1 and 3, on rows zero past their lengths."""
    from multithreading_string_matching_tpu_torch.ops import mxu

    pats, seed, n, L, alphabet = MXU_CASES[case]
    p, ln = _tile(seed, n, L, alphabet, cuda_device, plant=pats)
    p = torch.where(torch.arange(L, device=cuda_device)[None, :] < ln[:, None], p, 0)
    P, tgt, m_max = mxu.bit_tables(pats)
    P, tgt = torch.from_numpy(P).to(cuda_device), torch.from_numpy(tgt).to(cuda_device)
    want = mxu.mxu_count_plain(P, tgt, m_max, p)
    before = dict(mxu.LAUNCHES)
    for reps in (1, 3):
        got = mxu.mxu_count(p, P, tgt, reps=reps)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, reps * want), reps
    launched = int(n > 0)
    assert mxu.LAUNCHES == {"mxu_count": before["mxu_count"] + launched,
                            "mxu_count_repeated": before["mxu_count_repeated"] + launched}
    m = mxu.MxuMatcher(pats, cuda_device)
    assert torch.equal(m.count_tiles([(p, ln)]), want[: len(pats)])
    assert n == 0 or want.sum() > 0


def test_mxu_wrapper_refuses_bad_inputs(cuda_device):
    from multithreading_string_matching_tpu_torch.ops import mxu

    P, tgt, _ = mxu.bit_tables([b"ab", b"b"])
    P, tgt = torch.from_numpy(P).to(cuda_device), torch.from_numpy(tgt).to(cuda_device)
    p, _ = _tile(1, 8, 64, b"ab", cuda_device)
    with pytest.raises(ValueError):
        mxu.mxu_count(p.long(), P, tgt)
    with pytest.raises(ValueError):
        mxu.mxu_count(p, P[:100].contiguous(), tgt[:100])
    with pytest.raises(ValueError):
        mxu.mxu_count(p, P, tgt.cpu())
    with pytest.raises(ValueError, match="reps"):
        mxu.mxu_count(p, P, tgt, reps=0)
    out = torch.zeros(128, dtype=torch.int32, device=cuda_device)
    # The C entry point refuses a depth that is not a multiple of 32; the
    # wrapper turns its return code into an error.
    with pytest.raises(RuntimeError, match="launch failed"):
        mxu.LIBRARY.call("msm_mxu_count", p.data_ptr(), P.data_ptr(), tgt.data_ptr(),
                         out.data_ptr(), 8, 64, 128, 8, 1, 0,
                         torch.cuda.current_stream().cuda_stream)
