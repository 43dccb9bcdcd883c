"""The slice as a whole: the torch ``Matcher(device="cpu")`` against the JAX
``Matcher`` on a seeded few-hundred-packet capture and the in-repo
stand-in pattern file.

Counts are integers: every comparison is exact (tolerance 0).
"""

import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu.api import Matcher as JaxMatcher
from multithreading_string_matching_tpu.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap

torch.set_num_threads(1)

STANDIN = (
    pathlib.Path(__file__).resolve().parent.parent
    / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"
)
PATTERNS = load_patterns(STANDIN)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_matcher") / "synth.pcap"
    synth_udp_pcap(path, 400, payload_len=160, payload_len_jitter=150,
                   patterns=PATTERNS, plant_rate=0.6, invalid_rate=0.05, seed=5)
    return path


@pytest.fixture(scope="module")
def batch(capture):
    return extract_payloads(read_pcap(capture), "udp", pad_n_to=128, pad_len_to=8)


def _cpu(pats=PATTERNS, **kw):
    return Matcher(pats, device="cpu", **kw)


def test_count_pcap_equals_jax(capture):
    got = _cpu().count_pcap(capture, "udp")
    want = np.asarray(JaxMatcher(PATTERNS).count_pcap(capture, "udp"))
    assert got.dtype == np.int32 and got.shape == (97,)
    assert got.sum() > 100
    assert np.array_equal(got, want)


def test_count_pcap_tcp_mode_equals_jax(capture):
    got = _cpu().count_pcap(capture, "tcp")
    assert np.array_equal(got, np.asarray(JaxMatcher(PATTERNS).count_pcap(capture, "tcp")))


@pytest.mark.parametrize("engine", ["pallas", "window", "auto"])
def test_per_packet_equals_jax(batch, engine):
    got = _cpu(engine=engine).count(batch.payloads, batch.lengths, per_packet=True)
    want = np.asarray(JaxMatcher(PATTERNS).count(batch.payloads, batch.lengths, per_packet=True))
    assert got.shape == want.shape == (batch.payloads.shape[0], 97)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("packed", [True, False, "auto"])
def test_prepare_stages_the_jax_tiles(batch, packed):
    """Staging is pure host arithmetic: the same tiles, rows and policy."""
    kw = dict(packed=packed, n_tile=64)
    got = _cpu().prepare(batch.payloads, batch.lengths, **kw)
    want = JaxMatcher(PATTERNS).prepare(batch.payloads, batch.lengths, **kw)
    assert got.packed == want.packed
    assert (got.num_rows, got.total_payload_bytes) == (want.num_rows, want.total_payload_bytes)
    assert len(got.tiles) == len(want.tiles)
    for (gp, gl), (wp, wl) in zip(got.tiles, want.tiles):
        assert np.array_equal(gp.numpy(), np.asarray(wp))
        assert np.array_equal(gl.numpy(), np.asarray(wl))
    for gi, wi in zip(got.row_indices, want.row_indices):
        assert np.array_equal(gi, wi)


@pytest.mark.parametrize("staging", ["packed", "bucketed", "auto"])
def test_staging_counts_equal_jax(batch, staging):
    got = _cpu().count(batch.payloads, batch.lengths, staging=staging, n_tile=64)
    want = np.asarray(JaxMatcher(PATTERNS).count(batch.payloads, batch.lengths, staging=staging))
    assert np.array_equal(got, want)


def test_unbucketed_equals_jax(batch):
    got = _cpu(bucketed=False).count(batch.payloads, batch.lengths, staging="bucketed")
    want = np.asarray(JaxMatcher(PATTERNS, bucketed=False).count(batch.payloads, batch.lengths))
    assert np.array_equal(got, want)


def test_case_insensitive_equals_jax(batch):
    rng = np.random.default_rng(9)
    payloads = batch.payloads.copy()
    # Upper-case some planted bytes so folding changes the counts.
    flip = rng.random(payloads.shape) < 0.3
    lower = (payloads >= 97) & (payloads <= 122)
    payloads[flip & lower] -= 32
    for nocase in (False, True):
        got = _cpu(case_insensitive=nocase).count(payloads, batch.lengths)
        want = np.asarray(JaxMatcher(PATTERNS, case_insensitive=nocase).count(payloads, batch.lengths))
        assert np.array_equal(got, want)
    assert not np.array_equal(
        _cpu(case_insensitive=True).count(payloads, batch.lengths),
        _cpu().count(payloads, batch.lengths),
    )


def test_nul_patterns_refuse_packing(batch):
    pats = [b"ab", b"\x00\x00", b"id"]
    m = _cpu(pats)
    with pytest.raises(ValueError, match="NUL-free"):
        m.prepare(batch.payloads, batch.lengths, packed=True)
    with pytest.raises(ValueError, match="NUL-free"):
        JaxMatcher(pats).prepare(batch.payloads, batch.lengths, packed=True)
    assert not m.prepare(batch.payloads, batch.lengths, packed="auto").packed
    got = m.count(batch.payloads, batch.lengths)
    assert np.array_equal(got, np.asarray(JaxMatcher(pats).count(batch.payloads, batch.lengths)))
    # A batch packed under a NUL-free set is refused after a swap to a NUL set.
    m2 = _cpu([b"ab", b"id"])
    prep = m2.prepare(batch.payloads, batch.lengths, packed=True)
    m2.swap_patterns(pats)
    with pytest.raises(ValueError, match="NUL"):
        m2.count_prepared(prep)


def test_packed_batch_has_no_per_packet_counts(batch):
    m = _cpu()
    with pytest.raises(ValueError, match="per-packet"):
        m.count(batch.payloads, batch.lengths, per_packet=True, staging="packed")
    prep = m.prepare(batch.payloads, batch.lengths, packed=True)
    with pytest.raises(ValueError, match="per-packet"):
        m.count_prepared(prep, per_packet=True)


def test_swap_patterns_equals_fresh_matcher(batch):
    m = _cpu()
    m.count(batch.payloads, batch.lengths)
    new = [b"id", b"rs", b"http", b"id"]
    assert m.swap_patterns(new)
    got = m.count(batch.payloads, batch.lengths)
    assert np.array_equal(got, _cpu(new).count(batch.payloads, batch.lengths))
    assert np.array_equal(got, np.asarray(JaxMatcher(new).count(batch.payloads, batch.lengths)))


def test_empty_and_zero_row_batches():
    m = _cpu()
    assert m.count(np.zeros((0, 8), np.uint8), np.zeros(0, np.int32)).shape == (97,)
    assert m.count(np.zeros((0, 8), np.uint8), np.zeros(0, np.int32), per_packet=True).shape == (0, 97)
    got = m.count(np.zeros((3, 8), np.uint8), np.zeros(3, np.int32))
    assert not got.any()


@pytest.mark.parametrize("engine", ["ac", "kmp"])
def test_unported_engines_raise(batch, engine):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _cpu(engine=engine).count(batch.payloads, batch.lengths)


def test_explain_names_the_cuda_kernel(monkeypatch):
    ex = _cpu().explain()
    assert ex["pallas_kernel"] == "cuda-window"
    assert ex["engine_resolved"] == "pallas" and ex["device"] == "cpu"
    jx = JaxMatcher(PATTERNS).explain()
    for key in ("patterns", "unique_patterns", "total_pattern_words", "max_pattern_len",
                "nul_patterns", "case_insensitive", "bucketed"):
        assert ex[key] == jx[key], key
    with pytest.raises(ValueError):
        _cpu(engine="bogus")
    # Large sets: the table kernels, named as the JAX package names them
    # (its CPU path reports its Pallas kernel only in interpret mode).
    monkeypatch.setenv("MSM_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("MSM_PALLAS_TABLE", raising=False)
    large = [b"rs%06d" % i for i in range(300)]
    for filt, name in (("1", "table+filter"), ("0", "table")):
        monkeypatch.setenv("MSM_PALLAS_FILTER", filt)
        assert _cpu(large).explain()["pallas_kernel"] == name
        assert JaxMatcher(large).explain()["pallas_kernel"] == name
    assert JaxMatcher(PATTERNS).explain()["pallas_kernel"] == "unrolled"


def test_count_prepared_nonblocking_returns_a_tensor(batch):
    m = _cpu()
    prep = m.prepare_batch(batch)
    out = m.count_prepared(prep, block=False)
    assert isinstance(out, torch.Tensor)
    assert np.array_equal(out.numpy(), m.count_prepared(prep))
