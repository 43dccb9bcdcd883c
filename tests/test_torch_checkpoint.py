"""Checkpoints of the torch package's stream matchers against the JAX
package's: a ``StreamMatcher`` or ``FlowStreamMatcher`` saved halfway and
loaded into a fresh one finishes with the uninterrupted run's totals, a
checkpoint written by either package resumes in the other to the same
totals, mismatched patterns and configurations are refused, int64 counts
past 2^31 survive, and AC states outside ``[0, dead]`` are refused.

Counts are compared exactly.
"""

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu.io import live as jax_live
from multithreading_string_matching_tpu.io.pcap import read_pcap as jax_read
from multithreading_string_matching_tpu.io.pcap import slice_pcap as jax_slice
from multithreading_string_matching_tpu.io.synth import synth_tcp_flows_pcap, synth_udp_pcap
from multithreading_string_matching_tpu.parallel.flow_stream import (
    FlowStreamMatcher as JaxFlowStream,
)
from multithreading_string_matching_tpu.parallel.stream import StreamMatcher as JaxStream
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io import live
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher
from multithreading_string_matching_tpu_torch.parallel.stream import (
    StreamMatcher,
    patterns_npz_fields,
)

torch.set_num_threads(1)

PATS = [b"SIGNATURE", b"SIG", b"xx", b"zz", b"ATU", b"SIGNATURE", b"pp"]

# One side's classes: (matcher, stream, flow stream, replay source, reader, slicer).
TORCH = (lambda p, **kw: Matcher(p, device="cpu", **kw), StreamMatcher, FlowStreamMatcher,
         live.FileReplaySource, read_pcap, slice_pcap)
JAX = (JaxMatcher, JaxStream, JaxFlowStream, jax_live.FileReplaySource, jax_read, jax_slice)
SIDES = {"torch": TORCH, "jax": JAX}


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ckpt")
    udp, long_, tcp = d / "udp.pcap", d / "long.pcap", d / "tcp.pcap"
    synth_udp_pcap(udp, 300, payload_len=120, payload_len_jitter=100, patterns=PATS,
                   plant_rate=0.8, invalid_rate=0.03, seed=11)
    synth_udp_pcap(long_, 16, payload_len=4500, payload_len_jitter=500, patterns=PATS,
                   plant_rate=1.0, seed=12)
    rng = np.random.default_rng(13)
    flows = []
    for i in range(8):
        body = bytearray(rng.choice(np.frombuffer(b"xzpSIGNATURE", np.uint8), 700).tobytes())
        for _ in range(4):
            o = int(rng.integers(0, len(body) - 9))
            body[o : o + 9] = b"SIGNATURE"
        flows.append(((f"10.0.0.{i + 1}", "10.9.0.1", 1000 + i, 80), bytes(body)))
    synth_tcp_flows_pcap(tcp, flows, segment_len=37, interleave_seed=3, noise_packets=5,
                         reorder_seed=4, retransmit_rate=0.2, overlap_rate=0.1, seed=14)
    return {"udp": udp, "long": long_, "tcp": tcp}


# -- StreamMatcher ----------------------------------------------------------

STREAMS = {
    "packed": ("udp", {}),
    "unpacked": ("udp", dict(packed=False)),
    "long window": ("long", dict(packed=False, fixed_len=1024)),
    "long ac": ("long", dict(packed=False, engine="ac", fixed_len=1024)),
}


def _stream_run(side, cap, skw, save_at=None, path=None, load_from=None):
    """Feed ``cap`` in 10-packet batches; save after ``save_at`` batches
    (returning there), or resume from ``load_from`` at that point."""
    M, S, _, Src, _, _ = SIDES[side]
    s = S(M(PATS), **skw)
    batches = list(Src(cap))
    start = 0
    if load_from is not None:
        s.load(load_from)
        start = save_at
    for i, b in enumerate(batches[start:], start):
        if save_at is not None and load_from is None and i == save_at:
            return s.save(path)
        s.feed_pcap_slice(b, "udp")
    return s


@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_kill_resume_across_packages(caps, tmp_path, name, writer, reader):
    cap, skw = STREAMS[name]
    half = 15 if cap == "udp" else 1
    want = _stream_run("jax", caps[cap], skw)
    ckpt = _stream_run(writer, caps[cap], skw, save_at=half, path=tmp_path / "ckpt")
    assert ckpt.endswith(".npz")
    got = _stream_run(reader, caps[cap], skw, save_at=half, load_from=tmp_path / "ckpt")
    assert got.counts().tolist() == want.counts().tolist()
    assert got.counts().sum() > 0
    assert got.packets_seen == want.packets_seen


def test_stream_load_replaces_state(caps, tmp_path):
    s = StreamMatcher(Matcher(PATS, device="cpu"))
    batches = list(live.FileReplaySource(caps["udp"]))
    for b in batches:
        s.feed_pcap_slice(b, "udp")
    clean = s.counts().copy()
    ckpt = s.save(tmp_path / "full.npz")
    for b in batches[:5]:
        s.feed_pcap_slice(b, "udp")
    assert s.counts().sum() > clean.sum()
    s.load(ckpt)
    assert s.counts().tolist() == clean.tolist()


def test_stream_pattern_mismatch_raises(caps, tmp_path):
    for M, S in ((TORCH[0], StreamMatcher), (JaxMatcher, JaxStream)):
        s = S(M(PATS))
        s.feed_pcap_slice(read_pcap(caps["udp"]), "udp")
        ckpt = s.save(tmp_path / "k")
        for other in ((TORCH[0], StreamMatcher), (JaxMatcher, JaxStream)):
            with pytest.raises(ValueError, match="pattern list"):
                other[1](other[0](PATS[:-1])).load(ckpt)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_stream_int64_counts_survive(caps, tmp_path, writer):
    """Counts past 2^31 restore into the int64 host base and keep growing
    exactly (an int32 accumulator would wrap)."""
    big = np.array([3_000_000_000 + i for i in range(len(PATS))], np.int64)
    M, S = SIDES[writer][:2]
    s = S(M(PATS))
    path = tmp_path / "big.npz"
    np.savez(path, counts=big, packets_seen=np.int64(5), **patterns_npz_fields(PATS))
    s.load(path)
    ckpt = s.save(tmp_path / "again")
    resumed = StreamMatcher(TORCH[0](PATS))
    resumed.load(ckpt)
    one = StreamMatcher(TORCH[0](PATS))
    for b in live.FileReplaySource(caps["udp"]):
        resumed.feed_pcap_slice(b, "udp")
        one.feed_pcap_slice(b, "udp")
    got = resumed.counts()
    assert got.dtype == np.int64
    assert got.tolist() == (big + one.counts()).tolist()
    assert resumed.packets_seen == 5 + one.packets_seen


# -- FlowStreamMatcher -------------------------------------------------------

FLOW_CONFIGS = {
    "ac": dict(engine="ac"),
    "window": dict(engine="window"),
    "ac reorder": dict(engine="ac", reorder=True),
    "window reorder": dict(engine="window", reorder=True),
    "window offsets": dict(engine="window", collect_offsets=True),
}


def _flow_run(side, cap, fkw, stop=None, path=None, load_from=None, start=0):
    M, _, F, _, reader, slicer = SIDES[side]
    fs = F(M(PATS), "tcp", scan_bytes=512, width=64, min_lanes=8, **fkw)
    if load_from is not None:
        fs.load(load_from)
    pcap = reader(cap)
    end = pcap.num_packets if stop is None else stop
    for s in range(start, end, 7):
        fs.feed_pcap_slice(slicer(pcap, s, min(s + 7, end), copy=False))
    if path is not None:
        return fs.save(path)
    fs.flush()
    return fs


@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("name", list(FLOW_CONFIGS))
def test_flow_kill_resume_across_packages(caps, tmp_path, name, writer, reader):
    fkw = FLOW_CONFIGS[name]
    want = _flow_run("jax", caps["tcp"], fkw)
    n = read_pcap(caps["tcp"]).num_packets
    half = (n // 2) // 7 * 7
    ckpt = _flow_run(writer, caps["tcp"], fkw, stop=half, path=tmp_path / "ckpt")
    got = _flow_run(reader, caps["tcp"], fkw, load_from=ckpt, start=half)
    assert got.counts().tolist() == want.counts().tolist()
    assert got.counts().sum() > 0
    assert (got.packets_seen, got.bytes_seen) == (want.packets_seen, want.bytes_seen)
    assert got.flows_seen == want.flows_seen
    if fkw.get("collect_offsets"):
        # Undrained triples ride in the checkpoint, as in the JAX package.
        triples = [[(bytes(k), int(o), int(u)) for k, o, u in fs.drain_offsets()]
                   for fs in (got, want)]
        assert triples[0] == triples[1] and len(triples[0]) > 0


def test_flow_checkpoint_files_equal_jax(caps, tmp_path):
    """The two packages write the same arrays for the same stream."""
    for fkw in FLOW_CONFIGS.values():
        a = np.load(_flow_run("torch", caps["tcp"], fkw, stop=140, path=tmp_path / "t"))
        b = np.load(_flow_run("jax", caps["tcp"], fkw, stop=140, path=tmp_path / "j"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_flow_mismatches_raise(caps, tmp_path):
    ckpt = _flow_run("torch", caps["tcp"], dict(engine="ac"), stop=70, path=tmp_path / "k")
    M = TORCH[0]
    with pytest.raises(ValueError, match="pattern"):
        FlowStreamMatcher(M([b"other"]), "tcp").load(ckpt)
    with pytest.raises(ValueError, match="engine/mode"):
        FlowStreamMatcher(M(PATS), "tcp", engine="window").load(ckpt)
    with pytest.raises(ValueError, match="engine/mode"):
        FlowStreamMatcher(M(PATS), "udp").load(ckpt)
    with pytest.raises(ValueError, match="reorder"):
        FlowStreamMatcher(M(PATS), "tcp", reorder=True).load(ckpt)
    with pytest.raises(ValueError, match="reorder"):
        FlowStreamMatcher(M(PATS), "tcp", ipv6=True).load(ckpt)


@pytest.mark.parametrize("bad", [-1, "dead+1", 2**31 - 1])
def test_flow_out_of_range_states_refused(caps, tmp_path, bad):
    fkw = dict(engine="ac")
    ckpt = _flow_run("torch", caps["tcp"], fkw, stop=140, path=tmp_path / "k")
    data = dict(np.load(ckpt))
    fs = FlowStreamMatcher(TORCH[0](PATS), "tcp", scan_bytes=512, width=64, min_lanes=8)
    dead = fs.matcher.cac.dead
    vals = data["state_vals"].copy()
    assert vals.size and vals.max() <= dead
    vals[vals.size // 2] = dead + 1 if bad == "dead+1" else bad
    data["state_vals"] = vals
    np.savez(tmp_path / "bad.npz", **data)
    before = fs.counts().tolist()
    with pytest.raises(ValueError, match=r"AC start states must lie in \[0, "):
        fs.load(tmp_path / "bad.npz")
    assert fs.counts().tolist() == before and fs.packets_seen == 0  # left as it was
    fs.load(ckpt)  # the good checkpoint still loads
    assert fs.packets_seen > 0


def test_flow_int64_counts_survive(caps, tmp_path):
    ckpt = _flow_run("jax", caps["tcp"], dict(engine="ac"), stop=140, path=tmp_path / "k")
    data = dict(np.load(ckpt))
    data["counts"] = data["counts"] + 5_000_000_000
    np.savez(tmp_path / "big.npz", **data)
    got = _flow_run("torch", caps["tcp"], dict(engine="ac"), load_from=tmp_path / "big.npz",
                    start=140)
    want = _flow_run("jax", caps["tcp"], dict(engine="ac"))
    assert got.counts().dtype == np.int64
    assert got.counts().tolist() == (want.counts() + 5_000_000_000).tolist()
