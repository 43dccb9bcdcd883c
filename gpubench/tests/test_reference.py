"""The plain reference against a brute-force ``bytes.find`` count over small
generated captures of every traffic mix, and its payload rule against the
program's decode on captures with undecodable packets; the ``udp_packets``
reference, reached by name, returns the counts and bytes that the harness
counted before references were found by name."""

import hashlib
import json
import pathlib
import struct

import numpy as np
import pytest

from gpubench import registry
from gpubench.reference import count_payloads, udp_payloads
from gpubench.reference.udp_packets import capture_counts

ROOT = pathlib.Path(__file__).resolve().parents[2]


def small_mix(traffic, tmp_path, seed, packets):
    """``(patterns, capture path, payload bytes)`` of a mix at ``packets``."""
    from gpubench import registry
    from gpubench.gen.inputs import make_inputs

    mix = registry.traffic(traffic)
    mix["capture"].update(packets=packets)
    cfg = json.loads((ROOT / "gpubench" / "configs" / "ref_strings.json").read_text())
    inputs = make_inputs(cfg, mix, seed, ROOT, tmp_path)
    return inputs.patterns, inputs.captures[0], inputs.payload_bytes[0]


def brute(payloads, patterns):
    out = []
    for p in patterns:
        n = 0
        for pl in payloads:
            i = pl.find(p)
            while i >= 0:
                n += 1
                i = pl.find(p, i + 1)
        out.append(n)
    return np.array(out, dtype=np.int64)


def brute_payloads(path):
    """Every frame of a generated capture is Ethernet/IPv4/UDP: the payload
    follows the IP header (IHL words) and the 8-byte UDP header."""
    data = pathlib.Path(path).read_bytes()
    out, pos = [], 24
    while pos < len(data):
        incl = struct.unpack_from("<I", data, pos + 8)[0]
        frame = data[pos + 16 : pos + 16 + incl]
        out.append(frame[14 + (frame[14] & 15) * 4 + 8 :])
        pos += 16 + incl
    return out


@pytest.mark.parametrize("traffic,packets", [("stream_mega", 150), ("stream_vbig", 1500)])
@pytest.mark.parametrize("seed", [1, 2**31 + 17])
def test_counts_equal_brute_force(tmp_path, traffic, packets, seed):
    pats, cap, total = small_mix(traffic, tmp_path, seed, packets)
    counts, nbytes = capture_counts(cap, pats)
    want = brute(brute_payloads(cap), pats)
    assert nbytes == total
    assert counts.sum() > 0
    np.testing.assert_array_equal(counts, want)


# sha256 of the int64 counts, the payload bytes and the counts' sum on capture
# 0 of each shape, as the harness counted them before references were found
# by name.
PINNED = {
    ("stream_mega", 7): ("80d7db6843cf5ea187056b1eb091df43fe74ebb697ed7a84a893fefddc9a949f", 311003, 37),
    ("stream_mega", 2**31 + 3): ("4f1b0207420a1c2643edcea6330c7de800e30520fe8b5fcdb6a59811e2bdd026",
                                 308280, 33),
    ("stream_mega", 2**40 + 11): ("230144131e0e6d1ad1e39ceae98f162dae6c3f60b00ed465bf2ea1741cc96255",
                                  306253, 40),
    ("stream_vbig", 7): ("94d26c2932773f5be53d26a7d7553bbe2cf3c03758a457576ff55a5a61dab5f5", 194046, 2081),
    ("stream_vbig", 2**31 + 3): ("713634c41efa91f5700b5e240396005b34e7da48825125288dcb4fb636aefb8b",
                                 193913, 2103),
    ("stream_vbig", 2**40 + 11): ("45db84ca1d20f973260febbca504f83dc121f42b06df9561b634c1217378c63e",
                                  192613, 2102),
}


@pytest.mark.parametrize("seed", [7, 2**31 + 3, 2**40 + 11])
@pytest.mark.parametrize("traffic,packets", [("stream_mega", 300), ("stream_vbig", 2000)])
def test_udp_packets_returns_the_counts_it_returned_before(tmp_path, traffic, packets, seed):
    pats, cap, total = small_mix(traffic, tmp_path, seed, packets)
    counts, nbytes = registry.reference("udp_packets").capture_counts(cap, pats, "udp", "cpu")
    payloads = udp_payloads(cap)
    np.testing.assert_array_equal(counts, count_payloads(payloads, pats))
    assert nbytes == sum(len(p) for p in payloads) == total
    digest = hashlib.sha256(np.asarray(counts, dtype="<i8").tobytes()).hexdigest()
    assert (digest, nbytes, int(counts.sum())) == PINNED[traffic, seed]


def test_udp_packets_reads_udp_only(tmp_path):
    _, cap, _ = small_mix("stream_mega", tmp_path, 1, 10)
    with pytest.raises(ValueError, match="UDP payloads only"):
        capture_counts(cap, [b"ab"], "tcp")


def test_overlaps_edges_and_duplicates():
    pats = [b"aa", b"aaa", b"ab", b"aa", b"a" * 9, b"a" * 12, b"\x00\x01", b"x", b"abababababab"]
    rng = np.random.default_rng(3)
    payloads = [bytes(rng.choice(np.frombuffer(b"ab\x00\x01x", np.uint8), size=int(n)))
                for n in rng.integers(0, 40, size=200)]
    payloads += [b"a" * 30, b"", b"ab" * 20, b"a", b"aa"]
    np.testing.assert_array_equal(count_payloads(payloads, pats), brute(payloads, pats))


def test_no_match_across_payloads():
    assert count_payloads([b"xxa", b"bxx"], [b"ab", b"xa"]).tolist() == [0, 1]


def test_payload_rule_matches_the_program_decode(tmp_path):
    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
    from multithreading_string_matching_tpu_torch.io.synth import synth_udp_pcap

    cap = tmp_path / "c.pcap"
    synth_udp_pcap(cap, 400, payload_len=64, payload_len_jitter=60, patterns=[b"abc"],
                   plant_rate=0.3, invalid_rate=0.3, seed=11)
    mine = udp_payloads(cap)
    batch = extract_payloads(read_pcap(str(cap)), "udp")
    theirs = [bytes(batch.payloads[i, : batch.lengths[i]]) for i in range(len(batch.lengths))
              if i < int(batch.valid.sum())]
    assert 0 < len(mine) < 400
    assert mine == theirs
