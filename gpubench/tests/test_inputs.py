"""The generator writes what its traffic mix states, the same bytes for the
same seed, and captures that the program's own decoder reads as the
reference does; the ``udp`` generator, reached by name, writes the bytes
that ``synth_udp_pcap`` wrote when it was called directly."""

import hashlib
import json
import pathlib

import numpy as np
import pytest

from gpubench import registry
from gpubench.gen.inputs import capture_seed, entry_weights, load_rules, make_inputs
from gpubench.gen.synth import synth_udp_pcap
from gpubench.reference import udp_payloads

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TRAFFIC = sorted({w["traffic"] for w in BENCH["workloads"]})


def config(name="ref_strings"):
    return json.loads((ROOT / "gpubench" / "configs" / f"{name}.json").read_text())


# The keys of a mix that make_inputs passed to synth_udp_pcap when it called
# it directly, before generators were found by name.
DIRECT_KEYS = ("payload_len_jitter", "content", "lead_nul", "plant_rate", "ihl6_rate")
SHAPES = [("stream_mega", 300), ("stream_vbig", 2000)]
IDENTITY_SEEDS = [7, 2**31 + 3, 2**40 + 11]
# sha256 and payload bytes of capture 0 at seed 2**31 + 3, as written by the
# harness before generators were found by name.
PINNED = {
    "stream_mega": ("e79c3700944f4e190e1f55ce194847ed8568f473ac47edcff74fe149f4bbcc3d", 308280),
    "stream_vbig": ("01799212aff0d95a2fd37879bf4582ff9a1f2de3294319f853d286cba5a29a91", 193913),
}


def small(traffic, tmp_path, seed, packets=2000):
    mix = registry.traffic(traffic)
    mix["capture"].update(packets=packets)
    tmp_path.mkdir(parents=True, exist_ok=True)
    return mix, make_inputs(config(), mix, seed, ROOT, tmp_path)


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_same_seed_same_bytes(tmp_path, traffic):
    a = small(traffic, tmp_path / "a", 2**31 + 3)[1].captures[0]
    b = small(traffic, tmp_path / "b", 2**31 + 3)[1].captures[0]
    c = small(traffic, tmp_path / "c", 2**31 + 4)[1].captures[0]
    assert a.read_bytes() == b.read_bytes() != c.read_bytes()


@pytest.mark.parametrize("seed", IDENTITY_SEEDS)
@pytest.mark.parametrize("traffic,packets", SHAPES)
def test_udp_generator_writes_what_synth_udp_pcap_wrote(tmp_path, traffic, packets, seed):
    mix, inputs = small(traffic, tmp_path / "named", seed, packets)
    cap = mix["capture"]
    assert "generator" not in cap
    weights = entry_weights(inputs.patterns, cap.get("plant_weights"))
    direct = tmp_path / "direct.pcap"
    nbytes = synth_udp_pcap(direct, int(cap["packets"]), payload_len=int(cap["payload_len"]),
                            patterns=inputs.patterns, plant_weights=weights, seed=capture_seed(seed, 0),
                            **{k: cap[k] for k in DIRECT_KEYS if k in cap})
    named = tmp_path / "named.pcap"
    assert registry.generator("udp").write(named, cap, inputs.patterns, weights,
                                           capture_seed(seed, 0)) == nbytes
    assert inputs.captures[0].read_bytes() == direct.read_bytes() == named.read_bytes()
    assert inputs.payload_bytes == [nbytes]
    if seed == 2**31 + 3:
        assert (hashlib.sha256(direct.read_bytes()).hexdigest(), nbytes) == PINNED[traffic]


@pytest.fixture(params=TRAFFIC)
def mix_payloads(request, tmp_path):
    mix, inputs = small(request.param, tmp_path, 17)
    return mix["capture"], inputs, udp_payloads(inputs.captures[0])


def test_payloads_have_the_mix_shape(mix_payloads):
    cap, inputs, payloads = mix_payloads
    lens = np.array([len(p) for p in payloads])
    lo, hi = cap["payload_len"] - cap["payload_len_jitter"], cap["payload_len"] + cap["payload_len_jitter"]
    assert len(payloads) == cap["packets"] and lens.sum() == inputs.payload_bytes[0]
    assert lo <= lens.min() and lens.max() <= hi
    assert abs(lens.mean() - cap["payload_len"]) < 0.05 * cap["payload_len"]
    heads = {p[0] for p in payloads}
    if cap["lead_nul"]:
        assert heads == {0}
    body = b"".join(p[1:] for p in payloads)
    if cap["content"] == "text":
        assert min(body) >= 0x20 and max(body) <= 0x7E
    else:
        assert len(set(body)) == 256


def test_plants_follow_the_weights(mix_payloads):
    cap, inputs, payloads = mix_payloads
    planted = {}
    for name, w in cap.get("plant_weights", {}).items():
        pat = name.encode()
        planted[name] = sum(p.count(pat) for p in payloads)
    if not planted:
        return
    total = sum(cap["plant_weights"].values())
    n = cap["packets"] * cap["plant_rate"]
    for name in ("youtube", "id", "ubuntu"):
        want = n * cap["plant_weights"][name] / total
        assert abs(planted[name] - want) < 5 * want ** 0.5 + 0.02 * n, (name, planted[name], want)


def test_frames_carry_ip_options_at_the_mix_rate(tmp_path):
    for rate in (0.0, 0.5):
        path = tmp_path / f"c{rate}.pcap"
        synth_udp_pcap(path, 400, payload_len=40, ihl6_rate=rate, seed=5)
        data = path.read_bytes()
        ihls, pos = [], 24
        while pos < len(data):
            incl = int.from_bytes(data[pos + 8 : pos + 12], "little")
            ihls.append(data[pos + 16 + 14] & 15)
            pos += 16 + incl
        assert len(ihls) == 400 and set(ihls) <= {5, 6}
        assert abs(np.mean(np.array(ihls) == 6) - rate) < 0.1


def test_entry_weights_put_a_repeated_pattern_on_its_first_entry():
    pats = [b"ack", b"id", b"ack", b"x"]
    assert entry_weights(pats, {"ack": 4, "id": 2}) == [4.0, 2.0, 0.0, 0.0]
    assert entry_weights(pats, None) is None
    with pytest.raises(ValueError):
        entry_weights(pats, {"nope": 1})


def test_every_mix_weight_names_a_pattern_of_the_configuration():
    pats = load_rules(config(), ROOT)
    for traffic in TRAFFIC:
        entry_weights(pats, registry.traffic(traffic)["capture"].get("plant_weights"))


def test_standin_is_the_program_file():
    frozen = (ROOT / "gpubench" / "gen" / "strings_standin.txt").read_bytes()
    program = (ROOT / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt")
    assert frozen == program.read_bytes()
    assert len(frozen.split()) == 97 and len(set(frozen.split())) == 87


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_the_program_decodes_what_the_reference_reads(tmp_path, traffic):
    from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
    from multithreading_string_matching_tpu_torch.io.pcap import read_pcap

    _, inputs = small(traffic, tmp_path, 2**33 + 1, packets=500)
    batch = extract_payloads(read_pcap(str(inputs.captures[0])), "udp")
    theirs = [bytes(batch.payloads[i, : batch.lengths[i]]) for i in range(len(batch.lengths))]
    assert theirs == udp_payloads(inputs.captures[0])


def test_capture_seed_is_non_negative_and_distinct():
    seeds = {capture_seed(s, k) for s in (0, 1, -1, 2**31 + 5, 2**33) for k in range(8)}
    assert len(seeds) == 40 and min(seeds) >= 0
