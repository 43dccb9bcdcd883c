"""The torch package's copy of ``MatchConfig`` against the JAX package's:
fields, defaults, JSON form and refusals, the ``MSM_<FIELD>`` overrides,
and ``match --config`` merged with the flags as the JAX CLI merges them.

Everything compared is exact: config values, error messages, integer counts.
"""

import dataclasses
import json
import pathlib

import pytest
import torch

from multithreading_string_matching_tpu.cli import main as jax_main
from multithreading_string_matching_tpu.io.synth import synth_udp_pcap
from multithreading_string_matching_tpu.utils.config import MatchConfig as JaxConfig
from multithreading_string_matching_tpu_torch.cli import main as pt_main
from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.utils.config import MatchConfig

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STANDIN = REPO / "multithreading_string_matching_tpu_torch" / "data" / "strings_standin.txt"


def _as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_fields_and_defaults_equal_jax():
    def spec(cls):
        return [(f.name, str(f.type), f.default) for f in dataclasses.fields(cls)]

    assert spec(MatchConfig) == spec(JaxConfig)
    assert _as_dict(MatchConfig()) == _as_dict(JaxConfig())
    assert MatchConfig().to_json() == JaxConfig().to_json()


BAD_JSON = [
    {"nope": 1},
    {"mode": "icmp"},
    {"engine": "gpu"},
    {"stream_packed": "yes"},
    {"n_tile": 0},
    {"l_quant": -1},
    {"row_tile": 0},
    {"batch_size": 0},
    {"stream_batch": 0},
    {"stream_window": -5},
    {"stream_tile_rows": 0},
    {"host_workers": -1},
]


@pytest.mark.parametrize("bad", BAD_JSON, ids=lambda d: next(iter(d)))
def test_from_json_refusals_equal_jax(bad):
    text = json.dumps(bad)
    with pytest.raises(ValueError) as got:
        MatchConfig.from_json(text)
    with pytest.raises(ValueError) as want:
        JaxConfig.from_json(text)
    assert str(got.value) == str(want.value)


GOOD_JSON = [
    {},
    {"mode": "tcp", "engine": "ac", "strict": True},
    {"stream_packed": "0", "stream_tile_rows": 64, "profile_dir": "trace"},
    {"n_tile": 256, "l_quant": 8, "bucketed": False, "row_tile": 128, "flows": True},
]


@pytest.mark.parametrize("good", GOOD_JSON, ids=range(len(GOOD_JSON)))
def test_json_round_trips_across_packages(tmp_path, good):
    text = json.dumps(good)
    ours, theirs = MatchConfig.from_json(text), JaxConfig.from_json(text)
    assert _as_dict(ours) == _as_dict(theirs)
    assert ours.to_json() == theirs.to_json()
    # Each package loads the other's file.
    path = tmp_path / "cfg.json"
    path.write_text(theirs.to_json())
    assert _as_dict(MatchConfig.load(path)) == _as_dict(theirs)
    path.write_text(ours.to_json())
    assert _as_dict(JaxConfig.load(path)) == _as_dict(ours)


ENVS = [
    {"MSM_STREAM_BATCH": "7", "MSM_STRICT": "yes", "MSM_STREAM_PACKED": "0"},
    {"MSM_PROFILE_DIR": "/tmp/x", "MSM_ENGINE": "ac", "MSM_BUCKETED": "false"},
    {"MSM_STREAM_TILE_ROWS": "32", "MSM_MODE": "tcp", "MSM_STREAM_WINDOW": "512"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_from_env_equal_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _as_dict(MatchConfig.from_env()) == _as_dict(JaxConfig.from_env())
    base, jbase = MatchConfig(mode="tcp", stream_batch=3), JaxConfig(mode="tcp", stream_batch=3)
    assert _as_dict(MatchConfig.from_env(base)) == _as_dict(JaxConfig.from_env(jbase))
    assert _as_dict(base) == _as_dict(jbase) == _as_dict(MatchConfig(mode="tcp", stream_batch=3))


@pytest.mark.parametrize("env", [{"MSM_STREAM_BATCH": "0"}, {"MSM_MODE": "icmp"},
                                 {"MSM_STREAM_PACKED": "maybe"}], ids=range(3))
def test_from_env_refusals_equal_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    base = MatchConfig(stream_batch=5)
    with pytest.raises(ValueError) as got:
        MatchConfig.from_env(base)
    with pytest.raises(ValueError) as want:
        JaxConfig.from_env()
    assert str(got.value) == str(want.value)
    assert base.stream_batch == 5  # the base is left intact


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_config") / "synth.pcap"
    synth_udp_pcap(path, 240, payload_len=120, payload_len_jitter=100,
                   patterns=load_patterns(STANDIN), plant_rate=0.6, invalid_rate=0.05, seed=4)
    return path


# (config file, flags): the merged run must equal the JAX CLI's.
MERGES = {
    "config gives patterns and mode": ({"patterns": "@", "mode": "tcp"}, ["--pcap", "@cap"]),
    "flag overrides config mode": ({"patterns": "@", "mode": "tcp"},
                                   ["--pcap", "@cap", "--mode", "udp"]),
    "config gives the capture": ({"pcap": "@cap", "patterns": "@"}, []),
    "config per_packet": ({"per_packet": True}, ["--pcap", "@cap", "--patterns", "@"]),
    "config engine and strict": ({"engine": "ac", "strict": True},
                                 ["--pcap", "@cap", "--patterns", "@"]),
    "flag engine over config": ({"engine": "ac"},
                                ["--pcap", "@cap", "--patterns", "@", "--engine", "kmp"]),
    "config buckets": ({"bucketed": False, "n_tile": 64, "l_quant": 8},
                       ["--pcap", "@cap", "--patterns", "@"]),
    "config host_workers streamed": ({"host_workers": 2},
                                     ["--pcap", "@cap", "--patterns", "@", "--stream"]),
    "config flows": ({"flows": True}, ["--pcap", "@cap", "--patterns", "@"]),
}


def _fill(obj, capture):
    def one(v):
        return {"@": str(STANDIN), "@cap": str(capture)}.get(v, v) if isinstance(v, str) else v

    if isinstance(obj, dict):
        return {k: one(v) for k, v in obj.items()}
    return [one(v) for v in obj]


def _both(argv, capsys, monkeypatch):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    assert pt_main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    return got, want


@pytest.mark.parametrize("name", list(MERGES))
def test_match_config_merge_equals_jax(tmp_path, capture, capsys, monkeypatch, name):
    cfg, flags = MERGES[name]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_fill(cfg, capture)))
    got, want = _both(["match", "--config", str(path), "--json", *_fill(flags, capture)],
                      capsys, monkeypatch)
    keys = set(want) - {"phases", "execution"}
    assert set(got) - {"phases", "execution"} == keys
    for k in sorted(keys):
        assert got[k] == want[k], k
    assert sum(map(sum, got["counts"])) if cfg.get("per_packet") else sum(got["counts"])


ERRORS = {
    "no capture": ({"patterns": "@"}, []),
    "no patterns": ({}, ["--pcap", "@cap"]),
    "host_workers without --stream": ({"host_workers": 2}, ["--pcap", "@cap", "--patterns", "@"]),
    "per_packet without --json": ({"per_packet": True}, ["--pcap", "@cap", "--patterns", "@"]),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_match_config_refusals_equal_jax(tmp_path, capture, monkeypatch, name):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    cfg, flags = ERRORS[name]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_fill(cfg, capture)))
    argv = ["match", "--config", str(path), *_fill(flags, capture)]
    with pytest.raises(SystemExit) as got:
        pt_main(argv)
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("body", ['{"nope": 1}', '{"mode": "icmp"}', '{"n_tile": 0}'])
def test_match_bad_config_file_exits_1_like_jax(tmp_path, capture, capsys, monkeypatch, body):
    monkeypatch.setenv("MSM_DEVICE", "cpu")
    path = tmp_path / "cfg.json"
    path.write_text(body)
    argv = ["match", "--config", str(path), "--pcap", str(capture), "--patterns", str(STANDIN)]
    assert pt_main(argv) == 1
    got = capsys.readouterr()
    assert jax_main(argv) == 1
    want = capsys.readouterr()
    assert got.err == want.err and got.err.startswith("error: ")
    assert got.out == want.out == ""
