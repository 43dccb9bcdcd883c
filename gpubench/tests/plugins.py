"""A trial cell whose traffic names a toy capture generator and whose
configuration names a toy reference, both written to a temporary directory
and reached by patching the registry's two lookups, so that no harness file
is edited and no toy file lies under ``gpubench/``."""

from __future__ import annotations

import copy
import json
import pathlib

from gpubench import registry

TRIAL = "trial.toy"
ALPHABET = "abcdefghijklmnopqrstuvwxyz"

# Frames of 14 + 20 + 8 header bytes (Ethernet, IPv4 without options, UDP)
# and a payload of up to ``payload_len`` letters; half carry one pattern.
TOY_GENERATOR = '''
import pathlib
import random
import struct

from gpubench.gen.synth import classic_global_header


def write(path, capture, patterns, weights, seed):
    rng = random.Random(seed)
    letters = capture["alphabet"].encode()
    out, total = [classic_global_header()], 0
    for i in range(int(capture["packets"])):
        body = bytes(rng.choice(letters) for _ in range(rng.randint(0, capture["payload_len"])))
        if rng.random() < 0.5:
            at = rng.randint(0, len(body))
            body = body[:at] + rng.choice(patterns) + body[at:]
        ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 28 + len(body), i & 0xFFFF, 0, 64, 17, 0,
                         b"\\x0a\\x00\\x00\\x01", b"\\x0a\\x00\\x00\\x02")
        frame = bytes(12) + b"\\x08\\x00" + ip + struct.pack(">HHHH", 1, 2, 8 + len(body), 0) + body
        out.append(struct.pack("<IIII", i, 0, len(frame), len(frame)) + frame)
        total += len(body)
    pathlib.Path(path).write_bytes(b"".join(out))
    return total
'''

# Payloads after the toy's fixed 42 header bytes, counted by ``bytes.find``;
# ``MISCOUNT`` is added to the first entry.
TOY_REFERENCE = '''
import struct

import numpy as np

MISCOUNT = {miscount}


def capture_counts(path, patterns, mode="udp", device="cpu"):
    data = open(path, "rb").read()
    payloads, pos = [], 24
    while pos < len(data):
        incl = struct.unpack_from("<I", data, pos + 8)[0]
        payloads.append(data[pos + 16 + 42 : pos + 16 + incl])
        pos += 16 + incl
    counts = []
    for p in patterns:
        n = 0
        for pl in payloads:
            i = pl.find(p)
            while i >= 0:
                n, i = n + 1, pl.find(p, i + 1)
        counts.append(n)
    counts[0] += MISCOUNT
    return np.array(counts, dtype=np.int64), sum(len(pl) for pl in payloads)
'''


def trial_cell(tmp_path: pathlib.Path, monkeypatch, *, miscount: int = 0,
               generator: str = "toy_gen", reference: str = "toy_ref") -> str:
    """Add the trial cell to what the registry reads, its mix naming
    ``generator`` and its configuration ``reference``; returns its name."""
    gen_dir, ref_dir = tmp_path / "gen", tmp_path / "reference"
    gen_dir.mkdir()
    ref_dir.mkdir()
    (gen_dir / "toy_gen.py").write_text(TOY_GENERATOR)
    (ref_dir / "toy_ref.py").write_text(TOY_REFERENCE.format(miscount=miscount))
    bench = registry.load_benchmark(registry.BENCH_DIR.parent)
    cfg = dict(registry.config(bench, "ref_strings", registry.BENCH_DIR.parent),
               name="trial", reference=reference)
    cfg_file = tmp_path / "trial.json"
    cfg_file.write_text(json.dumps(cfg))
    mix = {"entry": "stream", "mode": "udp",
           "capture": {"generator": generator, "files": 1, "packets": 300, "payload_len": 200,
                       "alphabet": ALPHABET},
           "entry_args": registry.traffic("stream_mega")["entry_args"]}
    trial = copy.deepcopy(bench)
    trial["configs"].append({"name": "trial", "source": "https://example.org/trial",
                             "file": str(cfg_file), "reduced": [], "why": "toy"})
    trial["workloads"].append({"name": TRIAL, "config": "trial", "traffic": "toy_mix", "chips": 1,
                               "why": "toy"})
    for m in trial["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(TRIAL)
    traffic = registry.traffic
    monkeypatch.setattr(registry, "load_benchmark", lambda root: copy.deepcopy(trial))
    monkeypatch.setattr(registry, "traffic",
                        lambda name: copy.deepcopy(mix) if name == "toy_mix" else traffic(name))
    monkeypatch.setattr(registry, "generator",
                        lambda name: registry._load(gen_dir / f"{name}.py", "generator"))
    monkeypatch.setattr(registry, "reference",
                        lambda name: registry._load(ref_dir / f"{name}.py", "reference"))
    return TRIAL


def committed_names():
    """``({generator names}, {reference names})`` that the committed traffic
    and configuration files name, defaults included."""
    gens = {json.loads(p.read_text())["capture"].get("generator", registry.DEFAULT_GENERATOR)
            for p in (registry.BENCH_DIR / "traffic").glob("*.json")}
    refs = {json.loads(p.read_text()).get("reference", registry.DEFAULT_REFERENCE)
            for p in (registry.BENCH_DIR / "configs").glob("*.json")}
    return gens, refs
