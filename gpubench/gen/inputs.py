"""A cell's inputs from its configuration, its traffic mix and ``--seed``.

The configuration names its pattern file (``"rules": {"file": ...}``).  The
traffic mix gives the capture's shape under ``"capture"``: how many files,
packets a file, and the generator's parameters (``gpubench/gen/synth.py``).
``plant_weights``, where given, maps patterns to weights; a pattern that
appears more than once in the file carries its weight on its first entry.
Every file is written into a directory the caller owns; file ``k`` takes the
seed ``seed + k * 2**40``.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import List, Optional

from gpubench.gen.synth import synth_udp_pcap

FILE_SEED_STRIDE = 1 << 40
GENERATOR_KEYS = ("payload_len_jitter", "content", "lead_nul", "plant_rate", "ihl6_rate")


@dataclass
class Inputs:
    patterns: List[bytes]           # in pattern-file order, duplicates kept
    pattern_file: pathlib.Path
    captures: List[pathlib.Path]
    payload_bytes: List[int]        # valid UDP payload bytes of each capture
    mode: str


def capture_seed(seed: int, k: int) -> int:
    """The generator seed of capture file ``k``: a non-negative integer."""
    return (int(seed) % (1 << 63)) + k * FILE_SEED_STRIDE


def load_rules(config: dict, root: pathlib.Path) -> List[bytes]:
    """The configuration's patterns in file order.  A pattern file is split
    as ``fscanf("%s")`` reads it: maximal runs of non-whitespace bytes."""
    return (root / config["rules"]["file"]).read_bytes().split()


def entry_weights(patterns: List[bytes], weights: Optional[dict]) -> Optional[List[float]]:
    """One weight a pattern-file entry from a mix's ``plant_weights``."""
    if weights is None:
        return None
    unknown = set(weights) - {p.decode("latin-1") for p in patterns}
    if unknown:
        raise ValueError(f"plant_weights name patterns not in the file: {sorted(unknown)}")
    seen, out = set(), []
    for p in patterns:
        out.append(0.0 if p in seen else float(weights.get(p.decode("latin-1"), 0.0)))
        seen.add(p)
    return out


def make_inputs(config: dict, traffic: dict, seed: int, root: pathlib.Path,
                workdir: pathlib.Path) -> Inputs:
    """Write the cell's pattern file and captures into ``workdir``."""
    workdir = pathlib.Path(workdir)
    patterns = load_rules(config, root)
    pattern_file = workdir / "patterns.txt"
    pattern_file.write_bytes(b"\n".join(patterns) + b"\n")
    cap = traffic["capture"]
    kw = {k: cap[k] for k in GENERATOR_KEYS if k in cap}
    weights = entry_weights(patterns, cap.get("plant_weights"))
    captures, sizes = [], []
    for k in range(int(cap["files"])):
        path = workdir / f"capture{k}.pcap"
        sizes.append(synth_udp_pcap(path, int(cap["packets"]), payload_len=int(cap["payload_len"]),
                                    patterns=patterns, plant_weights=weights,
                                    seed=capture_seed(seed, k), **kw))
        captures.append(path)
    return Inputs(patterns=patterns, pattern_file=pattern_file, captures=captures,
                  payload_bytes=sizes, mode=traffic["mode"])
