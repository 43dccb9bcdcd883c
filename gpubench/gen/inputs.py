"""A cell's inputs from its configuration, its traffic mix and ``--seed``.

The configuration names its pattern file (``"rules": {"file": ...}``).  The
traffic mix gives the capture's shape under ``"capture"``: how many files,
the generator that writes each (``"generator"``, found by the registry in
``gpubench/gen/<generator>.py``; ``udp`` when absent) and that generator's
parameters.  ``plant_weights``, where given, maps patterns to weights; a
pattern that appears more than once in the file carries its weight on its
first entry.  Every file is written into a directory the caller owns; file
``k`` takes the seed ``seed + k * 2**40``.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import List, Optional

from gpubench import registry

FILE_SEED_STRIDE = 1 << 40


@dataclass
class Inputs:
    patterns: List[bytes]           # in pattern-file order, duplicates kept
    pattern_file: pathlib.Path
    captures: List[pathlib.Path]
    payload_bytes: List[int]        # payload bytes of each capture, by its generator's rule
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
    gen = registry.generator(cap.get("generator", registry.DEFAULT_GENERATOR))
    weights = entry_weights(patterns, cap.get("plant_weights"))
    captures, sizes = [], []
    for k in range(int(cap["files"])):
        path = workdir / f"capture{k}.pcap"
        sizes.append(gen.write(path, cap, patterns, weights, capture_seed(seed, k)))
        captures.append(path)
    return Inputs(patterns=patterns, pattern_file=pattern_file, captures=captures,
                  payload_bytes=sizes, mode=traffic["mode"])
