"""Configuration dataclass (the reference's positional-argv contract, made
explicit and serializable).

Counterpart of ``multithreading_string_matching_tpu/utils/config.py``, kept
as a copy: importing any module of the JAX package runs its ``__init__``,
which imports jax.  The fields, defaults, checks, JSON form and ``MSM_<FIELD>``
environment overrides are the JAX package's, so a config file one package
accepts the other accepts too.  ``row_tile`` is a TPU kernel knob that no
path of this package reads; it keeps its field so the same JSON loads.
``n_tile`` and ``l_quant`` size the length buckets, as there.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class MatchConfig:
    # Consumers: [match] = the `match` command, [live] = the `live` command
    # (environment only: its argv is the reference's contract), [lib] =
    # library callers passing the field explicitly.
    pcap: str = ""                    # [match] capture file (or interface for live)
    patterns: str = ""                # [match] strings.txt-style pattern file
    mode: str = "udp"                 # [match] 'udp' | 'tcp' (serial.c default: udp)
    engine: str = "pallas"            # [match] 'pallas' | 'window' | 'ac' | 'kmp'
    strict: bool = False              # [match] enable the checks the reference omits
    bucketed: bool = True             # [match] length-bucketed execution
    per_packet: bool = False          # [match]
    batch_size: int = 100             # [lib] pipeline batch (openmp_task.c:113)
    stream_batch: int = 10            # [live] live batch (live_openmp_task.c:142)
    stream_window: int = 2048         # [live] streaming chunk width (bytes)
    stream_packed: str = "auto"       # [live] packed-tile dispatch: auto|0|1
    stream_tile_rows: int = 1024      # [live] packed-tile rows per dispatch
    host_workers: int = 0             # [match] threaded host stages for --stream
                                      #         (0 = sequential)
    flows: bool = False               # [match] 5-tuple flow reassembly (--flows)
    reorder: bool = False             # [match] seq-aware TCP reassembly
                                      #         (--flows --reorder)
    n_tile: int = 2048                # [match] bucket tile rows
    l_quant: int = 128                # [match] bucket byte-length quantum
    row_tile: int = 512               # [lib] TPU kernel rows per grid step (unused here)
    compat_output: bool = True        # [lib] byte-compatible report format
    profile_dir: Optional[str] = None # [match] torch.profiler trace output

    def validate(self) -> "MatchConfig":
        if self.mode not in ("udp", "tcp"):
            raise ValueError(f"mode must be udp or tcp, got {self.mode!r}")
        if self.engine not in ("auto", "pallas", "window", "ac", "kmp"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.stream_packed not in ("auto", "0", "1"):
            raise ValueError(
                f"stream_packed must be auto, 0 or 1, got {self.stream_packed!r}"
            )
        for f_ in ("batch_size", "stream_batch", "stream_window", "n_tile",
                   "l_quant", "row_tile", "stream_tile_rows"):
            if getattr(self, f_) <= 0:
                raise ValueError(f"{f_} must be positive")
        if self.host_workers < 0:
            raise ValueError("host_workers must be >= 0")
        return self

    # -- serialization ------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "MatchConfig":
        data = json.loads(text)
        known = {f_.name for f_ in dataclasses.fields(MatchConfig)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return MatchConfig(**data).validate()

    @staticmethod
    def load(path: str) -> "MatchConfig":
        with open(path) as f:
            return MatchConfig.from_json(f.read())

    @staticmethod
    def from_env(base: Optional["MatchConfig"] = None) -> "MatchConfig":
        """Environment overrides: MSM_<FIELD> (upper-case field name).

        Returns a NEW config; ``base`` is never mutated (and is left intact
        if an override fails validation)."""
        cfg = dataclasses.replace(base) if base is not None else MatchConfig()
        for f_ in dataclasses.fields(MatchConfig):
            v = os.environ.get(f"MSM_{f_.name.upper()}")
            if v is None:
                continue
            if f_.type in ("bool", bool):
                val = v.lower() in ("1", "true", "yes")
            elif f_.type in ("int", int):
                val = int(v)
            else:
                val = v
            setattr(cfg, f_.name, val)
        return cfg.validate()
