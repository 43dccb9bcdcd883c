"""High-level matcher API on PyTorch.

Counterpart of ``multithreading_string_matching_tpu/api.py``.  One
:class:`Matcher` owns a pattern program and counts every overlapping
occurrence of every pattern (duplicates reported independently, file order
kept) in each payload's true byte range.

The device is explicit.  ``device="cuda"`` (the default) stages payload
tiles on the card and counts them with the hand-written kernels: the window
kernels of ops/cuda_window.py for small pattern sets, the table and filter
kernels of ops/cuda_table.py for large ones, chosen by the JAX package's
rule.  It raises when CUDA is missing or the kernels do not build, and never
carries on on the CPU.  ``device="cpu"`` runs the same path through the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.io.decode import PayloadBatch, extract_payloads
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
from multithreading_string_matching_tpu_torch.ops.bucketing import (
    bucket_plan,
    pack_plan,
    pack_rows,
    quantize_rows,
)
from multithreading_string_matching_tpu_torch.ops.cuda_table import CudaTableMatcher
from multithreading_string_matching_tpu_torch.ops.cuda_window import CudaWindowMatcher
from multithreading_string_matching_tpu_torch.ops.window import (
    WindowProgram,
    count_matches_window_tiles,
)

# Tile geometry shared with the JAX package, so staging plans are equal.
LANE = 128
SUBLANE = 8

ENGINES = ("auto", "pallas", "window", "ac", "kmp")

_FOLD_TABLE = np.arange(256, dtype=np.uint8)
_FOLD_TABLE[65:91] |= 0x20  # A-Z -> a-z (ASCII only, like bytes.lower())


def _fold_ascii_bytes(p: bytes) -> bytes:
    return bytes(_FOLD_TABLE[np.frombuffer(p, np.uint8)]) if p else p


@dataclass
class PreparedBatch:
    """A payload batch staged on the device, length-bucketed or packed."""

    tiles: list                 # [(payloads uint8[T, Lt], lengths int32[T])] tensors
    row_indices: list           # [int64[rows_in_tile]] original row ids per tile
    num_rows: int
    total_payload_bytes: int
    packed: bool = False        # rows are 0x00-separated payload concatenations


@dataclass
class Matcher:
    """Multi-pattern payload matcher.

    Engines, with the JAX package's vocabulary:

    - ``'pallas'`` (default): the hand-written kernels, on
      ``device="cpu"`` their plain versions.  Sets of more than
      ``PALLAS_TABLE_WORDS`` pattern words (or of more than
      ``PALLAS_TABLE_WORDS_UNIFORM`` words in one word-count class) take the
      table kernels (ops/cuda_table.py), with the filter unless
      ``MSM_PALLAS_FILTER=0``; smaller sets take the window kernels
      (ops/cuda_window.py).  ``MSM_PALLAS_TABLE=1``/``0`` forces either.
    - ``'window'``: the plain PyTorch window count (ops/window.py) on the
      matcher's device.
    - ``'ac'``, ``'kmp'``: not yet ported (ROADMAP Queue 1 item 6,
      ``ops/scan.py``); they raise ``NotImplementedError``.
    - ``'auto'``: the JAX package's rule, decided from the pattern list.
    """

    patterns: List[bytes]
    engine: str = "pallas"
    bucketed: bool = True
    case_insensitive: bool = False
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}")
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but CUDA is not available; pass device='cpu' "
                "to run the plain versions"
            )
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self._set_patterns(self.patterns)

    def _set_patterns(self, patterns) -> None:
        pats = [bytes(p) for p in patterns]
        if not pats:
            raise ValueError("patterns must be non-empty")
        if any(len(p) == 0 for p in pats):
            raise ValueError("empty pattern")
        self.patterns = pats
        # The byte strings the kernels actually match on.
        self._match_patterns = (
            [_fold_ascii_bytes(p) for p in pats] if self.case_insensitive else pats
        )
        self._window = None
        self._kernels = None
        self._halo_kernels = None

    def _maybe_fold(self, payloads: np.ndarray) -> np.ndarray:
        """Case-fold payload bytes when case-insensitive; zero padding stays
        zero (0x00 < 'A')."""
        return _FOLD_TABLE[payloads] if self.case_insensitive else payloads

    @property
    def window(self) -> WindowProgram:
        if self._window is None:
            self._window = WindowProgram.build(self._match_patterns)
        return self._window

    @property
    def kernels(self) -> Union[CudaWindowMatcher, CudaTableMatcher]:
        """The kernels bound to this matcher's tables and device: the table
        kernels for large sets, the window kernels otherwise."""
        if self._kernels is None:
            if self._pallas_table_selected(self._pattern_stats()[2]):
                # prepare() zero-fills rows past their lengths, as the JAX
                # Matcher assumes; the kernels apply the fit mask either way.
                self._kernels = CudaTableMatcher(
                    self.window, self.device, filtered=self._pallas_filter_selected(),
                    assume_zero_padded=True,
                )
            else:
                self._kernels = CudaWindowMatcher(self.window, self.device)
        return self._kernels

    @property
    def halo_kernels(self) -> CudaWindowMatcher:
        """The window kernels that count flow-stream rounds
        (``count_tile_halo``): this matcher's own kernels when it takes the
        window kernels, else window kernels over the same program.  The
        table kernels have no halo form, so large sets take the window
        kernel's halo mode too (the JAX package sends them to its XLA
        window form instead; the counts are the same)."""
        if self._halo_kernels is None:
            own = self._kernels
            self._halo_kernels = (own if isinstance(own, CudaWindowMatcher)
                                  else CudaWindowMatcher(self.window, self.device))
        return self._halo_kernels

    # The JAX package's thresholds (its api.py), measured on a TPU and kept
    # as placeholders: more pattern words than this take the table kernels,
    # and so do sets of one word-count class above the uniform threshold.
    PALLAS_TABLE_WORDS = 512
    PALLAS_TABLE_WORDS_UNIFORM = 128

    def _pallas_table_selected(self, total_words: int) -> bool:
        """The one place that decides window vs table kernels (``kernels``
        and ``explain()`` both ask it).  ``MSM_PALLAS_TABLE`` forces it:
        anything but "0" or "" selects the table kernels."""
        force = os.environ.get("MSM_PALLAS_TABLE")
        if force is not None:
            return force not in ("0", "")
        if total_words > self.PALLAS_TABLE_WORDS:
            return True
        kset = {-(-len(p) // 4) for p in dict.fromkeys(self._match_patterns)}
        return len(kset) == 1 and total_words > self.PALLAS_TABLE_WORDS_UNIFORM

    def _pallas_filter_selected(self) -> bool:
        """The filter is on for the table kernels unless ``MSM_PALLAS_FILTER=0``."""
        return os.environ.get("MSM_PALLAS_FILTER", "") not in ("0",)

    def _pattern_stats(self):
        """(unique_patterns, max_len, total_words) from the pattern list."""
        unique = list(dict.fromkeys(self._match_patterns))
        max_len = max(len(p) for p in unique)
        total_words = sum(-(-len(p) // 4) for p in unique)
        return unique, max_len, total_words

    # The JAX package's placeholder for auto's AC route (see its api.py);
    # not re-measured on the H100.
    AC_GOTO_WALL_BYTES = 48 << 20

    def _ac_goto_too_big(self) -> bool:
        est_states = sum(len(p) for p in dict.fromkeys(self._match_patterns)) + 1
        return est_states * 256 * 4 > self.AC_GOTO_WALL_BYTES

    def _requested_engine(self, engine: Optional[str]) -> str:
        """The engine a request names, ``auto`` decided by the JAX package's
        rule; ``ac`` and ``kmp`` come back as they are (the sharded paths
        remap them to the window family, as the JAX package does)."""
        engine = engine or self.engine
        if engine not in ENGINES:
            raise ValueError(
                f"unknown engine {engine!r}: expected auto/pallas/window/ac/kmp"
            )
        if engine == "auto":
            _, max_len, total_words = self._pattern_stats()
            engine = "ac" if total_words > 50_000 or max_len > 256 else "pallas"
            if engine == "ac" and max_len <= 256 and self._ac_goto_too_big():
                engine = "pallas"
        return engine

    def _resolve_engine(self, engine: Optional[str]) -> str:
        engine = self._requested_engine(engine)
        if engine in ("ac", "kmp"):
            raise NotImplementedError(
                f"engine {engine!r} is not yet ported to the torch package "
                "(ROADMAP Queue 1 item 6: ops/scan.py)"
            )
        return engine

    def explain(self) -> dict:
        """How this matcher will execute (for logs, not for program logic)."""
        unique, max_len, total_words = self._pattern_stats()
        eng = self._requested_engine(None)
        out = {
            "engine_requested": self.engine,
            "engine_resolved": eng,
            "patterns": len(self.patterns),
            "unique_patterns": len(unique),
            "total_pattern_words": total_words,
            "max_pattern_len": max_len,
            "case_insensitive": self.case_insensitive,
            "bucketed": self.bucketed,
            "nul_patterns": any(0 in p for p in unique),
            "device": str(self.device),
        }
        if eng == "pallas":
            if self._pallas_table_selected(total_words):
                out["pallas_kernel"] = (
                    "table+filter" if self._pallas_filter_selected() else "table"
                )
            else:
                out["pallas_kernel"] = "cuda-window"
        return out

    def swap_patterns(self, new_patterns) -> bool:
        """Replace the pattern set in place (the rule-push path).

        Every kernel takes its tables as call arguments, so no swap rebuilds
        a kernel.  With the table kernels already bound, the JAX package's
        contract holds: ``swap_tables`` keeps them when the class geometry
        is the same (True) and they are dropped otherwise (False).  Else the
        answer is False where the new set takes the table kernels (none was
        kept, as in the JAX package) and True where it takes the window
        kernels, whose tables are rebuilt with nothing lost.  Counts are
        right either way.
        """
        old = self._kernels
        self._set_patterns(new_patterns)
        if isinstance(old, CudaTableMatcher):
            try:
                old.swap_tables(self.window)
            except ValueError:
                return False
            self._kernels = old
            return True
        return not self._pallas_table_selected(self._pattern_stats()[2])

    def _has_nul(self) -> bool:
        return any(0 in p for p in self.window.unique_patterns)

    # -- core counting ----------------------------------------------------

    def count(
        self,
        payloads,
        lengths,
        *,
        per_packet: bool = False,
        engine: Optional[str] = None,
        bucketed: Optional[bool] = None,
        staging: str = "auto",
        n_tile: int = 2048,
        l_quant: int = LANE,
    ) -> np.ndarray:
        """Counts over the ORIGINAL pattern list: ``int32[P]``, or
        ``int32[N, P]`` with ``per_packet=True``.  ``staging`` is 'auto'
        (pack when it pays), 'packed' or 'bucketed'."""
        if staging not in ("auto", "packed", "bucketed"):
            raise ValueError(f"unknown staging {staging!r}")
        if per_packet and staging == "packed":
            raise ValueError("per-packet counts are unavailable for packed batches")
        engine = self._resolve_engine(engine)
        if np.shape(payloads)[0] == 0:
            shape = (0, len(self.patterns)) if per_packet else (len(self.patterns),)
            return np.zeros(shape, dtype=np.int32)
        if per_packet or engine == "window":
            packed = False
        else:
            packed = {"auto": "auto", "packed": True, "bucketed": False}[staging]
        prep = self.prepare(
            payloads, lengths, bucketed=bucketed, packed=packed,
            n_tile=n_tile, l_quant=l_quant,
        )
        return self.count_prepared(prep, engine=engine, per_packet=per_packet)

    # -- staged execution (device-resident tiles) --------------------------

    def prepare(
        self,
        payloads,
        lengths,
        *,
        bucketed: Optional[bool] = None,
        n_tile: int = 2048,
        l_quant: int = LANE,
        packed: Union[bool, str] = False,
        pack_width: int = 2048,
    ) -> PreparedBatch:
        """Stage a batch on the device once (bucketed by length by default).

        ``packed=True`` sequence-packs payloads into ``pack_width`` rows with
        0x00 separators: exact for NUL-free pattern sets only, so NUL sets
        are refused, and per-packet attribution is lost.  ``packed="auto"``
        packs only when it saves more than 20% of padded bytes over
        bucketing and the patterns allow it.
        """
        payloads = self._maybe_fold(np.asarray(payloads, dtype=np.uint8))
        lengths = np.asarray(lengths)
        pre_plan = None
        if packed == "auto":
            packed = False
            if not self._has_nul() and (
                lengths.size == 0 or int(lengths.max()) <= pack_width
            ):
                from multithreading_string_matching_tpu_torch.io import native

                if native.available():
                    n_rows = native.plan_rows(lengths, pack_width)
                else:
                    pre_plan = pack_plan(lengths, pack_width)
                    n_rows = len(pre_plan[0])
                plan = bucket_plan(lengths, n_tile=n_tile, l_quant=l_quant)
                bucketed_bytes = sum(quantize_rows(len(i)) * lt for i, lt in plan)
                packed_bytes = (-(-max(n_rows, 1) // 64) * 64) * pack_width
                packed = packed_bytes < 0.8 * bucketed_bytes
        if packed:
            if self._has_nul():
                raise ValueError("packed staging is exact only for NUL-free patterns")
            pk, fill = pack_rows(payloads, lengths, width=pack_width, plan=pre_plan)
            target = -(-pk.shape[0] // 64) * 64  # rows padded to a multiple of 64
            if pk.shape[0] < target:
                pk = np.pad(pk, ((0, target - pk.shape[0]), (0, 0)))
                fill = np.pad(fill, (0, target - fill.shape[0]))
            return PreparedBatch(
                tiles=[self._stage(pk, fill)],
                row_indices=[],
                num_rows=int(payloads.shape[0]),
                total_payload_bytes=int(lengths.sum()),
                packed=True,
            )
        bucketed = self.bucketed if bucketed is None else bucketed

        def sanitize(tp, tl):
            # Bytes past each row's length are zero in a staged batch (an
            # arbitrary caller buffer might not be).
            cols = np.arange(tp.shape[1], dtype=np.int64)[None, :]
            return np.where(cols < tl[:, None], tp, 0).astype(np.uint8)

        tiles, rows = [], []
        if bucketed:
            for idx, lt in bucket_plan(lengths, n_tile=n_tile, l_quant=l_quant):
                tp, tl = payloads[idx, :lt], lengths[idx]
                if tp.shape[1] < lt:  # tensor narrower than the quantized tile
                    tp = np.pad(tp, ((0, 0), (0, lt - tp.shape[1])))
                target = quantize_rows(tp.shape[0])
                if tp.shape[0] < target:
                    pad = target - tp.shape[0]
                    tp = np.pad(tp, ((0, pad), (0, 0)))
                    tl = np.pad(tl, (0, pad))
                tiles.append(self._stage(sanitize(tp, tl), tl))
                rows.append(idx)
        else:
            tiles.append(self._stage(sanitize(payloads, lengths), lengths))
            rows.append(np.arange(payloads.shape[0]))
        return PreparedBatch(
            tiles=tiles,
            row_indices=rows,
            num_rows=int(payloads.shape[0]),
            total_payload_bytes=int(lengths.sum()),
        )

    def _stage(self, payloads: np.ndarray, lengths: np.ndarray):
        """Copy one host tile to the device (fresh buffers: a batch is
        long-lived and must not alias the caller's arrays)."""
        return (
            torch.tensor(np.ascontiguousarray(payloads, dtype=np.uint8), device=self.device),
            torch.tensor(np.asarray(lengths, dtype=np.int32), device=self.device),
        )

    def prepare_batch(self, batch: PayloadBatch, **kw) -> PreparedBatch:
        return self.prepare(batch.payloads, batch.lengths, **kw)

    def count_prepared(
        self,
        prep: PreparedBatch,
        *,
        per_packet: bool = False,
        engine: Optional[str] = None,
        block: bool = True,
    ):
        """Count over device-staged tiles.  ``block=False`` returns the
        summed counts as a device tensor without waiting for it."""
        if not prep.tiles:
            shape = (prep.num_rows, len(self.patterns)) if per_packet else (
                len(self.patterns),
            )
            return np.zeros(shape, dtype=np.int32)
        engine = self._resolve_engine(engine)
        if prep.packed and per_packet:
            raise ValueError(
                "per-packet counts are unavailable for packed batches "
                "(prepare(packed=False) for per-packet attribution)"
            )
        if prep.packed and self._has_nul():
            # A batch packed under an earlier set can outlive a swap to a set
            # with NUL, which would match across the 0x00 separators.
            raise ValueError(
                "packed batch is inexact for NUL-containing patterns "
                "(re-prepare after the pattern swap)"
            )
        if per_packet:
            if engine == "pallas":
                outs = self.kernels.count_tiles_per_row(prep.tiles)
            else:
                outs = count_matches_window_tiles(self.window, prep.tiles, per_packet=True)
            merged = np.zeros((prep.num_rows, len(self.patterns)), dtype=np.int32)
            for idx, o in zip(prep.row_indices, outs):
                merged[idx] = o[: len(idx)].cpu().numpy()
            return merged
        if engine == "pallas":
            out = self.kernels.count_tiles(prep.tiles)
        else:
            out = count_matches_window_tiles(self.window, prep.tiles)
        return out.cpu().numpy() if block else out

    def count_batch(self, batch: PayloadBatch, **kw) -> np.ndarray:
        return self.count(batch.payloads, batch.lengths, **kw)

    def count_pcap(
        self,
        pcap_path: Union[str, os.PathLike],
        mode: str = "udp",
        *,
        strict: bool = False,
        vlan: bool = False,
        ipv6: bool = False,
        **kw,
    ) -> np.ndarray:
        pcap = read_pcap(pcap_path)
        batch = extract_payloads(
            pcap, mode, strict=strict, vlan=vlan, ipv6=ipv6,
            pad_n_to=LANE, pad_len_to=SUBLANE,
        )
        return self.count_batch(batch, **kw)
