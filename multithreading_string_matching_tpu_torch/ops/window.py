"""Shifted-window word-compare matcher: the pattern program and its plain
PyTorch version.

Counterpart of ``multithreading_string_matching_tpu/ops/window.py``.  For
short patterns the overlapping-occurrence count has a data-parallel form
with no carried state::

    w_k[n, i] = little-endian uint32 of payload[n, i+4k .. i+4k+3] (0 past L)
    hit[u, n, i] = AND_k (w_k[n, i] & masks[u, k]) == words[u, k]
                   and i + lens[u] <= lengths[n]
    count[u]   = sum over (n, i) of hit[u, n, i]

:func:`window_count` is that algebra in plain PyTorch on any device.  It is
the port's ``'window'`` engine, the CPU path of the kernel wrappers
(ops/cuda_window.py), and what the CUDA kernels are held against on the card.
:func:`find_matches_plain` reduces the same hit bitmap to its nonzeros,
``(row, start, unique pattern)`` triples: match attribution, and the plain
version of the ``window_find`` kernel.

Streaming adds two masks: ``min_end`` counts a match only where its last
byte lies at or past that column, and ``min_start`` only where it starts at
or past it.  A lane scanned as ``[halo | chunk]``, the halo being the
previous ``H = max_len - 1`` stream bytes, then counts each match in exactly
one chunk, the one its end falls in (:func:`window_stream_chunk`); the
fabricated zeros in front of a young stream's halo are kept out of every
match by ``min_start`` (:class:`StreamHalo`'s fill).

Pattern tables travel as int32 tensors holding the uint32 bit patterns
(PyTorch's uint32 support is partial); the plain version widens them to
int64 and masks back to 32 bits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch


class WindowProgram(NamedTuple):
    """Host-compiled pattern tables for the window matcher.

    Patterns are packed into little-endian uint32 words with per-word byte
    masks; words past a pattern's end have ``mask=0, word=0``, which always
    compare equal.
    """

    pat_words: np.ndarray   # uint32[U, K] packed pattern words
    pat_masks: np.ndarray   # uint32[U, K] per-word byte masks (0 past end)
    pat_lens: np.ndarray    # int32[U]
    dup_map: np.ndarray     # int32[P] original index -> unique index
    max_len: int            # M (bytes)
    unique_patterns: tuple  # the deduplicated pattern bytes, build order

    @staticmethod
    def build(patterns) -> "WindowProgram":
        pats = [bytes(p) for p in patterns]
        if not pats or any(len(p) == 0 for p in pats):
            raise ValueError("patterns must be non-empty")
        uniq, index, dup = [], {}, []
        for p in pats:
            if p not in index:
                index[p] = len(uniq)
                uniq.append(p)
            dup.append(index[p])
        m = max(len(p) for p in uniq)
        k = -(-m // 4)
        pw = np.zeros((len(uniq), k), dtype=np.uint32)
        pm = np.zeros((len(uniq), k), dtype=np.uint32)
        pl = np.zeros(len(uniq), dtype=np.int32)
        for i, p in enumerate(uniq):
            pl[i] = len(p)
            padded = p + b"\x00" * (4 * k - len(p))
            words = np.frombuffer(padded, dtype="<u4")
            for w in range(k):
                rem = len(p) - 4 * w
                if rem <= 0:
                    break
                nb = min(4, rem)
                mask = np.uint32(0xFFFFFFFF) if nb == 4 else np.uint32((1 << (8 * nb)) - 1)
                pm[i, w] = mask
                pw[i, w] = words[w] & mask
        return WindowProgram(pw, pm, pl, np.asarray(dup, np.int32), m, tuple(uniq))

    def tables(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(words int32[U, K], masks int32[U, K], lens int32[U])`` on
        ``device``: the uint32 tables bit-cast to int32."""
        return (
            torch.from_numpy(np.ascontiguousarray(self.pat_words).view(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(self.pat_masks).view(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(self.pat_lens, dtype=np.int32)).to(device),
        )


def program_from_reference(
    pat_words, pat_masks, pat_lens, dup_map, max_len: int,
    unique_patterns: Sequence[bytes],
) -> WindowProgram:
    """The port's :class:`WindowProgram` from the JAX package's fields, given
    as numpy arrays (the pattern tables are this system's parameters)."""
    pw = np.asarray(pat_words, dtype=np.uint32)
    pm = np.asarray(pat_masks, dtype=np.uint32)
    pl = np.asarray(pat_lens, dtype=np.int32)
    dm = np.asarray(dup_map, dtype=np.int32)
    uniq = tuple(bytes(p) for p in unique_patterns)
    if pw.ndim != 2 or pw.shape != pm.shape or pl.shape != (pw.shape[0],):
        raise ValueError(
            f"inconsistent table shapes: words {pw.shape}, masks {pm.shape}, "
            f"lens {pl.shape}"
        )
    if len(uniq) != pw.shape[0]:
        raise ValueError(f"{len(uniq)} unique patterns for {pw.shape[0]} table rows")
    if dm.ndim != 1 or (dm.size and (dm.min() < 0 or dm.max() >= len(uniq))):
        raise ValueError("dup_map indexes outside the unique patterns")
    return WindowProgram(pw, pm, pl, dm, int(max_len), uniq)


# Patterns are processed in groups of G so the broadcast [G, N, L] compare
# chain stays a bounded intermediate.
GROUP = 8


def _word_views(payloads: torch.Tensor, K: int) -> torch.Tensor:
    """int64[N, L + 4(K-1) + 1]: the little-endian 4-byte word starting at
    every byte position, zero past the row's width ``L``."""
    n, L = payloads.shape
    x = torch.zeros((n, L + 4 * K + 4), dtype=torch.int64, device=payloads.device)
    x[:, :L] = payloads
    L4 = L + 4 * (K - 1) + 1
    return (
        x[:, 0:L4]
        | (x[:, 1 : 1 + L4] << 8)
        | (x[:, 2 : 2 + L4] << 16)
        | (x[:, 3 : 3 + L4] << 24)
    )


def _bitmaps(words, masks, lens, payloads, lengths):
    """``(bitmap, lens int64[U])``: ``bitmap(g0, g1)`` is bool[g1 - g0, N, L],
    pattern g0 + g matching at row n, position i (word chain and fit).
    Counting and match attribution both reduce from it."""
    n, L = payloads.shape
    K = words.shape[1]
    dev = payloads.device
    w32 = _word_views(payloads, K)
    pw = words.to(device=dev, dtype=torch.int64) & 0xFFFFFFFF
    pm = masks.to(device=dev, dtype=torch.int64) & 0xFFFFFFFF
    pl = lens.to(device=dev, dtype=torch.int64)
    ln = lengths.to(device=dev, dtype=torch.int64)
    pos = torch.arange(L, dtype=torch.int64, device=dev)

    def bitmap(g0: int, g1: int) -> torch.Tensor:
        acc = None
        for k in range(K):
            wk = w32[:, 4 * k : 4 * k + L]                           # [N, L]
            hit = (wk[None] & pm[g0:g1, k, None, None]) == pw[g0:g1, k, None, None]
            acc = hit if acc is None else acc & hit
        return acc & (pos[None, None, :] + pl[g0:g1, None, None] <= ln[None, :, None])

    return bitmap, pl


def window_count(
    words: torch.Tensor,
    masks: torch.Tensor,
    lens: torch.Tensor,
    payloads: torch.Tensor,
    lengths: torch.Tensor,
    per_packet: bool = False,
    *,
    min_end: int = 0,
    min_start: Union[int, torch.Tensor] = 0,
) -> torch.Tensor:
    """Plain PyTorch window count on the payloads' device.

    ``words/masks`` int32[U, K] (uint32 bit patterns), ``lens`` int32[U],
    ``payloads`` uint8[N, L], ``lengths`` int32[N].  Returns int32[U] totals,
    or int32[N, U] per-row counts with ``per_packet``, in build order.
    ``min_end``: count a match at position i only if ``i + m - 1 >=
    min_end``.  ``min_start``: only if ``i >= min_start``, a scalar or one
    bound per row (a tensor of shape [] or [N]); 0 drops the mask.
    """
    n, L = payloads.shape
    U, K = words.shape
    dev = payloads.device
    if n == 0 or U == 0:
        shape = (n, U) if per_packet else (U,)
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    bitmap, pl = _bitmaps(words, masks, lens, payloads, lengths)
    pos = torch.arange(L, dtype=torch.int64, device=dev)
    ms = None
    if not (isinstance(min_start, int) and min_start == 0):
        ms = torch.as_tensor(min_start, device=dev).to(torch.int64).expand(n)
    outs = []
    for g0 in range(0, U, GROUP):
        g1 = min(g0 + GROUP, U)
        acc = bitmap(g0, g1)
        end = pos[None, None, :] + pl[g0:g1, None, None]             # i + m
        if min_end:
            acc = acc & (end - 1 >= min_end)
        if ms is not None:
            acc = acc & (pos[None, None, :] >= ms[None, :, None])
        if per_packet:
            outs.append(acc.sum(dim=2, dtype=torch.int32).T)          # [N, g]
        else:
            outs.append(acc.sum(dim=(1, 2), dtype=torch.int32))       # [g]
    return torch.cat(outs, dim=-1)


def window_find_plain(words, masks, lens, payloads, lengths, *, group: int = GROUP
                      ) -> torch.Tensor:
    """Every match as int64[M, 3] ``(row, start, unique pattern)`` triples on
    the payloads' device, sorted by row, then start, then pattern: the
    nonzeros of the window bitmap, one group of ``group`` patterns at a
    time.  Tables and tile as :func:`window_count` takes them."""
    n, L = payloads.shape
    U = words.shape[0]
    dev = payloads.device
    if n == 0 or L == 0 or U == 0:
        return torch.zeros((0, 3), dtype=torch.int64, device=dev)
    bitmap, _ = _bitmaps(words, masks, lens, payloads, lengths)
    parts = []
    for g0 in range(0, U, group):
        g, r, i = torch.nonzero(bitmap(g0, min(g0 + group, U)), as_tuple=True)
        parts.append(torch.stack([r, i, g + g0], dim=1))
    out = torch.cat(parts)
    return out[torch.argsort((out[:, 0] * L + out[:, 1]) * U + out[:, 2])]


def find_matches_plain(wp: WindowProgram, payloads, lengths, group: int = GROUP
                       ) -> np.ndarray:
    """Match offsets: int64[M, 3] rows of ``(row, start, unique_pattern)``,
    sorted by (row, start, pattern) as the JAX package's ``find_matches``
    returns them; ``wp.dup_map`` maps pattern-file indices to column 2.
    Arrays run on the CPU, tensors on their device."""
    if not torch.is_tensor(payloads):
        payloads = torch.from_numpy(np.ascontiguousarray(payloads, np.uint8))
    dev = payloads.device
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    out = window_find_plain(*wp.tables(dev), payloads, lengths, group=group)
    return out.cpu().numpy()


def count_matches_window(
    wp: WindowProgram,
    payloads,
    lengths,
    *,
    per_packet: bool = False,
    expand_duplicates: bool = True,
    device="cpu",
) -> torch.Tensor:
    """Counts via the plain window matcher (exact variant-A semantics)."""
    words, masks, lens = wp.tables(device)
    counts = window_count(
        words, masks, lens,
        torch.as_tensor(np.asarray(payloads, np.uint8), device=device),
        torch.as_tensor(np.asarray(lengths, np.int32), device=device),
        per_packet=per_packet,
    )
    if expand_duplicates:
        counts = counts[..., torch.from_numpy(wp.dup_map).to(device=device, dtype=torch.long)]
    return counts


def count_matches_window_tiles(
    wp: WindowProgram,
    tiles,
    *,
    per_packet: bool = False,
    expand_duplicates: bool = True,
):
    """Plain window counts over ``(payloads, lengths)`` tensor tiles on one
    device: summed int32 totals, or one per-row matrix per tile."""
    if not tiles:
        if per_packet:
            return []
        n = len(wp.dup_map) if expand_duplicates else wp.pat_words.shape[0]
        return torch.zeros((n,), dtype=torch.int32)
    device = tiles[0][0].device
    words, masks, lens = wp.tables(device)
    outs = [window_count(words, masks, lens, p, l, per_packet) for p, l in tiles]
    if expand_duplicates:
        dm = torch.from_numpy(wp.dup_map).to(device=device, dtype=torch.long)
        outs = [o[..., dm] for o in outs]
    if per_packet:
        return outs
    return torch.stack(outs).sum(dim=0, dtype=torch.int32)


def window_count_halo_plain(x: torch.Tensor, eff: torch.Tensor, ms: torch.Tensor, H: int,
                            tables) -> torch.Tensor:
    """Plain version of the halo kernel (ops/cuda_window.window_count_halo):
    int32[U] build-order totals over ``x`` uint8[R, H + C] rows ``[halo |
    bytes]``, counting a match at i iff its word chain matches, ``i + m <=
    eff[r]``, ``i + m > H`` and ``i >= ms[r]``.  ``tables`` is ``(words,
    masks, lens)``."""
    words, masks, lens = tables
    return window_count(words, masks, lens, x, eff, min_end=H, min_start=ms)


class StreamHalo(NamedTuple):
    """Carried streaming state: each lane's last ``H`` stream bytes, and how
    many of them are real (the rest are the zeros a stream starts with; no
    match may begin inside them).  ``fill`` is an int32 scalar tensor when
    every lane shares one stream position, or int32[N] when lanes carry
    their own histories (flows)."""

    data: torch.Tensor  # uint8[N, H]
    fill: torch.Tensor  # int32 [] or [N], 0 <= fill <= H


HaloCount = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def window_stream_chunk(
    wp: WindowProgram,
    chunk,
    rel_len,
    halo=None,
    *,
    expand_duplicates: bool = True,
    halo_count: Optional[HaloCount] = None,
):
    """Scan one chunk of per-lane byte streams with a carried byte halo.

    ``chunk`` uint8[N, C] (a tensor stays on its device, an array goes to
    the CPU).  ``rel_len``: payload bytes left from this chunk's first
    column; above C means the lane goes on, and a negative value means it
    ended in an earlier chunk.  ``halo=None`` starts the streams;
    a :class:`StreamHalo` continues them; a bare uint8[N, H] array is a halo
    whose bytes are all real.  Returns ``(counts, new_halo)``: summed over
    consecutive chunks, the counts equal the unchunked counts, matches
    across chunk edges included.

    ``halo_count(x, eff, ms)`` counts the assembled ``[halo | chunk]`` tile
    (int32[U] build order); the default is the plain version.  The flow
    stream passes the halo kernel here on the card.
    """
    chunk = torch.as_tensor(chunk, dtype=torch.uint8)
    dev = chunk.device
    n, C = chunk.shape
    H = max(int(wp.max_len) - 1, 1)
    if halo is None:
        halo_b = torch.zeros((n, H), dtype=torch.uint8, device=dev)
        fill = torch.zeros((), dtype=torch.int32, device=dev)
    elif isinstance(halo, StreamHalo):
        halo_b = torch.as_tensor(halo.data, dtype=torch.uint8).to(dev)
        fill = torch.as_tensor(halo.fill, dtype=torch.int32).to(dev)
    else:
        halo_b = torch.as_tensor(halo, dtype=torch.uint8).to(dev)
        fill = torch.full((), H, dtype=torch.int32, device=dev)
    x = torch.cat([halo_b, chunk], dim=1).contiguous()
    rel = torch.as_tensor(rel_len).to(device=dev, dtype=torch.int64)
    # Valid bytes: the halo plus what is left of the lane, capped at the
    # tile so that match ends stay inside this chunk's bytes.
    eff = torch.clamp(rel.clamp(min=0) + H, max=H + C).to(torch.int32).contiguous()
    # The first H - fill halo columns are fabricated zeros.
    ms = (H - fill).to(torch.int32).expand(n).contiguous()
    if halo_count is None:
        counts = window_count_halo_plain(x, eff, ms, H, wp.tables(dev))
    else:
        counts = halo_count(x, eff, ms)
    if expand_duplicates:
        counts = counts[torch.from_numpy(wp.dup_map).to(device=dev, dtype=torch.long)]
    return counts, StreamHalo(x[:, -H:].contiguous(), torch.clamp(fill + C, max=H))
