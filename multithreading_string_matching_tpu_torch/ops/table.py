"""Large pattern sets: word-count classes, filter words, and the plain
PyTorch versions of the table and filter kernels.

Counterpart of the host side of ``multithreading_string_matching_tpu/ops/
pallas_table.py`` (``_filter_words``, ``_PatternClass``, ``_partition``,
``plan_shard_geometry``).
The unique patterns are split by word count ``K = ceil(len / 4)`` with a
stable sort, one contiguous table per class, so that every word a kernel
compares is a word of the pattern; ``inv`` maps class-sorted order back to
build order.  With the filter, each class's tables carry one more column,
``K``: the pattern's filter word and mask.

The TPU padded each class to whole SMEM blocks.  The CUDA kernels
(``csrc/table_count.cu``) take any number of patterns, so a class here
holds exactly its patterns and no padded slot.

The plain versions :func:`table_count` and :func:`filter_count` count one
class over one tile.  They are the CPU path of the kernel wrappers
(ops/cuda_table.py) and what the kernels are held against on the card.
:func:`filter_count` applies the filter as the filter kernels do: it
compares the filter word at every position and verifies the pattern's K
words only where the filter fired.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.ops.window import (
    GROUP,
    WindowProgram,
    _word_views,
    window_count,
)

FULL = np.uint32(0xFFFFFFFF)


def filter_words(wp: WindowProgram) -> Tuple[np.ndarray, np.ndarray]:
    """Per unique pattern ``(filter_word, filter_mask)``, uint32[U] each: the
    full (mask 0xFFFFFFFF) word whose value is rarest across the whole set,
    ties going to the pattern's last such word, so shared prefixes
    ("HTTP/1.1 ...", "rs00...") keep a discriminating filter.  A pattern
    with no full word (shorter than 4 bytes) falls back to its masked word 0.
    """
    full = wp.pat_masks == FULL
    vals, counts = np.unique(wp.pat_words[full], return_counts=True)
    freq = dict(zip(vals.tolist(), counts.tolist()))
    U = wp.pat_words.shape[0]
    fwords = np.empty(U, np.uint32)
    fmasks = np.empty(U, np.uint32)
    for u in range(U):
        cands = np.flatnonzero(full[u]).tolist()
        if cands:
            k = min(cands, key=lambda k: (freq[int(wp.pat_words[u, k])], -k))
            fwords[u], fmasks[u] = wp.pat_words[u, k], FULL
        else:
            fwords[u], fmasks[u] = wp.pat_words[u, 0], wp.pat_masks[u, 0]
    return fwords, fmasks


@dataclass
class PatternClass:
    """One word-count class: its patterns' tables in class order.

    ``words``/``masks`` are uint32[num, K], or uint32[num, K + 1] with the
    filter word and mask as column K; ``lens`` is int32[num].
    """

    K: int
    words: np.ndarray
    masks: np.ndarray
    lens: np.ndarray

    @property
    def num(self) -> int:
        return int(self.words.shape[0])

    def tables(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(words, masks, lens)`` as int32 tensors on ``device`` (the
        uint32 tables bit-cast)."""
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)
            for a in (self.words, self.masks, self.lens.astype(np.int32))
        )


def partition(wp: WindowProgram, filtered: bool, assume_zero_padded: bool = False,
              ) -> Tuple[List[PatternClass], np.ndarray, bool]:
    """``(classes, inv, use_fit)``.

    Classes come in increasing K; within a class patterns keep build order
    (stable sort).  ``inv`` is int64[U]: build-order counts are
    ``concatenated_class_counts[inv]``.  ``use_fit`` says whether the length
    fit mask is needed for exact counts (always, unless rows are zero past
    their length and no pattern holds a NUL); the CUDA kernels apply it
    either way.
    """
    use_fit = (not assume_zero_padded) or any(0 in p for p in wp.unique_patterns)
    kcounts = -(-wp.pat_lens.astype(np.int64) // 4)
    order = np.argsort(kcounts, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    if filtered:
        fwords, fmasks = filter_words(wp)
    classes = []
    for K in np.unique(kcounts).tolist():
        sel = order[kcounts[order] == K]
        words, masks = wp.pat_words[sel, :K], wp.pat_masks[sel, :K]
        if filtered:
            words = np.concatenate([words, fwords[sel, None]], axis=1)
            masks = np.concatenate([masks, fmasks[sel, None]], axis=1)
        classes.append(PatternClass(int(K), np.ascontiguousarray(words),
                                    np.ascontiguousarray(masks),
                                    wp.pat_lens[sel].astype(np.int32)))
    return classes, inv, use_fit


# The JAX package's in-loop unroll and SMEM pattern block (its
# ops/pallas_table.py), measured on a TPU.  Kept only so that a pattern
# shard's padded size S, and with it PatternShardPlan's layout, equals the
# JAX package's; the CUDA kernels need no padding.
UNROLL = 16
PATTERN_BLOCK = 128


def plan_shard_geometry(C: int, unroll: int = UNROLL, block: int = PATTERN_BLOCK):
    """``(S, pb, nblocks)`` for a pattern shard of ``C`` real patterns: the
    padded shard size ``S = nblocks * pb`` that every shard's table block
    shares (parallel/pattern_shard.py), by the JAX package's padding
    algebra.  On the card a padded slot costs at most ``pb - 1`` probes."""
    q = math.lcm(unroll, 8)
    block = -(-block // q) * q
    pb = min(block, -(-max(C, 1) // q) * q)
    nblocks = -(-max(C, 1) // pb)
    return nblocks * pb, pb, nblocks


def _u32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.int64) & 0xFFFFFFFF


def filter_offsets(words: torch.Tensor, masks: torch.Tensor, K: int) -> torch.Tensor:
    """int64[U]: the byte offset in each pattern of its filter word, the
    first of its K words equal to column K (word and mask).  A pattern whose
    filter never fires (mask 0, word not 0) gets 0; it is never verified."""
    same = (words[:, :K] == words[:, K:K + 1]) & (masks[:, :K] == masks[:, K:K + 1])
    first = same.int().argmax(dim=1)
    return torch.where(same.any(dim=1), first, torch.zeros_like(first)).long() * 4


def table_count(words, masks, lens, payloads, lengths, K: int, per_row: bool = False) -> torch.Tensor:
    """Plain version of the table kernels over one class: every pattern's
    first K words compared at every position, with the fit mask.  Returns
    int32[U] in class order, or int32[n, U] with ``per_row``."""
    return window_count(words[:, :K].contiguous(), masks[:, :K].contiguous(), lens,
                        payloads, lengths, per_packet=per_row)


def filter_count(words, masks, lens, payloads, lengths, K: int, per_row: bool = False) -> torch.Tensor:
    """Plain version of the filter kernels over one class whose tables carry
    the filter word and mask as column K.

    Stage 1 compares the filter word at every position ``i``; a hit means a
    candidate start ``s = i - offset`` (offset: :func:`filter_offsets`).
    Stage 2 verifies the K words and the fit ``s + lens[u] <= lengths[r]``
    at the candidates only.  Every match puts its filter word at exactly
    one position, so the count is exact.
    """
    n, L = payloads.shape
    U = words.shape[0]
    dev = payloads.device
    out = torch.zeros((n, U) if per_row else (U,), dtype=torch.int32, device=dev)
    if n == 0 or L == 0 or U == 0:
        return out
    w32 = _word_views(payloads, K)                  # int64[n, L + 4(K - 1) + 1]
    pw, pm = _u32(words, dev), _u32(masks, dev)
    foff = filter_offsets(pw, pm, K)
    pl = lens.to(device=dev, dtype=torch.int64)
    ln = lengths.to(device=dev, dtype=torch.int64)
    flat = out.view(-1)
    for g0 in range(0, U, GROUP):
        g1 = min(g0 + GROUP, U)
        hit = (w32[None] & pm[g0:g1, K, None, None]) == pw[g0:g1, K, None, None]
        u, r, i = hit.nonzero(as_tuple=True)
        u = u + g0
        s = i - foff[u]
        ok = (s >= 0) & (s < L) & (s + pl[u] <= ln[r])
        u, r, s = u[ok], r[ok], s[ok]
        for k in range(K):
            ok = (w32[r, s + 4 * k] & pm[u, k]) == pw[u, k]
            u, r, s = u[ok], r[ok], s[ok]
        idx = r * U + u if per_row else u
        flat.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return out
