"""Plain PyTorch counts of every overlapping occurrence of every pattern.

The benchmark's reference for what the program counts: for each pattern of
the pattern file, in file order and with duplicates each reported, the
number of positions ``p`` of each payload where the pattern's bytes equal
``payload[p : p + len]`` entirely inside that payload.  Nothing here comes
from the program under test.

Method, exact at every step.  The payloads are laid end to end in one byte
buffer.  Every position gets the little-endian 64-bit key of the 8 bytes
that start there.  A pattern of ``g <= 8`` bytes is found where the key,
masked to its first ``g`` bytes, equals the pattern's key; a longer pattern
where the 8-byte key equals its first 8 bytes' and the rest of its bytes
then compare equal.  A find counts only when the pattern ends inside the
payload its first byte lies in.  The keys are looked up with
``torch.searchsorted`` over each length group's sorted keys, in blocks of
positions, on whichever device the caller names.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

BLOCK = 1 << 24          # positions a block
KEY_BYTES = 8


def _keys(buf: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """int64 keys of positions ``start .. start + n`` (``buf`` carries 8
    bytes of padding past its last payload byte)."""
    x = buf[start : start + n + KEY_BYTES - 1].to(torch.int64)
    k = x[:n].clone()
    for j in range(1, KEY_BYTES):
        k |= x[j : j + n] << (8 * j)
    return k


def _pattern_key(p: bytes) -> int:
    head = p[:KEY_BYTES]
    v = int.from_bytes(head, "little")
    return v - (1 << 64) if v >= 1 << 63 else v


class _Groups:
    """The unique patterns by ``g = min(len, 8)``: each group's sorted unique
    keys, and for each key the unique patterns that start with it."""

    def __init__(self, uniq: List[bytes], device):
        self.device = device
        self.groups = []
        by_g: Dict[int, Dict[int, List[int]]] = {}
        for u, p in enumerate(uniq):
            by_g.setdefault(min(len(p), KEY_BYTES), {}).setdefault(_pattern_key(p), []).append(u)
        for g, table in sorted(by_g.items()):
            keys = sorted(table)
            members = [table[k] for k in keys]
            offsets = np.cumsum([0] + [len(m) for m in members])
            mask = -1 if g == KEY_BYTES else (1 << (8 * g)) - 1
            self.groups.append((
                mask,
                torch.tensor(keys, dtype=torch.int64, device=device),
                torch.tensor(offsets, dtype=torch.int64, device=device),
                torch.tensor([u for m in members for u in m], dtype=torch.int64, device=device),
            ))


def count_payloads(payloads: Sequence[bytes], patterns: Sequence[bytes],
                   device="cpu") -> np.ndarray:
    """int64[len(patterns)]: overlapping occurrences of each pattern over
    all ``payloads``, in pattern-file order."""
    device = torch.device(device)
    uniq = list(dict.fromkeys(bytes(p) for p in patterns))
    if any(len(p) == 0 for p in uniq):
        raise ValueError("empty pattern")
    index = {p: i for i, p in enumerate(uniq)}
    lens = [len(p) for p in uniq]
    lmax = max(lens)
    sizes = np.fromiter((len(p) for p in payloads), dtype=np.int64, count=len(payloads))
    total = int(sizes.sum())
    counts = torch.zeros(len(uniq), dtype=torch.int64, device=device)
    if total:
        host = np.zeros(total + lmax + KEY_BYTES, dtype=np.uint8)
        host[:total] = np.frombuffer(b"".join(payloads), dtype=np.uint8)
        buf = torch.from_numpy(host).to(device)
        starts = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts[1:])
        bounds = torch.from_numpy(starts).to(device)
        pat_len = torch.tensor(lens, dtype=torch.int64, device=device)
        pat_bytes = torch.zeros((len(uniq), lmax), dtype=torch.uint8, device=device)
        for u, p in enumerate(uniq):
            pat_bytes[u, : len(p)] = torch.frombuffer(bytearray(p), dtype=torch.uint8)
        groups = _Groups(uniq, device)
        cols = torch.arange(lmax, device=device)
        for s in range(0, total, BLOCK):
            n = min(BLOCK, total - s)
            keys = _keys(buf, s, n)
            for mask, gkeys, offsets, members in groups.groups:
                m = keys & mask
                i = torch.searchsorted(gkeys, m).clamp_(max=gkeys.numel() - 1)
                hit = torch.nonzero(gkeys[i] == m).squeeze(1)
                if hit.numel() == 0:
                    continue
                key_id = i[hit]
                first, last = offsets[key_id], offsets[key_id + 1]
                per = last - first
                pos = torch.repeat_interleave(hit + s, per)
                base = torch.repeat_interleave(first, per)
                within = torch.arange(pos.numel(), device=device) - torch.repeat_interleave(
                    torch.cumsum(per, 0) - per, per)
                u = members[base + within]
                ln = pat_len[u]
                # The payload that holds the first byte must hold the last.
                payload = torch.searchsorted(bounds, pos, right=True) - 1
                ok = pos + ln <= bounds[payload + 1]
                if lmax > KEY_BYTES:
                    window = buf[pos[:, None] + cols[None, :]]
                    same = (window == pat_bytes[u]) | (cols[None, :] >= ln[:, None])
                    ok &= same.all(dim=1)
                counts += torch.bincount(u[ok], minlength=len(uniq))
    uniq_counts = counts.cpu().numpy()
    return np.array([uniq_counts[index[bytes(p)]] for p in patterns], dtype=np.int64)
