"""Published peaks and the least time of a count pass.

A count pass must read each real payload byte once and write its count
vector once: one int32 a pattern-file entry.  Padding, packing and the
probe's operations belong to an implementation and are not counted, so a
kernel's share of this least time reads the same work whatever implements
it.  The bound is memory bandwidth: the counts need no arithmetic that a
published rate bounds.

HBM bandwidth by the name ``torch.cuda.get_device_name()`` gives, from
NVIDIA's H100 data sheet (at the full power limit; the run prints the
card's limit beside its numbers).
"""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,      # SXM5
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}

COUNT_BYTES = 4   # one int32 a pattern-file entry


def hbm_bytes_per_s(device_name: str) -> Optional[float]:
    return HBM_BYTES_PER_S.get(device_name)


def least_count_bytes(payload_bytes: int, patterns: int, passes: int = 1) -> int:
    """Bytes that ``passes`` count passes over ``payload_bytes`` of real
    payload must move: the payload read once and the counts written once,
    each pass."""
    return int(payload_bytes) + passes * patterns * COUNT_BYTES
