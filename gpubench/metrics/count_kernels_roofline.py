"""Share of the least time of the traced passes' counts that the program's
hand-written kernels took, in per cent: the least time
(``gpubench/roofline.py``: real payload bytes read once, counts written
once, over the card's published HBM bandwidth) over the summed device time
of the kernels named in the program's CUDA sources."""

from gpubench import roofline, trace


def read(rec):
    peak = rec.get("hbm_bytes_per_s")
    if not peak or not rec.get("traced_payload_bytes"):
        return None
    kernel_s = trace.device_seconds(rec, trace.is_program_kernel(rec))
    if kernel_s <= 0:
        return None
    least = roofline.least_count_bytes(rec["traced_payload_bytes"], rec["patterns"],
                                       rec["passes"]) / peak
    return 100.0 * least / kernel_s
