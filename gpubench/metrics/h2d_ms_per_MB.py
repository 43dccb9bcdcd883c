"""Device milliseconds of host-to-device copies per payload MB scanned in
the traced window."""

from gpubench import trace


def read(rec):
    if not rec.get("traced_payload_bytes") or not rec["device"]:
        return None
    s = trace.device_seconds(rec, lambda cat, name: cat == "gpu_memcpy" and "HtoD" in name)
    return 1e3 * s / (rec["traced_payload_bytes"] / 1e6)
