"""Per cent of the raw payload bytes that the sequence-order flow monitor
held and then dropped as already given (retransmissions, overlaps, bytes
behind an earlier round's edge): 100 x ``reorder_trimmed_bytes`` /
``reorder_held_bytes`` of the program's ``FLOWS`` counter, read around one
probe pass after the window.  A program whose counter has no such keys has
nothing here to read."""


def read(rec):
    flows = (rec.get("probes") or {}).get("flows")
    if not flows or not flows.get("reorder_held_bytes") or "reorder_trimmed_bytes" not in flows:
        return None
    return 100.0 * flows["reorder_trimmed_bytes"] / flows["reorder_held_bytes"]
