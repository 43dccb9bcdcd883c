"""What the readers of the program's own spans share.  Under
``torch.profiler`` the program opens a range at each stage of its
streamed path (``msm.stream`` around one call, ``msm.ingest``,
``msm.decode``, ``msm.pack``, ``msm.stage.*``, ``msm.drain`` inside it);
the trace keeps them as host records ``(name, start_us, end_us)``.  A
program that opens no ``msm.stream`` span in the window has none of these
to read, and every reader of them reads ``None`` there."""

from gpubench import trace

REQUEST = "msm.stream"
PREFIX = "msm."


def clipped(rec, name):
    """``(start_us, end_us)`` of every span called ``name``, clipped to the
    traced window."""
    if not rec.get("window_us"):
        return []
    w0, w1 = rec["window_us"]
    out = []
    for n, a, b in rec["host"]:
        a, b = max(a, w0), min(b, w1)
        if n == name and b > a:
            out.append((a, b))
    return out


def traced(rec) -> bool:
    """Whether the program opened its request span in the window."""
    return bool(clipped(rec, REQUEST))


def per_MB(rec, ms):
    """``ms`` per MB (10^6 bytes) of the payload the traced passes scanned."""
    nbytes = rec.get("traced_payload_bytes")
    if not nbytes:
        return None
    return ms / (nbytes / 1e6)


def summed_ms(rec, name) -> float:
    """Milliseconds of the window inside spans called ``name``, summed."""
    return sum(b - a for a, b in clipped(rec, name)) / 1e3


def self_ms(rec, name) -> float:
    """Milliseconds of the window inside spans called ``name`` less, for
    each, the union of the other ``msm.*`` spans that lie inside it."""
    if not rec.get("window_us"):
        return 0.0
    w0, w1 = rec["window_us"]
    host = rec["host"]
    total = 0.0
    for i, (n, a, b) in enumerate(host):
        lo, hi = max(a, w0), min(b, w1)
        if n != name or hi <= lo:
            continue
        kids = [(c, d) for j, (m, c, d) in enumerate(host)
                if j != i and m.startswith(PREFIX) and a <= c and d <= b]
        total += (hi - lo) - sum(d - c for c, d in trace.merged(kids, lo, hi))
    return total / 1e3
