"""Host milliseconds per payload MB to read and decode the cell's capture
alone (``iter_pcap`` + ``extract_payloads`` at the pass's batch size),
median of the probe's passes; timed by the benchmark around the program's
public io functions."""


def read(rec):
    p = rec["probes"]
    if not p.get("io_bytes"):
        return None
    return 1e3 * p["io_s"] / (p["io_bytes"] / 1e6)
