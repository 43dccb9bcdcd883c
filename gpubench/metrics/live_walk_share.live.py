"""Share of the live stream's feeds that took the one native header walk:
100 x ``walked`` / ``batches`` of the program's ``LIVE`` counter, read
around one probe pass after the window.  100 where every feed's filter,
decode and gather ran as one call; it falls where feeds take the two numpy
header walks instead (another linktype, or no native library).  A program
whose counter has no ``walked`` has nothing here to read."""


def read(rec):
    live = (rec.get("probes") or {}).get("live")
    if not live or not live.get("batches") or "walked" not in live:
        return None
    return 100.0 * live["walked"] / live["batches"]
