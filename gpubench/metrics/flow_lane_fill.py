"""Per cent of the bytes of the flow monitor's round tiles that are stream
bytes: 100 x real bytes the rounds scanned / bytes of the tiles handed to
the card (halos, padding and padding lanes included), from the program's
``FLOWS`` counter read around one probe pass after the window.  A program
without that counter has nothing here to read."""


def read(rec):
    flows = (rec.get("probes") or {}).get("flows")
    if not flows or not flows.get("tile_bytes"):
        return None
    return 100.0 * flows["real_bytes"] / flows["tile_bytes"]
