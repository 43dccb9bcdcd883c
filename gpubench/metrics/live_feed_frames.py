"""Frames a feed of the live stream: frames fed over feeds, from the
program's ``LIVE`` counter read around one probe pass after the window.
It reads the deployment's batch size, and shows a change that alters how
many frames cross the host path at a time.  A program without that counter
has nothing here to read."""


def read(rec):
    live = (rec.get("probes") or {}).get("live")
    if not live or not live.get("batches"):
        return None
    return live["frames"] / live["batches"]
