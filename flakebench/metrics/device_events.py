"""Kernels, copies and fills on the card a batch in the profiled stretch
(a count, which repeats exactly)."""

UNIT = "events/batch"
TRACE = 1


def read(rec):
    p = rec.get("profile")
    if not p or not p["device_events"]:
        return None
    return p["device_events"] / p["batches"]
