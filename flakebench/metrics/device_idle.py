"""Share of the profiled stretch in which no kernel or copy ran on the
card: one less the union of the device intervals in the profiler's trace
over the stretch's host-clock length."""

UNIT = "%"
TRACE = 1


def read(rec):
    p = rec.get("profile")
    if not p or not p["window_s"] or not p["device_events"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
