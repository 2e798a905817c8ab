"""Median host ms from a batch's first layer call to the return of its
last, over the traced window: the launches' cost, which the card hides
while it sets the pace."""

import statistics

UNIT = "ms"
TRACE = 1


def read(rec):
    v = rec.get("enqueue_ms")
    return statistics.median(v) if v else None
