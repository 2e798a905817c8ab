"""The 95th percentile, over every batch of the window, of the time
between the completion events of consecutive batches: a batch's service
time on the card while the card sets the pace."""

import statistics

UNIT = "ms"
TRACE = 0


def read(rec):
    gaps = rec.get("batch_ms") or []
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=20, method="inclusive")[18]
