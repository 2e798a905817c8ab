"""Median device ms a batch of the emission (``ops/bitpack.
pack_frames_device``: the slot layout and the word merge), between the
harness's CUDA events around the call, over the traced window."""

import statistics

UNIT = "ms"
TRACE = 1


def read(rec):
    v = rec.get("emission_ms")
    return statistics.median(v) if v else None
