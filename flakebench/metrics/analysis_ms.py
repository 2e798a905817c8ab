"""Median device ms a batch of the analysis (``ops/frame.analyze_frames``),
between the harness's CUDA events around the call, over the traced
window."""

import statistics

UNIT = "ms"
TRACE = 1


def read(rec):
    v = rec.get("analysis_ms")
    return statistics.median(v) if v else None
