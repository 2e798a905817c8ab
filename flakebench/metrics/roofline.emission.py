"""The least time of the emission's needed work (``flakebench.roofline``)
as a share of its median device ms a batch."""

import statistics

from flakebench import roofline
from flakebench.reference.flac_plain import Config

UNIT = "%"
TRACE = 1


def read(rec):
    v = rec.get("emission_ms")
    if not v:
        return None
    least = roofline.least_ms(*roofline.layer_work(
        "emission", rec["frames"], Config.from_file(rec["config"])))
    return roofline.share(least, statistics.median(v))
