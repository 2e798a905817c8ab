"""Device ms a batch of the analysis' candidate sweep over the profiled
stretch: the seconds of the breakdown's device operations (the ten with
the most time, ``rec["profile"]["device_ops"]``) whose kernel names
contain ``granule_kernel`` (K4, ``csrc/sweep_granules.cu``),
``sweep_kernel`` (K2, ``csrc/sweep.cu``) or ``rice_scan_kernel`` (R1,
``csrc/rice.cu``), over the stretch's batches. It reads kernel names, so
a renamed kernel falls out of it. A sweep kernel and R1 always run
together, so the reading is None unless both are among the ten: a kernel
pushed out of the breakdown then shows as a missing reading, never as a
smaller one. None too where neither ran, as under EST, which bypasses
the sweep. The sweep's glue (the ``flake.analysis.sweep`` span's other
events) is not counted."""

UNIT = "ms"
TRACE = 1
SWEEPS = ("granule_kernel", "sweep_kernel")
RICE = "rice_scan_kernel"


def read(rec):
    p = rec.get("profile")
    if not p:
        return None
    sweep = [s for name, s in p["device_ops"]
             if any(k in name for k in SWEEPS)]
    rice = [s for name, s in p["device_ops"] if RICE in name]
    if not (sweep and rice):
        return None
    return 1e3 * (sum(sweep) + sum(rice)) / p["batches"]
