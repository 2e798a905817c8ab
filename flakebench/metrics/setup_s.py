"""Seconds from the process's start to the window's first dispatch:
imports, the CUDA context, loading (on a checkout's first run, building)
the kernel library, making the pool on the card, warming its shape."""

UNIT = "s"
TRACE = 0


def read(rec):
    return rec.get("setup_s")
