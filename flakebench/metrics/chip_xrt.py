"""Audio seconds of every batch completed in the window over the window's
seconds on the host clock, the drain of the last batches included."""

UNIT = "audio_s/s"
TRACE = 0


def read(rec):
    if not rec.get("window_s"):
        return None
    return rec["batches"] * rec["audio_s"] / rec["window_s"]
