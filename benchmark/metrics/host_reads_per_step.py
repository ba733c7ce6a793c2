"""The engine's host reads a search step (``StepStats.host_reads / steps``):
each read waits for the device."""


def read(record):
    c = record.get("counters") or {}
    if not c.get("steps"):
        return None
    return c["host_reads"] / c["steps"]
