"""The decode's device milliseconds a step, over both requests of every
question in the traced window (``GenerateStats(timed=True)``: CUDA events
around each request's decode loop)."""


def read(record):
    c = record.get("counters") or {}
    if not c.get("decode_ms") or not c.get("decode_steps"):
        return None
    return c["decode_ms"] / c["decode_steps"]
