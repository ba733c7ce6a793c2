"""The decode's share of its roofline: the least time its steps could take
(each reads the language model's weights and the cache so far at HBM's
rate; bytes bound it, ``flops.llava_decode_bound_s``) over their measured
device time (``GenerateStats(timed=True)``)."""


def read(record):
    c = record.get("counters") or {}
    if not c.get("decode_ms") or not c.get("decode_bound_s"):
        return None
    return 100.0 * c["decode_bound_s"] / (c["decode_ms"] / 1e3)
