"""The summed device time of the traced window's kernels over the frames
the detector scored in it."""


def read(record):
    ops = record.get("device_ops") or {}
    c = record.get("counters") or {}
    if not ops or not c.get("frames"):
        return None
    return sum(v[0] for v in ops.values()) / c["frames"]
