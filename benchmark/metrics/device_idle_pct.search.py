"""The share of the traced window in which no kernel ran on the device:
100 x (1 - union of the device intervals / window)."""


def read(record):
    if not record.get("busy_s") or not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
