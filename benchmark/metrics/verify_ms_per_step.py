"""The device milliseconds of a search step's verification: the CUDA-event
time of the ``search.phase.verify`` spans (every round, or the wide
rescore, of each step) over the window's steps."""


def spans():
    """The program's span registry (``utils/profiling.snapshot``), or {}
    where the program keeps none."""
    try:
        from tstar_tpu_torch.utils import profiling
    except ImportError:
        return {}
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else {}


def read(record):
    s = spans().get("search.phase.verify")
    steps = (record.get("counters") or {}).get("steps")
    if not s or s["device_ms"] is None or not steps:
        return None
    return s["device_ms"] / steps
