"""The share of the traced window the host spent turning the search's
histories into host arrays and Python lists: 100 x the host seconds of the
``search.history`` spans (``Stepper.history_rows`` and every
``_per_video_history``) over the window."""


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
    s = spans().get("search.history")
    if not s or not record.get("window_s"):
        return None
    return 100.0 * s["host_s"] / record["window_s"]
