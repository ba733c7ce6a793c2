"""The host seconds a question spends building its frame cache: the
``video.cache`` spans (``video/cache.build_frame_cache``: the probe,
the sweep decode and the upload) over the window's questions."""


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
    s = spans().get("video.cache")
    questions = (record.get("counters") or {}).get("questions")
    if not s or not questions:
        return None
    return s["host_s"] / questions
