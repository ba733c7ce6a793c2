"""The device milliseconds of a VLM request's vision tower: the CUDA-event
time of the ``vision.encode`` spans (MoonViT, the patch merge and the
projector over the request's frames) over their count."""


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
    s = spans().get("vision.encode")
    if not s or s["device_ms"] is None or not s["count"]:
        return None
    return s["device_ms"] / s["count"]
