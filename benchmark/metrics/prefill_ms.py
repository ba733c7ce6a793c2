"""The device milliseconds of a VLM request's prefill (SigLIP, the
projector, the prompt's forward and the first token): the CUDA-event time
of the ``generate.prefill`` spans over their count."""


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
    s = spans().get("generate.prefill")
    if not s or s["device_ms"] is None or not s["count"]:
        return None
    return s["device_ms"] / s["count"]
