"""The device milliseconds a VLM request's prefill spends in its MoE
layers' experts: the CUDA-event time of the ``moe.prefill`` spans (each MoE
layer's grouped expert products) over the requests (``generate.prefill``
spans)."""


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
    s = spans()
    moe, requests = s.get("moe.prefill"), s.get("generate.prefill")
    if not moe or moe["device_ms"] is None or not requests or not requests["count"]:
        return None
    return moe["device_ms"] / requests["count"]
