"""The host seconds a question spends preparing the VLM's inputs: the
``vlm.prepare`` spans (``TorchVLMBackend._prepare``: the prompt
template, tokenizing, frames to patches) of both requests, over the
window's questions."""


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
    s = spans().get("vlm.prepare")
    questions = (record.get("counters") or {}).get("questions")
    if not s or not questions:
        return None
    return s["host_s"] / questions
