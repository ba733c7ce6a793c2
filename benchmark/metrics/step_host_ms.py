"""The host milliseconds a search step spends outside its waits for the
device: the host seconds of the ``search.step`` spans less those of the
``search.read`` spans inside them (every read but the one before each
search's first step, which its ``search.setup`` span holds), over the
window's steps."""


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
    step, wait, setup = s.get("search.step"), s.get("search.read"), s.get("search.setup")
    steps = (record.get("counters") or {}).get("steps")
    if not step or not wait or not setup or not steps:
        return None
    return 1e3 * (step["host_s"] - (wait["host_s"] - setup["host_s"])) / steps
