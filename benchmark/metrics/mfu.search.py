"""The whole search step's share of the card's bf16 peak: the operations
every detector forward of the traced window needs (grid canvases and
verification images at 768^2, and each search's prompt encode; counted
from shapes by ``benchmark/flops.py``) over the window and 989 TFLOP/s."""

from benchmark.flops import PEAK_BF16_FLOPS


def read(record):
    c = record.get("counters") or {}
    if not record.get("busy_s") or not c.get("flops"):
        return None
    return 100.0 * c["flops"] / record["window_s"] / PEAK_BF16_FLOPS
