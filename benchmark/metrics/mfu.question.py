"""The whole question's share of the card's bf16 peak: the operations both
VLM requests need (SigLIP, projector, prefill, decode; counted from shapes
by ``benchmark/flops.py``) and the search's detector forwards, over the
traced window and 989 TFLOP/s."""

from benchmark.flops import PEAK_BF16_FLOPS


def read(record):
    c = record.get("counters") or {}
    if not record.get("busy_s") or not c.get("flops"):
        return None
    return 100.0 * c["flops"] / record["window_s"] / PEAK_BF16_FLOPS
