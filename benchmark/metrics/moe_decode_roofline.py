"""The MoE decode kernel (``moe_decode_up_kernel`` and
``moe_decode_down_kernel``, two launches a MoE layer and step) over all its
launches in the traced window: the sum of each launch pair's least time
(its bytes, ``flops_kimi.moe_decode_bytes``: the chosen and shared
experts' rows read once, at HBM's rate) over the sum of their device time.
The launches' count is the driver's MoE layers a step times its decode
steps, two each; a trace whose launches differ reads nothing, as does a
program without the kernel."""

from benchmark.trace import kernel_share

FRAGMENTS = ("moe_decode_up_kernel", "moe_decode_down_kernel")


def read(record):
    c = record.get("counters") or {}
    ms, launches = kernel_share(record.get("device_ops") or {}, FRAGMENTS)
    if not launches or not c.get("moe_layers") or not c.get("moe_decode_bound_s"):
        return None
    if launches != 2 * c["moe_layers"] * c["decode_steps"]:
        return None
    return 100.0 * c["moe_decode_bound_s"] / (ms / 1e3)
