"""K1, the fused attention kernel (``attn_sm90_kernel<0|1>``, ``mha_kernel``):
over all its launches in the traced window, the sum of each launch's least
time (``flops.attention_launch_bound_s``: bytes over HBM's rate or the two
products over the bf16 peak, whichever is larger) over the sum of their
device time.  The launches' shapes are the detector forwards the driver
counted (one launch a layer); a trace whose K1 launches differ from that
count reads nothing."""

from benchmark.flops import attention_launch_bound_s
from benchmark.trace import PORT_KERNELS, kernel_share


def read(record):
    c = record.get("counters") or {}
    forwards = c.get("attention_forwards")
    ms, launches = kernel_share(record.get("device_ops") or {}, PORT_KERNELS["K1 mha"])
    if not forwards or not launches:
        return None
    if launches != sum(f["layers"] * f["count"] for f in forwards):
        return None
    bound = sum(f["layers"] * f["count"] *
                attention_launch_bound_s(f["batch"], f["seq"], f["heads"], f["head_dim"])[0]
                for f in forwards)
    return 100.0 * bound / (ms / 1e3)
