"""Reading a ``torch.profiler`` trace: device events, the device-busy union,
the idle gaps and what the host was doing in them.

The device-event walk, the interval union and the kernel-name fragments are
frozen copies of the program's ``tools/profile_search.py`` (``device_events``,
``_busy_ms``, ``PORT_KERNELS``), kept here so that the benchmark's trace
arithmetic cannot move with the program.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

# Device-kernel name fragments of the port's hand-written kernels (K1 and K8
# in bf16 share attn_sm90_kernel; its first template argument is the mode:
# 0 / 1 K1, 2 K8).
PORT_KERNELS = {
    "K1 mha": ("mha_kernel", "attn_sm90_kernel<0", "attn_sm90_kernel<1"),
    "K2 patch_embed": ("patch_embed",),
    "K3 layernorm": ("layernorm_kernel", "layernorm_wide_kernel"),
    "K4 w8a8": ("w8a8_kernel",),
    "K5 ln_matmul": ("ln_matmul_kernel",),
    "K6 grid_embed": ("grid_embed_kernel", "grid_embed_sm90_kernel"),
    "K7 grid pack": ("grid_pack_kernel",),
    "K8 flash": ("flash_kernel", "attn_sm90_kernel<2"),
    "nms": ("nms_mask_kernel", "nms_scan_kernel"),
}


def union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def profile_events(prof):
    """A finished profile -> (device operations {name: [ms, count]}: kernels,
    copies and fills, without the host's ranges that the profiler mirrors on
    the device; their (start, end) intervals in ns; host events [(start,
    end, name)] in ns)."""
    import torch

    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        ev = (e.start_ns(), e.end_ns(), e.name())
        (device if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(ev)
    # a host range (record_function) appears on the device too, by its name
    host_names = {h[2] for h in host}
    intervals = []
    for s, e, name in device:
        if name in host_names:
            continue
        by_name[name][0] += (e - s) / 1e6
        by_name[name][1] += 1
        intervals.append((s, e))
    return dict(by_name), intervals, host


def kernel_share(by_name: Dict[str, List[float]], fragments: Sequence[str]) -> Tuple[float, int]:
    """(ms, launches) summed over the kernels whose name holds a fragment."""
    hits = [v for k, v in by_name.items() if any(f in k for f in fragments)]
    return sum(v[0] for v in hits), int(sum(v[1] for v in hits))


def idle_gaps(intervals, host, window: Tuple[int, int], top: int = 10):
    """The ``top`` longest stretches of the window with no kernel running,
    each named by the innermost host event that covers its middle:
    [(name, seconds)], longest first."""
    start, end = window
    busy = [(max(s, start), min(e, end)) for s, e in merged(intervals) if e > start and s < end]
    gaps, cur = [], start
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if end > cur:
        gaps.append((cur, end))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) // 2
        covering = [h for h in host if h[0] <= mid <= h[1]]
        name = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "(no host event)"
        out.append([name[:120], (e - s) / 1e9])
    return out
