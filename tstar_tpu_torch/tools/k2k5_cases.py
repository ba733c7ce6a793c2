"""K2 and K5 at the phase-3 shapes of ``chip_smoke.py``, on seeded inputs,
and the device time of a call; ``tools/kernel_bench.py`` times them.

    python tstar_tpu_torch/tools/k2k5_cases.py OUT.json

run by its path, writes each case's device us per launch as the checkout on
``PYTHONPATH`` builds and wraps the kernels: ``kernel_bench --old-checkout``
runs it so against another checkout (whose own tools may lack this file).
So it imports only ``torch`` and that checkout's ``tstar_tpu_torch.kernels``.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys

import torch

# (images, side, patch): the grid forward, verification, 512^2 verification,
# and the B/16 detectors' patch 16 (48-value (pw, c) runs)
K2_SHAPES = ((1, 768, 32), (3, 768, 32), (8, 768, 32), (16, 768, 32), (8, 512, 32),
             (16, 512, 32), (1, 768, 16), (8, 768, 16))
K5_ROWS = (577, 8 * 577, 16 * 257, 16 * 577)
K5_LAYERS = (("ln1->qkv", 2304), ("ln2->fc1", 3072))


def device_us(fn, iters=50):
    """Mean device time (us) of the kernels ``fn`` launches, per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA)
    return total / iters / 1e3


def k2k5_cases():
    """[(label, inputs, kernel call)] for K2 and K5, inputs from seeded
    generators on the card."""
    from tstar_tpu_torch.kernels import ln_matmul, patch_matmul

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cases = []
    for b, hw, p in K2_SHAPES:
        g = torch.Generator(device=dev).manual_seed(b * hw + p)
        px = torch.randn(b, hw, hw, 3, generator=g, device=dev).to(bf16)
        w = (torch.randn(p, p, 3, 768, generator=g, device=dev) * 0.02).to(bf16)
        tag = "" if p == 32 else f" p{p}"
        cases.append((f"K2 B={b} {hw}x{hw}{tag}", (px, w),
                      lambda px=px, w=w: patch_matmul.patch_embed_matmul(px, w)))
    for rows in K5_ROWS:
        for name, n in K5_LAYERS:
            g = torch.Generator(device=dev).manual_seed(rows + n)
            x = (torch.randn(1, rows, 768, generator=g, device=dev) * 3 + 1).to(bf16)
            # the LayerNorm's parameters in bf16, as the towers hold them
            scale = (1 + 0.1 * torch.randn(768, generator=g, device=dev)).to(bf16)
            bias = (0.1 * torch.randn(768, generator=g, device=dev)).to(bf16)
            w = (torch.randn(768, n, generator=g, device=dev) * 0.036).to(bf16)
            b = (0.1 * torch.randn(n, generator=g, device=dev)).to(bf16)
            cases.append((f"K5 {name} R={rows}", (x, scale, bias, w, b),
                          lambda a=(x, scale, bias, w, b): ln_matmul.ln_matmul(*a, 1e-5)))
    return cases


if __name__ == "__main__":
    with open(sys.argv[1], "w") as f:
        json.dump({label: device_us(run) for label, _, run in k2k5_cases()}, f)
