"""K2, K5, K6 and K7 at the phase-3 shapes of ``chip_smoke.py`` (and a few
more), on seeded inputs, and the device time of a call;
``tools/kernel_bench.py`` times them.

    python tstar_tpu_torch/tools/kernel_cases.py OUT.json {k2k5,k6k7}

run by its path, writes each case of the set's device us per launch as the
checkout on ``PYTHONPATH`` builds and wraps the kernels: ``kernel_bench
--old-checkout`` runs it so against another checkout (whose own tools may
lack this file).  So it imports only ``torch`` and names of that checkout's
``tstar_tpu_torch.kernels`` that the parent commits have too.  Needs a CUDA
device.
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
# (videos, cache (h, w), patch) into 4x4 cells of 192^2: the grid forward at
# both caches, the batched gate's B=16, a ragged last M tile (B=3), patch 16
K6_SHAPES = ((1, (192, 384), 32), (16, (192, 384), 32), (1, (180, 320), 32),
             (3, (192, 384), 32), (1, (192, 384), 16))
# (cache (h, w), detector size, out dtype): both caches in both dtypes, and
# a 772^2 canvas (rows of 2316 values)
K7_SHAPES = (((192, 384), 768, torch.bfloat16), ((192, 384), 768, torch.float32),
             ((180, 320), 768, torch.bfloat16), ((180, 320), 768, torch.float32),
             ((192, 384), 772, torch.bfloat16))


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


def k6k7_cases():
    """[(label, inputs, kernel call)] for K6 and K7, inputs from seeded
    generators on the card; K6's width / height matrices in bf16 and its
    seconds int64, as the search holds them."""
    from tstar_tpu_torch.kernels import grid_embed, pallas_grid

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cases = []
    for b, hw, p in K6_SHAPES:
        g = torch.Generator(device=dev).manual_seed(1000 * b + hw[0] + p)
        cache = torch.randint(0, 256, (b, 64, *hw, 3), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        secs = torch.randint(0, 64, (b, 16), generator=g, device=dev)
        w = (torch.randn(p, p, 3, 768, generator=g, device=dev) * 0.02).to(bf16)
        awk, bias = (torch.from_numpy(t).to(dev) for t in grid_embed._width_affine(hw[1], 192))
        ah = grid_embed._height_matrix(hw[0], 192)
        ah = None if ah is None else torch.from_numpy(ah).to(dev, bf16)
        args = (cache, secs, awk.to(bf16), bias, ah, w)
        kw = dict(grid_shape=(4, 4), cell_hw=(192, 192), patch_size=p)
        tag = "" if p == 32 else f" p{p}"
        cases.append((f"K6 B={b} cache {hw[0]}x{hw[1]}{tag}", (args, kw),
                      lambda a=args, kw=kw: grid_embed.grid_cell_embed(*a, **kw)))
    for hw, size, dt in K7_SHAPES:
        g = torch.Generator(device=dev).manual_seed(hw[0] + size)
        cache = torch.randint(0, 256, (640, *hw, 3), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        secs = torch.randperm(640, generator=g, device=dev)[:16]
        args = (cache, secs, (4, 4), size, dt)
        cases.append((f"K7 cache {hw[0]}x{hw[1]} -> {size}^2 {str(dt)[6:]}", args,
                      lambda a=args: pallas_grid.build_detector_grid_pallas(*a)))
    return cases


CASES = {"k2k5": k2k5_cases, "k6k7": k6k7_cases}


if __name__ == "__main__":
    with open(sys.argv[1], "w") as f:
        json.dump({label: device_us(run) for label, _, run in CASES[sys.argv[2]]()}, f)
