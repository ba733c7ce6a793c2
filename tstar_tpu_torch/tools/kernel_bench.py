"""K3 (LayerNorm) and K4 (W8A8 matmul) on one GPU: device time per launch.

    python -m tstar_tpu_torch.tools.kernel_bench [--variant NAME=FLAGS ...]
        [--out FILE.json]

At the main path's shapes (K3: 577, 8 x 577 and 16 x 577 rows of 768 and
256 rows of 512, bf16 and f32, scale and bias in x's dtype; K4: the int8
tower's four dense layers at R = 577, 8 x 257, 16 x 257 and 16 x 577) each
kernel is launched 50 times back to back under ``torch.profiler``, and the
mean duration of its device events is reported beside the same for the
PyTorch call it is held against (K3: ``F.layer_norm``; K4: ``torch._int_mm``
on the already quantized activations, the GEMM alone) and the bound (bytes
over 3.35 TB/s, operations over 1,979 TOP/s int8).  Where the host, not the
card, sets the pace of a back-to-back loop (``chip_smoke.py`` phase 3's
CUDA-event times at small shapes), these device times still say what the
kernel costs the card.

``--variant NAME=FLAGS`` builds the kernel library once more with extra
``nvcc`` flags and times K4 from it too, in turns with the default build
(default, variants, variants reversed, default; each time the mean of its
two turns; every variant's output must equal the plain version's), e.g.
``-DTSTAR_W8A8_MAX_CLUSTER=1``: no cluster shares a slab's quantization.  A variant built with ``-DTSTAR_W8A8_TRACE`` also records each
CTA's clock at the kernel's phase boundaries, and the tool prints the mean
time of each phase per CTA (``csrc/w8a8.cu``: entry, cluster barrier,
quantization of its rows, every slab complete, first W^T tile, products,
epilogue) and the launch's span.  Needs a CUDA device; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess

import torch
from torch.nn import functional as F

from tstar_tpu_torch.kernels import _build, layernorm, quant_matmul

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
LN_SHAPES = ((577, 768), (8 * 577, 768), (16 * 577, 768), (256, 512))
W8A8_ROWS = (577, 8 * 257, 16 * 257, 16 * 577)
W8A8_LAYERS = (("qkv", 768, 2304, torch.float32, torch.bfloat16),
               ("out_proj", 768, 768, torch.bfloat16, torch.bfloat16),
               ("fc1", 768, 3072, torch.float32, torch.float32),
               ("fc2", 3072, 768, torch.float32, torch.bfloat16))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_us(fn, iters: int = 50) -> float:
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


def variant_library(flags):
    """The kernel library built with extra ``nvcc`` flags, loaded."""
    tag = hashlib.sha256(" ".join(flags).encode()).hexdigest()[:8]
    path = _build.library_path()
    out = path.with_name(f"{path.stem}_v{tag}.so")
    if not out.exists():
        _build.compile_library(sorted(_build.CSRC.glob("*.cu")), out, flags)
    return _build.open_library(out)


TRACE_PHASES = ("cluster barrier", "quantize", "slabs complete", "first W tile", "products",
                "epilogue")


def w8a8_phases(lib, run, rows, k, n):
    """Mean microseconds per CTA of each traced phase of one launch, and the
    launch's span (first CTA's entry to last CTA's end)."""
    cfg = (ctypes.c_int * 6)()
    _build.check(lib.tstar_w8a8_config(rows, k, n, cfg), "tstar_w8a8_config")
    ctas = cfg[0]
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (12 * ctas))()
    _build.check(lib.tstar_w8a8_trace(buf, ctas), "tstar_w8a8_trace")
    t = torch.tensor(list(buf), dtype=torch.float64).view(ctas, 12)
    ns_per_clock = (t[:, 8] - t[:, 7]) / (t[:, 6] - t[:, 0])
    phases = {name: ((t[:, i + 1] - t[:, i]) * ns_per_clock).mean().item() / 1e3
              for i, name in enumerate(TRACE_PHASES)}
    # within the quantization, warp 0: its first rows read, the cluster wait,
    # the first rows stored
    for name, (a, b) in (("first read", (1, 9)), ("cluster wait", (9, 10)),
                         ("first stored", (10, 11))):
        phases[name] = ((t[:, b] - t[:, a]) * ns_per_clock).mean().item() / 1e3
    phases["cta"] = ((t[:, 8] - t[:, 7]).mean() / 1e3).item()
    phases["span"] = ((t[:, 8].max() - t[:, 7].min()) / 1e3).item()
    return phases


def w8a8_call(lib, x, wt, ws, b, out, k, n):
    codes = quant_matmul._DTYPE_CODES
    rows = x.numel() // k

    def run():
        _build.check(_build.call(lib.tstar_w8a8, x.get_device(), x.data_ptr(), wt.data_ptr(),
                                 ws.data_ptr(), b.data_ptr(), out.data_ptr(), rows, k, n,
                                 codes[x.dtype], codes[out.dtype]), "tstar_w8a8")
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[], help="NAME=nvcc flags")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"card": card, "k3": [], "k4": []}

    for rows, d in LN_SHAPES:
        base = torch.randn(rows, d, generator=g, device=dev) * 3 + 1
        s, bias = torch.randn(2, d, generator=g, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            x, sd, bd = base.to(dt), s.to(dt), bias.to(dt)
            es = x.element_size()
            bound = (2 * rows * d * es + 2 * d * es) / HBM_BYTES_PER_S * 1e6
            k3 = device_us(lambda: layernorm.fused_layernorm(x, sd, bd))
            lib = device_us(lambda: F.layer_norm(x, (d,), sd, bd, 1e-5))
            row = {"shape": f"{rows}x{d}", "dtype": str(dt).split(".")[-1], "k3_us": k3,
                   "layer_norm_us": lib, "bound_us": bound}
            results["k3"].append(row)
            print(f"[k3] {row['shape']} {row['dtype']}: device {k3:.2f} us, layer_norm {lib:.2f} us, "
                  f"bound {bound:.2f} us ({100 * bound / k3:.0f}% of it)  ({card})", flush=True)

    libs = {"default": _build.load()}
    for spec in args.variant:
        name, _, flags = spec.partition("=")
        libs[name] = variant_library(flags.split())
    order = list(libs) + list(libs)[::-1]
    for rows in W8A8_ROWS:
        for name, k, n, xd, od in W8A8_LAYERS:
            x = (torch.randn(rows, k, generator=g, device=dev) * 3).to(xd)
            w = torch.randint(-127, 128, (k, n), generator=g, device=dev).to(torch.int8)
            wt = w.T.contiguous()
            ws = torch.rand(n, generator=g, device=dev) * 1e-3
            b = torch.randn(n, generator=g, device=dev) * 0.1
            out = torch.empty(rows, n, dtype=od, device=dev)
            q, _ = quant_matmul.quantize_activation(x)
            want = quant_matmul.w8a8_matmul_plain(x, w, ws, b, od)
            times = {label: 0.0 for label in libs}
            for label in order:
                run = w8a8_call(libs[label], x, wt, ws, b, out, k, n)
                run()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"K4 {label} {name} R={rows}: not equal to the plain version")
                times[label] += device_us(run) / 2
            phases = {label: w8a8_phases(lib, w8a8_call(lib, x, wt, ws, b, out, k, n), rows, k, n)
                      for label, lib in libs.items() if hasattr(lib, "tstar_w8a8_trace")}
            int_mm = device_us(lambda: torch._int_mm(q, w))
            n_bytes = rows * k * x.element_size() + k * n + 2 * n * 4 + rows * n * out.element_size()
            bound = max(n_bytes / HBM_BYTES_PER_S, 2 * rows * k * n / INT8_OPS_PER_S) * 1e6
            row = {"layer": name, "rows": rows, "k": k, "n": n, "device_us": times,
                   "int_mm_us": int_mm, "bound_us": bound, "phases_us": phases}
            results["k4"].append(row)
            t = ", ".join(f"{label} {v:.2f}" for label, v in times.items())
            print(f"[k4] {name} R={rows} {k}->{n}: device us {t}; int_mm {int_mm:.2f} us, "
                  f"bound {bound:.2f} us  ({card})", flush=True)
            for label, ph in phases.items():
                print(f"[k4]   {label} phases per CTA (us): "
                      + ", ".join(f"{k_} {v:.2f}" for k_, v in ph.items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
