"""K2-K7 on one GPU: device time per launch.

    python -m tstar_tpu_torch.tools.kernel_bench [--kernels k2k5 k3 k4 k6k7]
        [--old-checkout DIR] [--variant NAME=FLAGS ...] [--out FILE.json]

At the main path's shapes (K3: 577, 8 x 577 and 16 x 577 rows of 768, 256
rows of 512 and 74 of SigLIP's 1152, bf16 and f32, scale and bias in x's
dtype; K4: the int8
tower's four dense layers at R = 577, 8 x 257, 16 x 257 and 16 x 577; K2 and
K5 in bf16 at ``tools/kernel_cases.py``'s shapes: 768^2 images at B = 1, 3, 8
and 16, 512^2 at B = 8 and 16, patch 16 at 768^2 B = 1 and 8; ln1 -> qkv
and ln2 -> fc1 at R = 577, 8 x 577, 16 x 257 and 16 x 577; K6 from a
192x384 cache at B = 1, 3 and 16 and patch 16, and from a 180x320 one at
B = 1; K7 from both caches into the 768^2 canvas in bf16 and f32, and into
a 772^2 one) each
kernel is launched 50 times back to back under ``torch.profiler``, and the
mean duration of its device events is reported beside the same for the
PyTorch call it is held against (K2: ``conv2d`` stride 32 on the
channels-last view; K3: ``F.layer_norm``; K4: ``torch._int_mm`` on the
already quantized activations, the GEMM alone; K5: ``layer_norm`` +
``addmm``, two calls; K6: ``conv2d`` on a canvas already built, the GEMM
alone; K7: bilinear ``interpolate`` of the 16 frames, the resize alone) and
the bound (bytes over 3.35 TB/s, operations over 989 TFLOP/s bf16, 1,979
TOP/s int8 or 67 TFLOP/s f32).  For K2, K5, K6 and K7 it also reports the
CUDA-event milliseconds a call (20 calls after 3 warm-ups, as
``chip_smoke.py`` phase 3 times) of the kernel, its plain version on the
same inputs and the PyTorch call.  Where the host, not the card, sets
the pace of a back-to-back loop (``chip_smoke.py`` phase 3's CUDA-event
times at small shapes), these device times still say what the kernel costs
the card.

``--old-checkout DIR`` also times K2 and K5 (``k2k5``), K6 and K7
(``k6k7``) as another checkout of the port builds and wraps them (e.g. the
parent commit, unpacked into a git-ignored folder: ``git archive <commit>
tstar_tpu_torch | tar -x -C _archive/old``), running this checkout's
``tools/kernel_cases.py`` in a subprocess against that checkout's package
and build, in turns with this checkout's (old, new, new, old; each the mean
of its two turns) on the same seeded inputs.

``--variant NAME=FLAGS`` builds the kernel library once more with extra
``nvcc`` flags and times K2, K4, K5, K6 and K7 from it too, in turns with the
default build (default, variants, variants reversed, default; each time the
mean of its two turns; every variant's output must agree with the plain
version), e.g. ``-DTSTAR_W8A8_MAX_CLUSTER=1`` (no cluster shares a slab's
quantization).  A variant built with ``-DTSTAR_W8A8_TRACE`` also records
each CTA's clock at the kernel's phase boundaries, and the tool prints the mean
time of each phase per CTA (``csrc/w8a8.cu``: entry, cluster barrier,
quantization of its rows, every slab complete, first W^T tile, products,
epilogue) and the launch's span.  Needs a CUDA device; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
from torch.nn import functional as F

from tstar_tpu_torch.kernels import _build, layernorm, quant_matmul
from tstar_tpu_torch.tools import kernel_cases
from tstar_tpu_torch.tools.kernel_cases import device_us

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
LN_SHAPES = ((577, 768), (8 * 577, 768), (16 * 577, 768), (256, 512), (74, 1152))
W8A8_ROWS = (577, 8 * 257, 16 * 257, 16 * 577)
W8A8_LAYERS = (("qkv", 768, 2304, torch.float32, torch.bfloat16),
               ("out_proj", 768, 768, torch.bfloat16, torch.bfloat16),
               ("fc1", 768, 3072, torch.float32, torch.float32),
               ("fc2", 3072, 768, torch.float32, torch.bfloat16))


def old_us(old_root: Path, which: str) -> dict:
    """The device us per launch of the cases of set ``which`` (k2k5, k6k7)
    as ``old_root``'s checkout builds and wraps the kernels, in a subprocess
    (its library is its own)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "old.json"
        env = {**os.environ, "PYTHONPATH": str(old_root.resolve())}
        subprocess.run([sys.executable, kernel_cases.__file__, str(out), which], cwd=old_root,
                       env=env, check=True, timeout=900)
        return json.loads(out.read_text())


@contextlib.contextmanager
def library(lib):
    """The kernel wrappers launch from ``lib`` inside the block."""
    saved, _build._lib = _build._lib, lib
    try:
        yield
    finally:
        _build._lib = saved


def bench_cases(card: str, which: str, old_root, libs: dict, results: dict) -> None:
    """The cases of set ``which`` (K2 and K5, or K6 and K7): device us per
    launch from this checkout's library and its variants (and the old
    checkout's, first and last), in turns; each library's outputs against
    the plain versions; the PyTorch yardstick and the bound."""
    cases = kernel_cases.CASES[which]()
    turns = list(libs) + list(libs)[::-1]
    if old_root:
        turns = ["old"] + turns + ["old"]
    times = {label: {} for label, _, _ in cases}
    for turn in turns:
        if turn == "old":
            got = old_us(old_root, which)
        else:
            with library(libs[turn]):
                got = {label: device_us(run) for label, _, run in cases}
        for label, us in got.items():
            times[label][turn] = times[label].get(turn, 0.0) + us / turns.count(turn)
    for label, args, run in cases:
        for name, lib in libs.items():
            with library(lib):
                out = run()
            torch.cuda.synchronize()
            if not agrees(label, args, out):
                raise SystemExit(f"{label} ({name}): the kernel disagrees with its plain version")
        lib_fn, lib_name, n_bytes, n_ops, ops_rate = yardstick(label, args)
        lib_us = device_us(lib_fn)
        bound_us = max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_rate) * 1e6
        # CUDA-event ms a call (chip_smoke.py phase 3's timing) of the default
        # library's kernel, its plain version and the PyTorch call
        with library(libs["default"]):
            events = {"kernel": cuda_ms(run), "plain": cuda_ms(plain_call(label, args)),
                      "library": cuda_ms(lib_fn)}
        row = {"case": label, "device_us": times[label], "library": lib_name,
               "library_us": lib_us, "bound_us": bound_us, "events_ms": events}
        results[which].append(row)
        t = ", ".join(f"{k} {v:.2f}" for k, v in times[label].items())
        print(f"[{label.split()[0].lower()}] {label}: device us {t}; {lib_name} {lib_us:.2f} us, "
              f"bound {bound_us:.2f} us; CUDA events ms a call: kernel {events['kernel']:.4f}, "
              f"plain {events['plain']:.4f}, {lib_name} {events['library']:.4f}  ({card})",
              flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, fenced by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_call(label, args):
    """The kernel's plain PyTorch version on the case's inputs, as a call."""
    from tstar_tpu_torch.kernels import grid_embed, ln_matmul, pallas_grid, patch_matmul

    if label.startswith("K2"):
        return lambda: patch_matmul.patch_embed_matmul_plain(*args)
    if label.startswith("K6"):
        a, kw = args
        return lambda: grid_embed.grid_cell_embed_plain(*a, **kw)
    if label.startswith("K7"):
        return lambda: pallas_grid.build_detector_grid_pallas_plain(*args)
    return lambda: ln_matmul.ln_matmul_plain(*args, 1e-5)


def _within(out, want, atol, rtol) -> bool:
    return bool(((out.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())


def agrees(label, args, out) -> bool:
    """K2 within 1e-4 + one bf16 ulp of the plain version in f32; K5 within
    ``bf16_error_bound``; K6 within 1e-4 + one bf16 ulp, K7 1e-5 (f32) or
    1e-6 + one ulp (bf16) of its plain version (``chip_smoke.py`` phase 3's
    tolerances)."""
    from tstar_tpu_torch.kernels import grid_embed, ln_matmul, pallas_grid, patch_matmul

    ulp = 2.0 ** -7
    if label.startswith("K2"):
        px, w = args
        want = patch_matmul.patch_embed_matmul_plain(px.float(), w.float()).to(px.dtype)
        return _within(out, want, 1e-4, ulp)
    if label.startswith("K6"):
        a, kw = args
        return _within(out, grid_embed.grid_cell_embed_plain(*a, **kw), 1e-4, ulp)
    if label.startswith("K7"):
        want = pallas_grid.build_detector_grid_pallas_plain(*args)
        return _within(out, want, *((1e-5, 1e-5) if args[-1] == torch.float32 else (1e-6, ulp)))
    x, scale, bias, w, b = args
    want = ln_matmul.ln_matmul_plain(x, scale, bias, w, b, 1e-5)
    bound = ln_matmul.bf16_error_bound(x, scale, bias, w, b, 1e-5, want)
    return bool(((out.float() - want.float()).abs() <= bound).all())


def yardstick(label, args):
    """The PyTorch call (a callable), its name, the bytes and operations of
    the function, and the peak rate of those operations."""
    if label.startswith("K2"):
        px, w = args
        b, hw, p = px.shape[0], px.shape[1], w.shape[0]
        x_nchw, w_oihw = px.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        m, k = b * (hw // p) ** 2, p * p * 3
        return (lambda: F.conv2d(x_nchw, w_oihw, stride=p), "conv2d", (px.numel() + w.numel() + m * 768) * 2, 2 * m * k * 768,
                BF16_OPS_PER_S)
    if label.startswith("K6"):
        (cache, _, _, _, _, w), kw = args
        b, (ch, cw), p = cache.shape[0], cache.shape[2:4], kw["patch_size"]
        g = torch.Generator(device=cache.device).manual_seed(b)
        canvas = torch.randn(b, 3, 768, 768, generator=g, device=cache.device).to(w.dtype)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        m, k = b * (768 // p) ** 2, p * p * 3
        n_bytes = b * 16 * ch * cw * 3 + k * 768 * 2 + m * 768 * 2
        return (lambda: F.conv2d(canvas, w_oihw, stride=p)), "conv2d on a built canvas", n_bytes, 2 * m * k * 768, BF16_OPS_PER_S
    if label.startswith("K7"):
        cache, secs, _, size, dt = args
        ch, cw = cache.shape[1:3]
        frames = cache[secs].permute(0, 3, 1, 2).float()
        lib = lambda: F.interpolate(frames, size=(size // 4, size // 4),  # noqa: E731
                                    mode="bilinear", align_corners=False)
        taps = 2 if ch == size // 4 else 6             # multiply-adds a value
        n_bytes = 16 * ch * cw * 3 + size * size * 3 * torch.empty((), dtype=dt).element_size()
        return (lib, "interpolate bilinear (resize only)", n_bytes,
                size * size * 3 * 2 * (taps + 1), F32_OPS_PER_S)
    x, scale, bias, w, b = args
    x2 = x[0]
    rows, n = x2.shape[0], w.shape[1]
    n_bytes = rows * 768 * 2 + 768 * n * 2 + 2 * 768 * 2 + n * 2 + rows * n * 2
    return (lambda: torch.addmm(b, F.layer_norm(x2, (768,), scale, bias, 1e-5), w)), \
        "layer_norm + addmm", n_bytes, 2 * rows * 768 * n, BF16_OPS_PER_S


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    ap.add_argument("--kernels", nargs="*", default=["k2k5", "k3", "k4", "k6k7"],
                    choices=["k2k5", "k3", "k4", "k6k7"], help="kernels to time")
    ap.add_argument("--old-checkout", type=Path, default=None,
                    help="root of another checkout whose K2 and K5, K6 and K7 to time in turns")
    ap.add_argument("--variant", action="append", default=[], help="NAME=nvcc flags")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"card": card, "k2k5": [], "k3": [], "k4": [], "k6k7": []}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = {"default": _build.load()}
    for spec in args.variant:
        name, _, flags = spec.partition("=")
        libs[name] = variant_library(flags.split())
    for which in ("k2k5", "k6k7"):
        if which in args.kernels:
            bench_cases(card, which, args.old_checkout, libs, results)

    for rows, d in LN_SHAPES if "k3" in args.kernels else ():
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

    order = list(libs) + list(libs)[::-1]
    for rows in W8A8_ROWS if "k4" in args.kernels else ():
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
