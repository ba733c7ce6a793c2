"""Build and load the CUDA kernels of ``tstar_tpu_torch/csrc``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into ONE shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The build runs at first use, into ``tstar_tpu_torch/_build/``
(git-ignored), under a name keyed by the sources' hash, so an edited source
never loads a stale library.  There is no fallback: a missing ``nvcc`` or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libtstar_kernels_{h.hexdigest()[:16]}.so"


def compile_library(sources, out: Path, flags=()) -> Path:
    """Compile ``sources`` into the shared library ``out``: one ``nvcc -c``
    per source, all started together, then one link.  The compiler's
    register, spill and shared-memory report (``-Xptxas -v``) is kept beside
    the library as ``<name>.ptxas.txt``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sources:
        obj = out.parent / f"{tag}.{Path(src).stem}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", *flags,
               "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    report, failed = [], []
    for obj, cmd, proc in jobs:          # wait for every job, failed or not
        _, err = proc.communicate()
        report.append(f"== {obj.name}\n{err}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        # libcuda: the wgmma kernels encode their TMA tensor maps
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *[str(o) for o, _, _ in jobs],
               "-lcuda"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    finally:
        for obj, _, _ in jobs:
            obj.unlink(missing_ok=True)
    ptxas_report(out).write_text("\n".join(report))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def ptxas_report(lib: Path) -> Path:
    """Where ``compile_library`` keeps the ``-Xptxas -v`` report of ``lib``."""
    return lib.parent / (lib.stem + ".ptxas.txt")


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    out = library_path()
    if out.exists():
        return out
    return compile_library(sorted(CSRC.glob("*.cu")), out)


def open_library(path: Path) -> ctypes.CDLL:
    """Load a library built by ``compile_library`` from every source and
    declare its entry points' argument types."""
    lib = ctypes.CDLL(str(path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("tstar_mha_bf16", "tstar_mha_p16_bf16", "tstar_mha_f32"):
        fn = getattr(lib, name)
        # qkv, out, B, S, D, H, scale_log2e, stream
        fn.argtypes = [vp, vp, ci, ci, ci, ci, cf, vp]
        fn.restype = ci
    for name in ("tstar_patch_embed_bf16", "tstar_patch_embed_f32"):
        fn = getattr(lib, name)
        # pixels, kernel, out, B, H, W, C, p, D, stream
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    # B, H, W, C, p, D, int[5] out: CTAs, columns per CTA, stages, smem bytes,
    # K chunks per stage
    lib.tstar_patch_embed_config.argtypes = [ci] * 6 + [ctypes.POINTER(ci)]
    lib.tstar_patch_embed_config.restype = ci
    # x, w^T (N, K), w_scale, bias, out, R, K, N, x dtype, out dtype, stream
    lib.tstar_w8a8.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.tstar_w8a8.restype = ci
    # K4's row-parallel mode: x, w^T (N, K), row scales, int32 out, R, K, N, x dtype, stream
    lib.tstar_w8a8_rowpar.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.tstar_w8a8_rowpar.restype = ci
    # R, K, N, int[6] out: CTAs, N tiles per CTA, stages, rows per CTA, smem bytes,
    # CTAs per cluster
    lib.tstar_w8a8_config.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.tstar_w8a8_config.restype = ci
    if hasattr(lib, "tstar_w8a8_trace"):  # a build with -DTSTAR_W8A8_TRACE
        lib.tstar_w8a8_trace.argtypes = [ctypes.POINTER(ctypes.c_longlong), ci]
        lib.tstar_w8a8_trace.restype = ci
    # x, scale, bias, out, R, D, dtype, eps, stream
    lib.tstar_layernorm.argtypes = [vp, vp, vp, vp, ci, ci, ci, cf, vp]
    lib.tstar_layernorm.restype = ci
    # x, scale, bias, w, b (all bf16), out, R, D, N, eps, stream
    lib.tstar_ln_matmul_bf16.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, cf, vp]
    lib.tstar_ln_matmul_bf16.restype = ci
    # R, D, N, int[6] out: CTAs, N tiles per CTA, W stages, CTAs per cluster, smem bytes,
    # columns per warpgroup
    lib.tstar_ln_matmul_config.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.tstar_ln_matmul_config.restype = ci
    # cache, secs, secs int64?, awk, bias, ah, wtap, htap, w, out,
    # B, N, ch, cw, rows, cols, cell_h, cell_w, p, D, stream
    lib.tstar_grid_embed.argtypes = [vp, vp, ci] + [vp] * 7 + [ci] * 10 + [vp]
    lib.tstar_grid_embed.restype = ci
    # B, N, ch, cw, rows, cols, cell_h, cell_w, p, D, height taps?, int[6] out:
    # CTAs, columns per CTA, CTAs per cluster, stages, smem bytes, values per chunk
    lib.tstar_grid_embed_config.argtypes = [ci] * 11 + [ctypes.POINTER(ci)]
    lib.tstar_grid_embed_config.restype = ci
    # cache, secs, secs int64?, htap, hwt, wtap, wwt, scale, bias, out,
    # N, ch, cw, rows, cols, cell_h, cell_w, height identity?, out dtype, stream
    lib.tstar_grid_pack.argtypes = [vp, vp, ci] + [vp] * 7 + [ci] * 9 + [vp]
    lib.tstar_grid_pack.restype = ci
    for name in ("tstar_flash_bf16", "tstar_flash_f32"):
        fn = getattr(lib, name)
        # q, k, v, out, B, S, H, D, (batch, seq, head) strides of q, k, v,
        # sm_scale, stream
        fn.argtypes = [vp] * 4 + [ci] * 4 + [ctypes.c_longlong] * 9 + [cf, vp]
        fn.restype = ci
    # B, S, H, int[4] out: warpgroups per CTA, stages, resident, smem bytes
    lib.tstar_attn_config.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.tstar_attn_config.restype = ci
    # boxes, order (int64), iou threshold, B, N, max_out, mask scratch, keep,
    # valid, stream
    lib.tstar_nms.argtypes = [vp, vp, cf, ci, ci, ci, vp, vp, vp, vp]
    lib.tstar_nms.restype = ci
    # x, delta, scale, res, out, R, D, eps, stream
    lib.tstar_add_rms_norm.argtypes = [vp] * 5 + [ci, ci, cf, vp]
    lib.tstar_add_rms_norm.restype = ci
    # q, k, v, q/k/v biases, cos, sin, mask, k cache, v cache, index, out,
    # B, M, H, KV, scale, stream
    lib.tstar_decode_attention.argtypes = [vp] * 13 + [ci] * 4 + [cf, vp]
    lib.tstar_decode_attention.restype = ci
    # gate, up, out, n, stream
    lib.tstar_silu_mul.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
    lib.tstar_silu_mul.restype = ci
    # x, ids, weights, w13, w2, sw13, sw2, act, out, counts, route log, index,
    # B, K, NS, D, I, M, stream
    lib.tstar_moe_decode.argtypes = [vp] * 12 + [ci] * 6 + [vp]
    lib.tstar_moe_decode.restype = ci
    # x, gate (E, D), bias, ids, weights, scratch, tickets, B, D, E, K, scale, stream
    lib.tstar_moe_route.argtypes = [vp] * 7 + [ci] * 4 + [cf, vp]
    lib.tstar_moe_route.restype = ci
    # y, cos, sin, norm scale, mask, cache, index, W_UK, W_UV, q and partials scratch, out,
    # B, M, the attention's CTAs a row, eps, scale, stream
    lib.tstar_mla_decode.argtypes = [vp] * 12 + [ci, ci, ci, cf, cf, vp]
    lib.tstar_mla_decode.restype = ci
    lib.tstar_error_string.argtypes = [ci]
    lib.tstar_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = open_library(build())
    return _lib


def raw_stream(device_index: int) -> int:
    """The handle of ``device_index``'s current CUDA stream, without building
    a ``torch.cuda.Stream`` object: a launch's host path is on the search's
    critical path."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def call(fn, device_index: int, *args) -> int:
    """``fn(*args, stream)`` on ``device_index``'s current stream, with that
    device current (made so for the call only where it is not already)."""
    if device_index == torch.cuda.current_device():
        return fn(*args, raw_stream(device_index))
    with torch.cuda.device(device_index):
        return fn(*args, raw_stream(device_index))


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        msg = load().tstar_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({msg})")
