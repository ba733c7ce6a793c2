"""K4: per-row dynamic int8 quantization fused into an int8 matmul (port of
``tstar_tpu/kernels/quant_matmul.py`` ``w8a8_matmul``).

Math (``dense_w8a8`` of the reference, bit for bit):

    xs  = max(max_k |x[r, k]|, 1e-12) / 127              (f32, per row)
    q   = clip(round_half_even(x / xs), -127, 127)       (int8)
    acc = sum_k q[r, k] * w[k, n]                        (int32, exact)
    y   = ((f32(acc) * xs) * w_scale[n]) + bias[n]       (f32, each op rounded)

then one rounding to the output dtype.  The CUDA kernel is ``csrc/w8a8.cu``
(design and H100 bounds in its header); its integer wgmma reads the weight
K-major, so it takes ``w_t``, the (N, K) transpose, which the int8 tower
makes once per scorer beside the (K, N) kernel.  ``w8a8_matmul_plain`` is the same
math in plain PyTorch; it forms the integer product exactly as a float64
matmul (|acc| <= 127^2 * K is far below 2^53), because an int8
``torch.matmul`` returns int8 and overflows, and an f32 product is not exact
once |acc| > 2^24.  The wrapper runs the plain version for a CPU tensor, and
for a CUDA tensor launches the kernel or raises.  The reference's opt-in
(``TSTAR_W8A8_KERNEL``) was a TPU gate; on the card every ``dense_w8a8``
call runs the kernel.

K4's second mode, ``w8a8_matmul_rowpar``, is a row-parallel layer's share
under Megatron tensor parallelism (the int8 tower sharded by
``parallel/shardings.shard_module``): a rank holds K/T rows of the weight and
x's matching K/T columns, and gets the whole rows' scales ``xs`` (the
caller all-reduces the rows' local absmax, MAX).  It quantizes x with those
scales and returns the int32 partial product, undequantized:

    q   = clip(round_half_even(x / xs), -127, 127)       (int8)
    acc = sum_{k local} q[r, k] * w[k, n]                (int32, exact)

The caller sums the ranks' ``acc`` (exact in int32) and dequantizes once
(``dequantize``), so T ranks give the one-rank result bit for bit
(``ops/quant.dense_w8a8_row_parallel``).  It is the same CUDA kernel
(``csrc/w8a8.cu``, its int32-output instances); its launches are counted
apart, on ``w8a8_matmul_rowpar.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tstar_tpu_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """max_k |x[..., k]| in f32, (..., 1)."""
    return x.float().abs().amax(dim=-1, keepdim=True)


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """Per-row scales ``max(amax, 1e-12) / 127`` (f32) from row absmaxes."""
    amax = amax.clamp_min(1e-12)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient the kernel computes
    return amax / torch.full_like(amax, 127.0)


def quantize_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as int8; ``torch.round`` rounds half
    to even, as ``jnp.round``."""
    return torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row (last-axis) int8 quantization.

    Returns (x_int8 (..., K), scale (..., 1) f32) with x ~= x_int8 * scale.
    """
    scale = activation_scale(row_absmax(x))
    return quantize_rows(x, scale), scale


def dequantize(acc: torch.Tensor, xs: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """``((f32(acc) * xs) * w_scale) + bias``, each op rounded, then one
    rounding to ``out_dtype``: K4's epilogue."""
    return (acc.float() * xs * w_scale.float() + bias.float()).to(out_dtype)


def w8a8_matmul_plain(
    x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """(..., K) float x (K, N) int8 -> (..., N) ``out_dtype``; the kernel's math."""
    q, xs = quantize_activation(x)
    acc = torch.matmul(q.double(), w_i8.double()).float()   # exact, then rounded once
    return dequantize(acc, xs, w_scale, bias, out_dtype)


def w8a8_matmul_rowpar_plain(x: torch.Tensor, xs: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """(..., K) float x with its whole rows' scales xs (..., 1) f32, (K, N)
    int8 -> the int32 product (..., N); K4's row-parallel mode's math."""
    q = quantize_rows(x, xs)
    return torch.matmul(q.double(), w_i8.double()).to(torch.int32)   # exact


# csrc/w8a8.cu: K in whole rows of a warp's 8-value groups, N in 128-column
# tiles, and the 64-row int8 slab (64 K bytes) plus two 16 KB weight stages
# within one CTA's 227 KB of shared memory.
_K_STEP, _N_STEP = 256, 128
MAX_K = 3072


def supported_shape(k: int, n: int) -> bool:
    """Whether K4 takes a (K, N) weight.  Not the reference's gate (K and N
    multiples of 128, K * N <= 768 * 3072, 128 rows or more): this one is
    K4's own tiling and shared-memory limit.  The int8 tower's route plan
    (``models/owlvit_quant.quantize_vision_tower``) reads it."""
    return k % _K_STEP == 0 and n % _N_STEP == 0 and k <= MAX_K


def _check_transposed(w_i8: torch.Tensor, w_t: torch.Tensor) -> None:
    k, n = w_i8.shape
    if w_t.shape != (n, k):
        raise ValueError(f"w_t must be the ({n}, {k}) transpose of the kernel, got {tuple(w_t.shape)}")


def _check_operands(x, w_i8, w_t):
    """The checks both modes share -> the rows of x."""
    k, n = w_i8.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, the int8 kernel has K={k}")
    if not supported_shape(k, n):
        raise ValueError(f"w8a8 kernel needs K a multiple of {_K_STEP} up to {MAX_K} and N a "
                         f"multiple of {_N_STEP}, got K={k}, N={n}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"w8a8 kernel takes bf16/f32 in, got {x.dtype}")
    if w_t is None:
        raise ValueError("w8a8 kernel reads the weight as W^T (N, K): pass w_t, made once "
                         "beside the (K, N) kernel (models/owlvit_quant.quantize_vision_tower)")
    _check_transposed(w_i8, w_t)
    if w_t.dtype != torch.int8:
        raise TypeError(f"w8a8 kernel needs an int8 weight, got {w_t.dtype}")
    if w_t.get_device() != x.get_device():
        raise ValueError(f"w8a8 operands on {w_t.device} and {x.device}")
    if not (x.is_contiguous() and w_t.is_contiguous()):
        raise ValueError("w8a8 kernel needs a contiguous x and (N, K) weight")
    if x.data_ptr() % 16 or w_t.data_ptr() % 16:
        raise ValueError("w8a8 kernel needs 16-byte aligned x and weight")
    rows = x.numel() // k
    if rows == 0:
        raise ValueError("w8a8 kernel got an empty input")
    return rows


def _launch(x, w_i8, w_t, w_scale, bias, out_dtype):
    rows = _check_operands(x, w_i8, w_t)
    k, n = w_i8.shape
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"w8a8 kernel writes bf16/f32, got {out_dtype}")
    if w_scale.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"w_scale/bias must be ({n},), got {tuple(w_scale.shape)}, {tuple(bias.shape)}")
    if w_scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("w8a8 kernel needs f32 w_scale and bias")
    dev = x.get_device()
    for t in (w_scale, bias):
        if t.get_device() != dev:
            raise ValueError(f"w8a8 operands on {t.device} and {x.device}")
    if not (w_scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("w8a8 kernel needs a contiguous w_scale and bias")
    out = torch.empty(*x.shape[:-1], n, dtype=out_dtype, device=x.device)
    status = _build.call(
        _build.load().tstar_w8a8, dev, x.data_ptr(), w_t.data_ptr(), w_scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), rows, k, n, _DTYPE_CODES[x.dtype],
        _DTYPE_CODES[out_dtype],
    )
    _build.check(status, "tstar_w8a8")
    w8a8_matmul.launches += 1
    return out


def w8a8_matmul(
    x: torch.Tensor,          # (..., K) float activations
    w_i8: torch.Tensor,       # (K, N) int8 kernel
    w_scale: torch.Tensor,    # (N,) f32 per-channel scale
    bias: torch.Tensor,       # (N,) f32 (zeros when the layer has none)
    out_dtype: torch.dtype,
    w_t: Optional[torch.Tensor] = None,   # (N, K) int8: w_i8 transposed, contiguous
) -> torch.Tensor:
    """Fused ``dense_w8a8``.  CPU tensor: the plain version (``w_t``, if
    given, only checked).  CUDA tensor: the K4 kernel, which reads ``w_t``
    (made once per scorer, never per call), or raise."""
    if x.device.type == "cpu":
        if w_t is not None:
            _check_transposed(w_i8, w_t)
        return w8a8_matmul_plain(x, w_i8, w_scale, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no w8a8 kernel for device {x.device}")
    return _launch(x, w_i8, w_t, w_scale, bias, out_dtype)


w8a8_matmul.launches = 0  # kernel launches (not plain-version calls)


def _launch_rowpar(x, xs, w_i8, w_t):
    rows = _check_operands(x, w_i8, w_t)
    k, n = w_i8.shape
    if xs.shape != (*x.shape[:-1], 1) or xs.dtype != torch.float32:
        raise ValueError(f"xs must be f32 {(*x.shape[:-1], 1)}, got {xs.dtype} {tuple(xs.shape)}")
    if xs.get_device() != x.get_device() or not xs.is_contiguous():
        raise ValueError("w8a8 row-parallel kernel needs a contiguous xs on x's device")
    out = torch.empty(*x.shape[:-1], n, dtype=torch.int32, device=x.device)
    status = _build.call(
        _build.load().tstar_w8a8_rowpar, x.get_device(), x.data_ptr(), w_t.data_ptr(),
        xs.data_ptr(), out.data_ptr(), rows, k, n, _DTYPE_CODES[x.dtype],
    )
    _build.check(status, "tstar_w8a8_rowpar")
    w8a8_matmul_rowpar.launches += 1
    return out


def w8a8_matmul_rowpar(
    x: torch.Tensor,          # (..., K) float activations: this rank's K columns
    xs: torch.Tensor,         # (..., 1) f32: the whole rows' scales
    w_i8: torch.Tensor,       # (K, N) int8: this rank's K rows of the kernel
    w_t: Optional[torch.Tensor] = None,   # (N, K) int8: w_i8 transposed, contiguous
) -> torch.Tensor:
    """K4's row-parallel mode (module docstring) -> the int32 partial product
    (..., N).  CPU tensor: the plain version (``w_t``, if given, only
    checked).  CUDA tensor: the kernel, which reads ``w_t``, or raise."""
    if x.device.type == "cpu":
        if w_t is not None:
            _check_transposed(w_i8, w_t)
        return w8a8_matmul_rowpar_plain(x, xs, w_i8)
    if x.device.type != "cuda":
        raise ValueError(f"no w8a8 kernel for device {x.device}")
    return _launch_rowpar(x, xs, w_i8, w_t)


w8a8_matmul_rowpar.launches = 0  # kernel launches in the row-parallel mode
