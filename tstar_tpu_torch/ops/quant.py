"""Int8 dense layers of the quantized detector (port of ``tstar_tpu/ops/quant.py``).

Scheme: symmetric per-output-channel weight quantization (static, once per
scorer) and symmetric per-row dynamic activation quantization (absmax).
``dense_w8a8`` runs through K4 (``kernels/quant_matmul.py``), the int8
tensor-core kernel; ``dense_w8a16`` dequantizes the weight and runs a float
matmul, as the reference computes it outside any kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tstar_tpu_torch.kernels.quant_matmul import (  # noqa: F401
    quantize_activation,
    w8a8_matmul,
)


def quantize_weight(w, axis: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization of an (in, out) kernel.

    Channels are the output features (reduction over ``axis=0``).  Returns
    (w_int8 (in, out), scale (out,) float32) with w ~= w_int8 * scale; numpy,
    as the reference (``np.round`` rounds half to even).
    """
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=axis)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(w / np.expand_dims(scale, axis)), -127, 127)
    return q.astype(np.int8), scale.astype(np.float32)


def dense_w8a16(
    x: torch.Tensor,                      # (..., K) float activations
    w_i8: torch.Tensor,                   # (K, N) int8 kernel
    w_scale: torch.Tensor,                # (N,) f32 per-channel scale
    bias: Optional[torch.Tensor] = None,  # (N,) f32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Weight-only int8 dense: ``x @ dequant(w) + b``.

    The weight is dequantized in f32 and rounded to x's dtype; the product
    accumulates in f32 (the reference's ``preferred_element_type``): an f32
    matmul of the two operands, whose products are exact for bf16 inputs.
    """
    out_dtype = out_dtype or x.dtype
    w = (w_i8.float() * w_scale).to(x.dtype)
    y = torch.matmul(x.float(), w.float())
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def dense_w8a8(
    x: torch.Tensor,                      # (..., K) float activations
    w_i8: torch.Tensor,                   # (K, N) int8 kernel
    w_scale: torch.Tensor,                # (N,) f32 per-channel scale
    bias: Optional[torch.Tensor] = None,  # (N,) f32
    out_dtype: Optional[torch.dtype] = None,
    w_t: Optional[torch.Tensor] = None,   # (N, K) int8, w_i8 transposed once
) -> torch.Tensor:
    """Quantized dense layer: ``round(x/sx) @ w_int8 * sx * sw + b``.

    K4 on a CUDA tensor (it reads ``w_t``), its plain version on a CPU
    tensor.  A missing bias adds zeros (the same values as the reference,
    which skips the add).
    """
    out_dtype = out_dtype or x.dtype
    if bias is None:
        bias = torch.zeros(w_i8.shape[1], dtype=torch.float32, device=x.device)
    return w8a8_matmul(x, w_i8, w_scale, bias, out_dtype, w_t=w_t)
