"""Int8 dense layers of the quantized detector (port of ``tstar_tpu/ops/quant.py``).

Scheme: symmetric per-output-channel weight quantization (static, once per
scorer) and symmetric per-row dynamic activation quantization (absmax).
``dense_w8a8`` runs through K4 (``kernels/quant_matmul.py``), the int8
tensor-core kernel; ``dense_w8a16`` dequantizes the weight and runs a float
matmul, as the reference computes it outside any kernel.

Under Megatron tensor parallelism (``parallel/shardings.shard_module``) a
row-parallel layer's share is ``dense_w8a8_row_parallel`` (the whole rows'
scales from an all-reduced MAX, K4's row-parallel mode, an exact int32 sum
over the model group, one dequantization: the one-rank result bit for bit)
or ``dense_w8a16`` with ``reduce`` (the float product summed over the
group, then the bias once, as the float row-parallel ``Dense``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tstar_tpu_torch.kernels.quant_matmul import (  # noqa: F401
    activation_scale,
    dequantize,
    quantize_activation,
    row_absmax,
    w8a8_matmul,
    w8a8_matmul_rowpar,
    w8a8_matmul_rowpar_plain,
)
from tstar_tpu_torch.models.tensor_parallel import TensorParallel, all_reduce_, all_reduce_max_


def quantize_weight(w, axis: int = 0, absmax=None) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization of an (in, out) kernel.

    Channels are the output features (reduction over ``axis=0``).  Returns
    (w_int8 (in, out), scale (out,) float32) with w ~= w_int8 * scale; numpy,
    as the reference (``np.round`` rounds half to even).  ``absmax``, when
    given, is the channels' absmax over the whole kernel (a row-parallel
    shard holds only some of its rows).
    """
    w = np.asarray(w, np.float32)
    if absmax is None:
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
    reduce: Optional[TensorParallel] = None,
) -> torch.Tensor:
    """Weight-only int8 dense: ``x @ dequant(w) + b``.

    The weight is dequantized in f32 and rounded to x's dtype; the product
    accumulates in f32 (the reference's ``preferred_element_type``): an f32
    matmul of the two operands, whose products are exact for bf16 inputs.
    ``reduce``: a row-parallel shard's model group, over which the f32
    product is summed before the whole bias is added.
    """
    out_dtype = out_dtype or x.dtype
    w = (w_i8.float() * w_scale).to(x.dtype)
    y = torch.matmul(x.float(), w.float())
    if reduce is not None:
        all_reduce_(y, reduce)
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


def dense_w8a8_row_parallel(
    x: torch.Tensor,                      # (..., K/T) float: this rank's columns
    w_i8: torch.Tensor,                   # (K/T, N) int8: this rank's rows
    w_scale: torch.Tensor,                # (N,) f32: the whole columns' scales
    bias: torch.Tensor,                   # (N,) f32, added once
    tp: TensorParallel,
    out_dtype: torch.dtype,
    w_t: Optional[torch.Tensor] = None,   # (N, K/T) int8, for K4
    kernel: bool = True,
) -> torch.Tensor:
    """A row-parallel W8A8 layer over ``tp``'s model group, equal bit for bit
    to ``dense_w8a8`` of the whole layer on one rank:

      1. the rows' local absmax in f32, all-reduced (MAX): the whole rows'
         ``xs = max(amax, 1e-12) / 127``, the value one rank computes;
      2. the int32 product of x quantized with ``xs`` and the local rows of
         the weight: K4's row-parallel mode (``kernel``) or its plain version;
      3. the int32 products summed over the group (exact);
      4. one dequantization, ``((f32(acc) * xs) * w_scale) + bias``.
    """
    xs = activation_scale(all_reduce_max_(row_absmax(x), tp))
    if kernel:
        acc = w8a8_matmul_rowpar(x, xs, w_i8, w_t)
    else:
        acc = w8a8_matmul_rowpar_plain(x, xs, w_i8)
    return dequantize(all_reduce_(acc, tp), xs, w_scale, bias, out_dtype)
