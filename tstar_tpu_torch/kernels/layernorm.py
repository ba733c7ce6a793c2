"""K3: one-pass row LayerNorm (port of ``tstar_tpu/kernels/layernorm.py``
``fused_layernorm``), a CUDA kernel.

Math (flax ``use_fast_variance``, not Welford): f32 statistics with
var = E[x^2] - mean^2; scale and bias cast to x's dtype, then to f32;
``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` cast to x's dtype.

The kernel is ``csrc/layernorm.cu`` (design and H100 bounds in its header):
one warp per row, bf16, f16 and f32, at every width the reference's kernel
takes (a multiple of 128): the row held in registers up to 2048 values (1024
in f32) in whole 16-byte vectors a lane, else read twice.  The TPU's row
gate (<= 1024 rows) does not carry over: on the card every call runs the
kernel.  The wrapper is the whole host path of a launch, which lies on the
search's critical path: it copies nothing when scale and bias are already
contiguous in x's dtype, and makes one C call.
"""

from __future__ import annotations

import ctypes

import torch

from tstar_tpu_torch.kernels import _build

# dtype -> the C entry point's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_layernorm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """The kernel's math in plain PyTorch (any leading shape)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean
    mul = torch.rsqrt(var + eps) * scale.to(x.dtype).float()
    return ((x32 - mean) * mul + bias.to(x.dtype).float()).to(x.dtype)


def supported_width(d: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes rows of ``d`` values of ``dtype``: the
    reference's rule (``tstar_tpu/kernels/layernorm.py`` sends a D that is
    not a multiple of 128 to XLA), in the dtypes the kernel is built for."""
    return dtype in _DTYPES and d > 0 and d % 128 == 0


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    dtype = x.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"layernorm kernel takes a float tensor, got {dtype}")
    d = x.shape[-1]
    if not supported_width(d, dtype):
        raise ValueError(f"layernorm kernel does not take D={d} in {dtype}")
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"scale/bias must be ({d},), got {tuple(scale.shape)}, {tuple(bias.shape)}")
    dev = x.get_device()
    if scale.get_device() != dev or bias.get_device() != dev:
        raise ValueError("layernorm params must be on the input's device")
    if not x.is_contiguous():
        raise ValueError("layernorm kernel needs a contiguous input")
    # the towers hold scale and bias contiguous in x's dtype: no copy then
    if scale.dtype != dtype or not scale.is_contiguous():
        scale = scale.to(dtype).contiguous()
    if bias.dtype != dtype or not bias.is_contiguous():
        bias = bias.to(dtype).contiguous()
    out = torch.empty_like(x)
    status = _build.call(
        _build.load().tstar_layernorm, dev, x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), x.numel() // d, d, _DTYPES[dtype], ctypes.c_float(eps),
    )
    _build.check(status, "tstar_layernorm")
    fused_layernorm.launches += 1
    return out


def fused_layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis, one pass.  CPU tensor: the plain version.
    CUDA tensor: the K3 kernel, or raise."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return fused_layernorm_plain(x, scale, bias, eps)
        raise ValueError(f"no layernorm kernel for device {x.device}")
    if x.numel() == 0:
        raise ValueError("layernorm kernel got an empty tensor")
    return _launch(x, scale, bias, eps)


fused_layernorm.launches = 0  # kernel launches (not plain-version calls)
