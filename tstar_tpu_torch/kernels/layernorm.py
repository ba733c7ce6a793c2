"""K3: one-pass row LayerNorm (port of ``tstar_tpu/kernels/layernorm.py``
``fused_layernorm``), a Triton kernel.

Math (flax ``use_fast_variance``, not Welford): f32 statistics with
var = E[x^2] - mean^2; scale and bias cast to x's dtype, then to f32;
``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` cast to x's dtype.

What bounds it on the H100: it reads and writes each element once and does a
few flops per element, so it is bound by memory bandwidth (a (8*577, 768)
bf16 tensor moves ~14 MB).  One program per row holds the whole row in
registers as a masked ``BLOCK_D = next_pow2(D)`` block, so each element is
read once and written once, and no state crosses programs.  The TPU's row
gate (<= 1024 rows) does not carry over: on the card every call runs the
kernel.

``triton`` is imported inside the launching function: the CPU tests import
this module on machines without it.
"""

from __future__ import annotations

import torch

_KERNEL = None


def fused_layernorm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """The kernel's math in plain PyTorch (any leading shape)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean
    mul = torch.rsqrt(var + eps) * scale.to(x.dtype).float()
    return ((x32 - mean) * mul + bias.to(x.dtype).float()).to(x.dtype)


def _kernel():
    # ``tl`` becomes a module global: Triton resolves the names a kernel
    # uses through the module's globals, not through closures.
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _ln_kernel(x_ptr, w_ptr, b_ptr, o_ptr, D, eps, BLOCK_D: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK_D)
            mask = cols < D
            x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / D
            var = tl.sum(x * x, axis=0) / D - mean * mean
            w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = (x - mean) * (tl.rsqrt(var + eps) * w) + b
            tl.store(o_ptr + row * D + cols, y.to(o_ptr.dtype.element_ty), mask=mask)

        _KERNEL = (triton, _ln_kernel)
    return _KERNEL


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"layernorm kernel takes a float tensor, got {x.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"scale/bias must be ({d},), got {tuple(scale.shape)}, {tuple(bias.shape)}")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("layernorm params must be on the input's device")
    if not x.is_contiguous():
        raise ValueError("layernorm kernel needs a contiguous input")
    triton, kern = _kernel()
    rows = x.numel() // d
    out = torch.empty_like(x)
    w = scale.to(x.dtype).contiguous()
    b = bias.to(x.dtype).contiguous()
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kern[(rows,)](x, w, b, out, d, float(eps), BLOCK_D=block,
                      num_warps=4 if block <= 1024 else 8)
    fused_layernorm.launches += 1
    return out


def fused_layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis, one pass.  CPU tensor: the plain version.
    CUDA tensor: the K3 Triton kernel, or raise."""
    if x.device.type == "cpu":
        return fused_layernorm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no layernorm kernel for device {x.device}")
    if x.numel() == 0:
        raise ValueError("layernorm kernel got an empty tensor")
    return _launch(x, scale, bias, eps)


fused_layernorm.launches = 0  # kernel launches (not plain-version calls)
