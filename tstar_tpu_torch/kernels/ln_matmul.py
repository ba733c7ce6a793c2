"""K5: a LayerNorm folded into the matmul it feeds (port of
``tstar_tpu/kernels/ln_matmul.py`` ``ln_matmul``).

    out = LayerNorm(x; scale, bias) @ w + b

Math, as the reference kernel: f32 row statistics with var = E[x^2] - mean^2
(flax ``use_fast_variance``, the formula of K3); LayerNorm params cast
f32 -> compute dtype -> f32; the normalized row rounded to the compute dtype;
the product accumulated in f32 and rounded to the compute dtype; then ``+ b``
in the compute dtype, which rounds a second time.  The CUDA kernel is
``csrc/ln_matmul.cu`` (bf16 only, as the reference's gate; wgmma fed by TMA,
each row normalized once into the shared memory of the CTAs of a cluster;
design and H100 bounds in its header).  ``ln_matmul_plain`` is the same math in plain
PyTorch.  The wrapper runs the plain version for a CPU tensor, and for a
CUDA tensor launches the kernel or raises.

The reference is opt-in through ``TSTAR_LN_MATMUL``, read at call time by
``use_ln_matmul``: unset or "0" is off, "1" fuses from 4096 rows (8 images
of 577 tokens), "force" fuses every call that fits the kernel.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tstar_tpu_torch.kernels import _build

_MIN_ROWS = 4096   # the reference's row gate under TSTAR_LN_MATMUL=1


def _ln_params(scale, bias, dtype):
    """The reference's double cast: f32 params -> compute dtype -> f32."""
    return scale.to(dtype).float(), bias.to(dtype).float()


def normalize_rows(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """The kernel's prologue: the LayerNorm'd rows, rounded to x's dtype."""
    scale32, bias32 = _ln_params(scale, bias, x.dtype)
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean
    mul = torch.rsqrt(var + eps) * scale32
    return ((x32 - mean) * mul + bias32).to(x.dtype)


def ln_matmul_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, w: torch.Tensor,
    b: torch.Tensor, eps: float,
) -> torch.Tensor:
    """(..., D) x -> (..., N); the kernel's math in plain PyTorch."""
    dtype = x.dtype
    h = normalize_rows(x, scale, bias, eps)
    out = torch.matmul(h.float(), w.to(dtype).float()).to(dtype)
    return out + b.to(dtype)


def bf16_error_bound(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, w: torch.Tensor,
    b: torch.Tensor, eps: float, ref: torch.Tensor,
) -> torch.Tensor:
    """Elementwise bound on |kernel - plain version| in bf16, for comparisons.

    The kernel sums the row statistics and the product in another order than
    the plain version, so (1) a normalized value h can round to its
    neighbouring bf16 value, moving that row's product by one ulp of h
    times a weight: allowed twice per row, 2 ulp(max|h|) max|w|; (2) the
    product can round to a neighbouring bf16 value and the bias add rounds
    once more: 2^-6 (|ref| + |b|), two ulps of the values rounded.
    """
    h = normalize_rows(x, scale, bias, eps).float()
    hmax = h.abs().max()
    ulp_h = torch.exp2(torch.floor(torch.log2(hmax)) - 7)
    flips = 2 * ulp_h * w.float().abs().max()
    return flips + 2.0 ** -6 * (ref.float().abs() + b.float().abs())


def use_ln_matmul(x: torch.Tensor, n_out: int) -> bool:
    """Whether the pre-norm LayerNorm feeding an (D, n_out) projection folds
    into it (``TSTAR_LN_MATMUL``, read at each call).  The reference's
    requirements that carry over: a 3-d bf16 input and widths that are
    multiples of 128; its TPU and mesh checks do not, and its VMEM check
    becomes the kernel's shared-memory one (``kernel_takes``)."""
    env = os.environ.get("TSTAR_LN_MATMUL", "0")
    if env == "0":
        return False
    if x.ndim != 3 or x.dtype != torch.bfloat16:
        return False
    if not kernel_takes(x.shape[-1], n_out):
        return False
    return env == "force" or x.shape[0] * x.shape[1] >= _MIN_ROWS


MAX_WIDTH = 1536   # csrc/ln_matmul.cu: a 64-row slab of D and two W stages fit 227 KB


def kernel_takes(d: int, n: int) -> bool:
    """Whether the kernel takes a (D, N) projection: D and N multiples of 128
    (the half-warps' 128-value runs, the 128-column N tiles), D <= 1536."""
    return d % 128 == 0 and n % 128 == 0 and 0 < d <= MAX_WIDTH and n > 0


def _launch(x, scale, bias, w, b, eps):
    d = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"ln_matmul kernel takes bf16, got {x.dtype}")
    if w.ndim != 2 or w.shape[0] != d:
        raise ValueError(f"w must be ({d}, N), got {tuple(w.shape)}")
    n = w.shape[1]
    if not kernel_takes(d, n):
        raise ValueError(
            f"ln_matmul kernel needs D and N multiples of 128, D <= {MAX_WIDTH}: got D={d}, N={n}"
        )
    if scale.shape != (d,) or bias.shape != (d,) or b.shape != (n,):
        raise ValueError("ln_matmul params: scale/bias (D,), b (N,)")
    dev = x.get_device()
    for t in (scale, bias, w, b):
        if t.get_device() != dev:
            raise ValueError(f"ln_matmul operands on {t.device} and {x.device}")
    if not x.is_contiguous():
        raise ValueError("ln_matmul kernel needs a contiguous input")
    rows = x.numel() // d
    if rows == 0:
        raise ValueError("ln_matmul kernel got an empty input")
    # The kernel takes every parameter in bf16 (the LayerNorm's as the
    # reference casts them) and widens scale and bias to f32 itself; the
    # towers hold all four contiguous in bf16, so nothing is copied per call.
    sb, bsb, wb, bb = (
        t if t.dtype == x.dtype and t.is_contiguous() else t.to(x.dtype).contiguous()
        for t in (scale, bias, w, b)
    )
    if any(t.data_ptr() % 16 for t in (x, sb, bsb, wb, bb)):
        raise ValueError("ln_matmul kernel needs 16-byte aligned operands")
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    status = _build.call(
        _build.load().tstar_ln_matmul_bf16, dev, x.data_ptr(), sb.data_ptr(), bsb.data_ptr(),
        wb.data_ptr(), bb.data_ptr(), out.data_ptr(), rows, d, n, ctypes.c_float(eps),
    )
    _build.check(status, "tstar_ln_matmul")
    ln_matmul.launches += 1
    return out


def ln_matmul(
    x: torch.Tensor,       # (..., D) compute dtype
    scale: torch.Tensor,   # (D,) LayerNorm scale
    bias: torch.Tensor,    # (D,) LayerNorm bias
    w: torch.Tensor,       # (D, N)
    b: torch.Tensor,       # (N,)
    eps: float,
) -> torch.Tensor:
    """``LayerNorm(x) @ w + b`` in one pass.  CPU tensor: the plain version.
    CUDA tensor: the K5 kernel (bf16), or raise."""
    if x.device.type == "cpu":
        return ln_matmul_plain(x, scale, bias, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no ln_matmul kernel for device {x.device}")
    return _launch(x, scale, bias, w, b, eps)


ln_matmul.launches = 0  # kernel launches (not plain-version calls)
