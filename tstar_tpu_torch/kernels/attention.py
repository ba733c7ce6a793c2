"""K1: self-attention straight from the fused q|k|v projection (port of
``tstar_tpu/kernels/attention.py`` ``fused_mha_from_qkv``).

The CUDA kernel is ``csrc/mha.cu`` (design and H100 bounds in its header);
``fused_mha_from_qkv_plain`` is the same math in plain PyTorch.  The wrapper
runs the plain version for a CPU tensor, and for a CUDA tensor launches the
kernel or raises.  The TPU's batch gate (B >= 8) does not carry over: on the
card the kernel runs for every call that fits its contract.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tstar_tpu_torch.kernels import _build

LOG2E = 1.4426950408889634
HEAD_DIM = 64  # the CUDA kernel's head width


def fused_mha_from_qkv_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, 3D) fused projection -> (B, S, D) head-major attention output.

    f32 logits scaled by scale*log2(e); exact softmax in the exp2 domain;
    unnormalized probs rounded to the input type for an f32-accumulated AV
    product; the divide by the f32 row sum after AV.
    """
    b, s, three_d = qkv.shape
    d = three_d // 3
    dh = d // num_heads
    scale = 1.0 / math.sqrt(dh)

    def heads(t):  # (B, S, D) -> (B, H, S, Dh) f32
        return t.reshape(b, s, num_heads, dh).permute(0, 2, 1, 3).float()

    q, k, v = (heads(t) for t in qkv.split(d, dim=-1))
    logits = torch.matmul(q, k.transpose(-1, -2)) * (scale * LOG2E)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = p.to(qkv.dtype).float()
    out = torch.matmul(p, v) / denom
    return out.permute(0, 2, 1, 3).reshape(b, s, d).to(qkv.dtype)


def _launch(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, three_d = qkv.shape
    d = three_d // 3
    if three_d % 3 or d % num_heads or d // num_heads != HEAD_DIM:
        raise ValueError(
            f"mha kernel takes head width {HEAD_DIM}: got D={d}, heads={num_heads}"
        )
    if qkv.dtype == torch.bfloat16:
        fn = _build.load().tstar_mha_bf16
    elif qkv.dtype == torch.float32:
        fn = _build.load().tstar_mha_f32
    else:
        raise TypeError(f"mha kernel takes bf16 or f32, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("mha kernel needs a contiguous (B, S, 3D) input")
    out = torch.empty(b, s, d, dtype=qkv.dtype, device=qkv.device)
    scale_log2e = (1.0 / math.sqrt(HEAD_DIM)) * LOG2E
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            qkv.data_ptr(), out.data_ptr(), b, s, d, num_heads,
            ctypes.c_float(scale_log2e), stream,
        )
    _build.check(status, "tstar_mha")
    fused_mha_from_qkv.launches += 1
    return out


def fused_mha_from_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention from the fused (B, S, 3D) projection; (B, S, D) out.

    CPU tensor: the plain version.  CUDA tensor: the K1 kernel, or raise.
    """
    if qkv.ndim != 3:
        raise ValueError(f"expected (B, S, 3D), got shape {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return fused_mha_from_qkv_plain(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no mha kernel for device {qkv.device}")
    return _launch(qkv, num_heads)


fused_mha_from_qkv.launches = 0  # kernel launches (not plain-version calls)
