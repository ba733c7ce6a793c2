"""Attention of the encoder towers (port of ``tstar_tpu/kernels/attention.py``).

K1 ``fused_mha_from_qkv``: self-attention straight from the fused q|k|v
projection.  ``fused_mha_from_qkv_plain`` is the same math in plain PyTorch,
with the reference's opt-in ``TSTAR_MHA_P16`` (bf16: the row sum taken from
the rounded probabilities), read at call time.  The TPU's batch gate (B >= 8)
does not carry over: ``use_fused_mha`` keeps K1 on for every unbiased call
unless ``TSTAR_FUSED_MHA=0``.

K8 ``flash_mha``: (B, S, H, D) flash attention, the port of the reference's
opt-in route through JAX's TPU ``flash_attention``
(``TSTAR_FLASH_ATTENTION``, taken where K1 is off).  ``flash_mha_plain``
mirrors the reference kernel's rounding points.

The CUDA kernels: in bf16 both are ``csrc/attn_sm90.cu``, one wgmma + TMA
kernel with two exact passes that rounds where each reference does (design
and H100 bounds in its header); in f32 ``csrc/mha.cu`` and
``csrc/flash_attn.cu`` on the CUDA cores.

``bf16_probs_attention`` (``TSTAR_ATTN_PROBS_BF16``) is an einsum in the
reference and plain PyTorch here.  Each wrapper runs its plain version for a
CPU tensor, and for a CUDA tensor launches its kernel or raises.  The gates
are read at call time; the reference's TPU-backend checks become "the
tensor's device chooses kernel or plain version".
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from tstar_tpu_torch.kernels import _build

LOG2E = 1.4426950408889634
HEAD_DIM = 64  # the CUDA kernel's head width


def use_mha_p16(dtype: torch.dtype) -> bool:
    """``TSTAR_MHA_P16=1`` (opt-in, bf16 only): K1's row sum is taken from
    the bf16-rounded probabilities the AV product consumes."""
    return os.environ.get("TSTAR_MHA_P16", "0") == "1" and dtype == torch.bfloat16


def fused_mha_from_qkv_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, 3D) fused projection -> (B, S, D) head-major attention output.

    f32 logits scaled by scale*log2(e); exact softmax in the exp2 domain;
    unnormalized probs rounded to the input type for an f32-accumulated AV
    product; the divide by the f32 row sum after AV.  The row sum is of the
    unrounded probs, or under ``use_mha_p16`` of the rounded ones.
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
    if use_mha_p16(qkv.dtype):
        p = p.to(qkv.dtype).float()
        denom = p.sum(dim=-1, keepdim=True)
    else:
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
        lib = _build.load()
        fn = lib.tstar_mha_p16_bf16 if use_mha_p16(qkv.dtype) else lib.tstar_mha_bf16
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


def use_fused_mha() -> bool:
    """K1 for every unbiased self-attention unless ``TSTAR_FUSED_MHA=0``
    (the reference's "force" and batch gate do not carry over)."""
    return os.environ.get("TSTAR_FUSED_MHA", "1") != "0"


def use_flash_attention(q: torch.Tensor, attn_bias) -> bool:
    """Opt-in gate (``TSTAR_FLASH_ATTENTION`` non-empty) for ``flash_mha``:
    no additive bias, S >= 256 and a head width divisible by 64, as the
    reference; its TPU-backend check is dropped (a CPU tensor takes the plain
    version).  The kernel itself takes head width 64 and raises on another."""
    if not os.environ.get("TSTAR_FLASH_ATTENTION") or attn_bias is not None:
        return False
    _, s, _, d = q.shape
    return s >= 256 and d % 64 == 0


def use_bf16_probs(q: torch.Tensor, attn_bias) -> bool:
    """Opt-in gate (``TSTAR_ATTN_PROBS_BF16`` non-empty) for
    ``bf16_probs_attention``: bf16 queries, no additive bias (the
    reference's TPU-backend check is dropped)."""
    if not os.environ.get("TSTAR_ATTN_PROBS_BF16"):
        return False
    return attn_bias is None and q.dtype == torch.bfloat16


def bf16_probs_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) attention whose probabilities are stored in bf16: f32
    logits scaled by 1/sqrt(D), f32 softmax, probs cast to bf16 for the AV
    product (a bf16 matmul, output bf16)."""
    d = q.shape[-1]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * (1.0 / (d ** 0.5))
    probs = torch.softmax(logits, dim=-1).to(torch.bfloat16)
    return torch.matmul(probs, vh.to(torch.bfloat16)).permute(0, 2, 1, 3)


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) self-attention in the reference kernel's order: f32
    logits times sm_scale = 1/sqrt(D); m = row max; p = exp(s - m); l = row
    sum; p / l cast to v's dtype; PV summed in f32; cast to q's dtype.  (With
    S padded to at most 1024 the reference sees one key block, the exact
    softmax; its pads are masked, so leaving them out changes nothing.)"""
    d = q.shape[-1]
    qh, kh, vh = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / (d ** 0.5))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), vh)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash kernel takes head width {HEAD_DIM}, got {d}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16:
        fn, vec = _build.load().tstar_flash_bf16, 8
    elif q.dtype == torch.float32:
        fn, vec = _build.load().tstar_flash_f32, 4
    else:
        raise TypeError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on {q.device}, {k.device}, {v.device}")
    strides = []
    for t in (q, k, v):
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"flash kernel reads 16-byte rows: needs a unit last stride, other strides "
                f"divisible by {vec} and a 16-byte aligned base, got strides {t.stride()}"
            )
        strides += list(t.stride()[:3])
    out = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d, *strides,
            ctypes.c_float(1.0 / math.sqrt(d)), stream,
        )
    _build.check(status, "tstar_flash")
    flash_mha.launches += 1
    return out


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) self-attention, (B, S, H, D) out.

    CPU tensor: the plain version.  CUDA tensor: the K8 kernel, or raise.
    q, k, v may be strided views (the fused projection's column slices).
    """
    if q.ndim != 4:
        raise ValueError(f"expected (B, S, H, D), got shape {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    return _flash_launch(q, k, v)


flash_mha.launches = 0  # kernel launches (not plain-version calls)
