"""The Qwen2 decoder layer's work between its matrix products, as three CUDA
kernels for the single-token decode step (``csrc/decode_layer.cu``), each
beside its plain PyTorch version:

  * ``add_rms_norm``: the residual add and RMSNorm of a block's input;
  * ``decode_attention``: the q/k/v biases, mRoPE, the cache write and
    grouped-query attention over the cache, from the three projections;
  * ``silu_mul``: SwiGLU's ``silu(gate) * up``.

None replaces a Pallas kernel: the reference runs the decoder as XLA code.
The plain versions are the port's arithmetic of ``Qwen2DecoderLayer`` (the
reference's rounding points, ``models/qwen2vl.py``), so the layer runs them
wherever it takes the plain route: prefill (S > 1), f32 models, the CPU.
``decode_attention_plain`` and ``add_rms_norm_plain`` take any S.  The
layer takes the kernels when ``fused_decode_supported`` holds (one token
against a bf16 cache on the card, head_dim 128, whole kv groups of at most
8 heads); Kimi-VL's decoder takes ``add_rms_norm`` and ``silu_mul`` when
``norm_mlp_supported`` holds (the widths those two take).  A wrapper given
a CPU tensor runs the plain version, and on a CUDA tensor launches its
kernel or raises.  Each wrapper counts its launches in ``launches``.

The kernels round where the plain versions round; only their sums run in
another order, so on the card they agree to one bf16 ulp where a sum's last
f32 bit flips a rounding.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from tstar_tpu_torch.kernels import _build

HEAD_DIM = 128          # the attention kernel's head width
MAX_GROUP = 8           # query heads a kv head it takes
MAX_SLOTS = 16384       # cache slots it takes
MAX_WIDTH = 8192        # the norm's widest row (a multiple of 256)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q/k: (..., S, H, D); cos/sin broadcastable to (..., S, 1, D).  f32."""
    qf, kf = q.float(), k.float()
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def softmax_f32(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1).to(dtype)


def add_rms_norm_plain(x: torch.Tensor, delta: Optional[torch.Tensor], scale: torch.Tensor,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (residual, normed): ``x + delta`` (``x`` when no delta) and its
    RMSNorm in f32, rounded once to ``scale``'s dtype."""
    if delta is not None:
        x = x + delta
    xf = x.float()
    norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return x, (norm * scale.float()).to(scale.dtype)


def decode_attention_plain(q, k, v, q_bias, k_bias, v_bias, cos, sin, attn_bias,
                           cache=None, cache_index=None, num_heads=1, num_kv_heads=1):
    """Grouped-query attention of S tokens from their projections.

    q (B, S, H*hd), k / v (B, S, KV*hd) before their biases (each added in
    the projections' dtype, or None); cos / sin (B, S, 1, hd) f32; attn_bias
    additive, broadcastable to (B, 1, S, S_kv).  With a ``cache`` (K, V),
    each (B, max_len, KV, hd), this step's K / V are written into it in
    place at ``cache_index`` (an int or a 0-d device tensor) and attention
    reads every cache slot.  -> (B, S, H*hd) in q's dtype."""
    b, s = q.shape[:2]
    nh, nkv = num_heads, num_kv_heads
    hd = q.shape[-1] // nh
    dtype = q.dtype
    q, k, v = (t if bias is None else t + bias for t, bias in ((q, q_bias), (k, k_bias),
                                                               (v, v_bias)))
    q, k = apply_rope(q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd), cos, sin)
    v = v.reshape(b, s, nkv, hd)
    if cache is not None:
        k_all, v_all = cache
        slots = cache_index + torch.arange(s, device=q.device)
        k_all.index_copy_(1, slots, k.to(k_all.dtype))
        v_all.index_copy_(1, slots, v.to(v_all.dtype))
    else:
        k_all, v_all = k, v
    groups = nh // nkv
    # (B, KV, G*S, hd) @ (B, KV, hd, M): heads kv*G + g share K/V head kv
    qg = (q * hd ** -0.5).reshape(b, s, nkv, groups, hd).permute(0, 2, 3, 1, 4)
    kt = k_all.to(dtype).permute(0, 2, 3, 1)
    logits = torch.matmul(qg.reshape(b, nkv, groups * s, hd), kt)
    logits = logits.reshape(b, nkv, groups, s, -1)
    if attn_bias is not None:
        logits = logits + attn_bias[:, :, None].to(logits.dtype)
    probs = softmax_f32(logits, dtype).reshape(b, nkv, groups * s, -1)
    vv = v_all.permute(0, 2, 1, 3)
    ctype = torch.promote_types(probs.dtype, vv.dtype)
    out = torch.matmul(probs.to(ctype), vv.to(ctype)).reshape(b, nkv, groups, s, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, nh * hd).to(dtype)


def silu_mul_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# Shapes the kernels take
# ---------------------------------------------------------------------------

def norm_mlp_supported(x: torch.Tensor, intermediate: int) -> bool:
    """Whether a decode step over ``x`` (B, S, D) takes ``add_rms_norm`` and
    ``silu_mul``: one bf16 token on the card, D a multiple of 256 up to
    8192 and an MLP width of whole 16-byte vectors."""
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 3 or x.shape[1] != 1:
        return False
    d = x.shape[-1]
    return d % 256 == 0 and d <= MAX_WIDTH and intermediate % 8 == 0


def fused_decode_supported(x: torch.Tensor, cache, num_heads: int, num_kv_heads: int,
                           head_dim: int, intermediate: int) -> bool:
    """Whether a Qwen2 decoder layer's step over ``x`` (B, S, D) and its KV
    ``cache`` runs on the three kernels: ``norm_mlp_supported``, against a
    bf16 cache of at most ``MAX_SLOTS`` slots, head_dim 128, whole kv groups
    of 1 .. 8 query heads."""
    if not norm_mlp_supported(x, intermediate):
        return False
    if cache is None or cache[0].dtype != torch.bfloat16 or cache[0].shape[1] > MAX_SLOTS:
        return False
    return (head_dim == HEAD_DIM and num_kv_heads > 0 and num_heads % num_kv_heads == 0
            and 1 <= num_heads // num_kv_heads <= MAX_GROUP)


def _plain_or_raise(t: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (run the plain version); False for a CUDA one."""
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"no {what} kernel for device {t.device}")


def _bf16(name: str, t: torch.Tensor, dev: int, shape=None) -> int:
    """``t``'s pointer, after checking that the kernel takes it as it is."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bf16, got {t.dtype}")
    if t.get_device() != dev:
        raise ValueError(f"{name} is on another device")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    return t.data_ptr()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor], scale: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``add_rms_norm_plain`` on a CPU tensor; on a CUDA tensor one launch
    (bf16 rows of D, a multiple of 256 up to 8192), or raise."""
    if _plain_or_raise(x, "add_rms_norm"):
        return add_rms_norm_plain(x, delta, scale, eps)
    d, dev = x.shape[-1], x.get_device()
    if d % 256 or not 256 <= d <= MAX_WIDTH:
        raise ValueError(f"add_rms_norm kernel does not take rows of {d}")
    if scale.dtype != torch.bfloat16:
        raise TypeError(f"add_rms_norm kernel takes a bf16 scale, got {scale.dtype}")
    out = torch.empty_like(x)
    res = x if delta is None else torch.empty_like(x)
    status = _build.call(
        _build.load().tstar_add_rms_norm, dev, _bf16("x", x, dev),
        None if delta is None else _bf16("delta", delta, dev, x.shape),
        _bf16("scale", scale, dev, (d,)), res.data_ptr(), out.data_ptr(), x.numel() // d, d,
        ctypes.c_float(eps))
    _build.check(status, "tstar_add_rms_norm")
    add_rms_norm.launches += 1
    return res, out


def decode_attention(q, k, v, q_bias, k_bias, v_bias, cos, sin, attn_bias, cache, cache_index,
                     num_heads: int, num_kv_heads: int) -> torch.Tensor:
    """``decode_attention_plain`` on a CPU tensor; on a CUDA tensor one
    launch for one token (S = 1) against a bf16 cache, or raise.  The
    kernel reads slots 0 .. ``cache_index`` only: ``attn_bias`` must mask
    every later slot (the decode step's does), as they add exact zeros on
    the plain route."""
    if _plain_or_raise(q, "decode_attention"):
        return decode_attention_plain(q, k, v, q_bias, k_bias, v_bias, cos, sin, attn_bias,
                                      cache, cache_index, num_heads, num_kv_heads)
    if cache is None:
        raise ValueError("decode_attention kernel needs a KV cache")
    k_all, v_all = cache
    b, m = k_all.shape[:2]
    nh, nkv, dev = num_heads, num_kv_heads, q.get_device()
    if nkv < 1 or nh % nkv or not 1 <= nh // nkv <= MAX_GROUP:
        raise ValueError(f"decode_attention kernel does not take {nh} heads over {nkv} kv heads")
    if m > MAX_SLOTS:
        raise ValueError(f"decode_attention kernel takes at most {MAX_SLOTS} slots, got {m}")
    cache_shape = (b, m, nkv, HEAD_DIM)
    ptrs = [_bf16("q", q, dev, (b, 1, nh * HEAD_DIM)), _bf16("k", k, dev, (b, 1, nkv * HEAD_DIM)),
            _bf16("v", v, dev, (b, 1, nkv * HEAD_DIM))]
    for name, bias, n in (("q_bias", q_bias, nh), ("k_bias", k_bias, nkv), ("v_bias", v_bias, nkv)):
        ptrs.append(None if bias is None else _bf16(name, bias, dev, (n * HEAD_DIM,)))
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != b * HEAD_DIM:
            raise ValueError(f"{name} must be f32 (B, 1, 1, {HEAD_DIM}), contiguous")
        ptrs.append(t.data_ptr())
    if attn_bias is None:
        ptrs.append(None)
    else:
        if (attn_bias.dtype != torch.float32 or not attn_bias.is_contiguous()
                or attn_bias.numel() != b * m):
            raise ValueError(f"attn_bias must be f32 (B, 1, 1, {m}), contiguous")
        ptrs.append(attn_bias.data_ptr())
    ptrs += [_bf16("k cache", k_all, dev, cache_shape), _bf16("v cache", v_all, dev, cache_shape)]
    if not torch.is_tensor(cache_index):
        cache_index = torch.tensor(cache_index, dtype=torch.int64, device=q.device)
    if cache_index.dtype != torch.int64 or cache_index.numel() != 1:
        raise ValueError("cache_index must be one int64 value")
    out = torch.empty_like(q)
    status = _build.call(
        _build.load().tstar_decode_attention, dev, *ptrs, cache_index.data_ptr(), out.data_ptr(),
        b, m, nh, nkv, ctypes.c_float(HEAD_DIM ** -0.5))
    _build.check(status, "tstar_decode_attention")
    decode_attention.launches += 1
    return out


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu_mul_plain`` on a CPU tensor; on a CUDA tensor one launch (bf16,
    whole 16-byte vectors), or raise."""
    if _plain_or_raise(gate, "silu_mul"):
        return silu_mul_plain(gate, up)
    dev = gate.get_device()
    if gate.numel() % 8:
        raise ValueError(f"silu_mul kernel takes whole vectors of 8, got {gate.numel()} values")
    out = torch.empty_like(gate)
    status = _build.call(_build.load().tstar_silu_mul, dev, _bf16("gate", gate, dev),
                         _bf16("up", up, dev, gate.shape), out.data_ptr(), gate.numel())
    _build.check(status, "tstar_silu_mul")
    silu_mul.launches += 1
    return out


add_rms_norm.launches = 0       # kernel launches (not plain-version calls)
decode_attention.launches = 0
silu_mul.launches = 0
