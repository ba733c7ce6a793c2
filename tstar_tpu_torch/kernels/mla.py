"""Kimi-VL's latent attention (MLA) for one decode token, in its absorbed
form, as one CUDA kernel (``csrc/mla_decode.cu``) beside its plain PyTorch
version:

  * ``mla_decode``: from the q|kv_a projection's output ``y`` to the input
    of ``o_proj``: DeepSeek's rope on the 16 query heads' and the key's rope
    parts, the latent norm of c_kv, the new latent slot written into the
    cache at the step's index, q_nope . W_UK, the scores of [q_lat | q_pe]
    against the live slots 0 .. index plus the step's f32 mask, an f32
    softmax, P . c_kv and o_lat . W_UV: three launches a layer (q and the
    new slot; the attention's partials over 128 CTAs; their combination
    and W_UV);
  * ``mla_decode_plain``: the same, rounding where the kernel rounds.

None replaces a Pallas kernel: the reference has no MLA model.  The plain
version rounds the rope (each product in f32, then their sum) and the norm
(its sum of squares in the kernel's order: a run of 8 values in turn, then
halving pairwise) as the kernel does, so both write the same cache slot
bit for bit; q_lat is rounded to the working dtype, the scores and the
softmax stay f32, the probabilities are rounded to the working dtype, and
o_lat and the output's sums stay f32 until the output's rounding.  The
kernel rounds its probabilities before they are normalised (relative to
its slots' running max), which the plain version cannot repeat: on the card
the two agree to bf16 rounding of each head's largest output.

``mla_decode_supported`` says which calls the kernel takes: on the card 1 to
4 bf16 rows at Kimi-VL's widths (16 heads, kv_lora_rank 512, rope 64, nope
128, v 128) against a bf16 cache of at most 16,384 slots; on the CPU every
call (``mla_decode`` runs the plain version there).  The kernel reads slots
0 .. index only: the mask must hide every later slot, as the decode step's
does (they add exact zeros on the plain route).
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from tstar_tpu_torch.kernels import _build
from tstar_tpu_torch.kernels.decode import _bf16, _plain_or_raise

HEADS, NOPE, ROPE, RANK, V_DIM = 16, 128, 64, 512, 128     # the widths the kernel takes
MAX_ROWS = 4            # batch rows it takes
MAX_SLOTS = 16384       # cache slots it takes
ATTEND_CTAS = 128       # the attention kernel's CTAs over all batch rows, at most
TILE = 64               # slots a CTA of it takes in one tile
PART = RANK + 4         # floats of a (CTA, head) partial: o_lat, its max and sum


def rope_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rope on x (..., D): the interleaved pairs gathered as
    [evens, odds], turned as rotate-half halves (``sin`` signed), in f32
    with each product rounded before their sum, rounded back to x's dtype."""
    xf = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1).float()
    swapped = xf.unflatten(-1, (2, -1)).flip(-2).flatten(-2)
    return (xf * cos + swapped * sin).to(x.dtype)


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 rounded once to ``scale``'s dtype, its sum of squares
    in the kernel's order: each run of 8 values in turn, then the runs'
    sums halved pairwise (first half plus second half) down to one."""
    xf = x.float()
    sq = F.pad(xf * xf, (0, -x.shape[-1] % 8)).unflatten(-1, (-1, 8))
    acc = sq[..., 0]
    for j in range(1, 8):
        acc = acc + sq[..., j]
    while acc.shape[-1] > 1:
        acc = F.pad(acc, (0, acc.shape[-1] % 2))
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    r = torch.rsqrt(acc / x.shape[-1] + eps)
    return (xf * r * scale.float()).to(scale.dtype)


def mla_decode_plain(y, cos, sin, norm_scale, eps, cache, index, w_uk, w_uv, attn_bias=None):
    """One token's absorbed latent attention.

    y (B, 1, H nope + r + (H + 1) rope): the q|kv_a projection's output,
    columns [q_nope of every head | c_kv | q_pe of every head | k_pe]; cos /
    sin (B, 1, 1, rope) f32 (``kimi_vl.rope_cos_sin``); ``norm_scale`` the
    latent norm's (r,); cache (B, M, r + rope), whose slot ``index`` (an int
    or a one-value device tensor) takes [normed c_kv | roped k_pe] in place;
    w_uk (H, nope, r), w_uv (H, r, v) (``MLAttention.absorbed``); attn_bias
    additive, (B, 1, 1, M) or None.  -> (B, 1, H v) in y's dtype."""
    b = y.shape[0]
    nh, nope, r = w_uk.shape
    rope = cache.shape[-1] - r
    y = y.reshape(b, -1)
    pe = rope_plain(y[:, nh * nope + r:].view(b, nh + 1, rope), cos.reshape(b, 1, rope),
                    sin.reshape(b, 1, rope))
    c = rms_norm_plain(y[:, nh * nope:nh * nope + r], norm_scale, eps)
    slot = torch.as_tensor(index, device=y.device).view(1)
    cache.index_copy_(1, slot, torch.cat([c, pe[:, nh]], dim=-1)[:, None].to(cache.dtype))
    q_lat = torch.bmm(y[:, :nh * nope].view(b, nh, nope).transpose(0, 1), w_uk).transpose(0, 1)
    qf = torch.cat([q_lat, pe[:, :nh]], dim=-1).float()                        # (B, H, 576)
    kv = cache.float()
    logits = torch.matmul(qf, kv.transpose(1, 2)) * (nope + rope) ** -0.5       # (B, H, M)
    if attn_bias is not None:
        logits = logits + attn_bias.reshape(b, 1, -1).float()
    probs = torch.softmax(logits, dim=-1).to(y.dtype).float()
    o_lat = torch.matmul(probs, kv[..., :r])                                     # (B, H, r)
    out = torch.bmm(o_lat.transpose(0, 1), w_uv.float()).transpose(0, 1)        # (B, H, v)
    return out.reshape(b, 1, -1).to(y.dtype)


def mla_decode_supported(y: torch.Tensor, cache: torch.Tensor, w_uk: torch.Tensor,
                         w_uv: torch.Tensor) -> bool:
    """Whether ``mla_decode`` takes the step: one token a row; on the CPU any
    widths (the plain version); on the card 1 .. 4 bf16 rows at 16 heads,
    kv_lora_rank 512, rope 64, nope 128 and v 128 against a bf16 cache of at
    most 16,384 slots."""
    if y.dim() != 3 or y.shape[1] != 1:
        return False
    if not y.is_cuda:
        return True
    return (1 <= y.shape[0] <= MAX_ROWS and y.dtype == torch.bfloat16
            and cache.dtype == torch.bfloat16 and cache.dim() == 3
            and cache.shape[0] == y.shape[0] and cache.shape[1] <= MAX_SLOTS
            and cache.shape[-1] == RANK + ROPE and tuple(w_uk.shape) == (HEADS, NOPE, RANK)
            and tuple(w_uv.shape) == (HEADS, RANK, V_DIM)
            and y.shape[-1] == HEADS * (NOPE + ROPE) + RANK + ROPE)


def attend_ctas(rows: int, slots: int) -> int:
    """The attention kernel's CTAs a batch row for a cache of ``slots``:
    about one tile of slots each when the cache is full, at most
    ``ATTEND_CTAS`` over all rows."""
    return max(1, min(ATTEND_CTAS // rows, -(-slots // TILE)))


def mla_decode(y, cos, sin, norm_scale, eps, cache, index, w_uk, w_uv, attn_bias=None):
    """``mla_decode_plain`` on a CPU tensor; on a CUDA tensor the kernels'
    three launches (``mla_decode_supported``; an f32 (B, 1, 1, M) mask or
    none), or raise."""
    if _plain_or_raise(y, "mla_decode"):
        return mla_decode_plain(y, cos, sin, norm_scale, eps, cache, index, w_uk, w_uv, attn_bias)
    if not mla_decode_supported(y, cache, w_uk, w_uv):
        raise ValueError(f"mla_decode kernel does not take y {tuple(y.shape)} ({y.dtype}), "
                         f"cache {tuple(cache.shape)} ({cache.dtype}), W_UK {tuple(w_uk.shape)}, "
                         f"W_UV {tuple(w_uv.shape)}")
    b, m = y.shape[0], cache.shape[1]
    dev = y.get_device()
    ptrs = [_bf16("y", y, dev)]
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != b * ROPE:
            raise ValueError(f"{name} must be f32 (B, 1, 1, {ROPE}), contiguous")
        ptrs.append(t.data_ptr())
    ptrs.append(_bf16("norm_scale", norm_scale, dev, (RANK,)))
    if attn_bias is None:
        ptrs.append(None)
    else:
        if (attn_bias.dtype != torch.float32 or not attn_bias.is_contiguous()
                or attn_bias.numel() != b * m):
            raise ValueError(f"attn_bias must be f32 (B, 1, 1, {m}), contiguous")
        ptrs.append(attn_bias.data_ptr())
    ptrs.append(_bf16("cache", cache, dev))
    if not torch.is_tensor(index):
        index = torch.tensor(index, dtype=torch.int64, device=y.device)
    if index.dtype != torch.int64 or index.numel() != 1 or index.get_device() != dev:
        raise ValueError("index must be one int64 value on the card")
    ptrs += [index.data_ptr(), _bf16("w_uk", w_uk, dev), _bf16("w_uv", w_uv, dev)]
    q = torch.empty(b, HEADS, RANK + ROPE, dtype=y.dtype, device=y.device)
    ctas = attend_ctas(b, m)
    part = torch.empty(b * ctas, HEADS, PART, dtype=torch.float32, device=y.device)
    out = torch.empty(b, 1, HEADS * V_DIM, dtype=y.dtype, device=y.device)
    status = _build.call(_build.load().tstar_mla_decode, dev, *ptrs, q.data_ptr(), part.data_ptr(),
                         out.data_ptr(), b, m, ctas, ctypes.c_float(eps),
                         ctypes.c_float((NOPE + ROPE) ** -0.5))
    _build.check(status, "tstar_mla_decode")
    mla_decode.launches += 1
    return out


mla_decode.launches = 0         # calls that launched the kernels (three launches each)
