"""Plain float32 Kimi-VL-A3B (Kimi-VL technical report, arXiv 2504.07491;
the published ``config.json`` and ``modeling_kimi_vl.py``), written from the
published architecture with plain ``torch`` operations: no kernel of the
port, no cache, no batching; TF32 off in every product.

  * MoonViT: a stride-14 patch convolution at the frame's own size; the
    learned 64 x 64 position table resampled bicubically (``F.interpolate``,
    align_corners False) to the patch grid; 27 pre-LN layers with a biased
    fused q|k|v, 2D rotary positions as the published ``Rope2DPosEmb`` makes
    them (``torch.polar`` over the interleaved pairs: pair 2i by column,
    2i + 1 by row, frequency 10,000^(-4i/72)), full attention within one
    frame, a tanh-GELU MLP; a final LayerNorm;
  * the 2 x 2 patch merge (row-major blocks of four) and the projector:
    LayerNorm over 1,152, Linear 4,608 -> 4,608, GELU, Linear -> 2,048;
  * the DeepSeek-V3 decoder: RMSNorm; MLA with DeepSeek's rope layout (the
    interleaved pairs gathered as [evens, odds], then rotate-half; theta
    800,000), c_kv normed with eps 1e-6, scores over sqrt(192), causal;
    layer 0 a SwiGLU MLP, the other layers 64 experts chosen by sigmoid
    score plus correction bias, top 6, weighted by score over their sum
    (+1e-20) times 2.446, and the shared experts; a final RMSNorm and an
    untied head.  The 1-D positions run on across the image tokens.

Departures: the attention runs the expanded form only; rotary positions
are applied in f32 (the published decoder turns them in the model's dtype,
and float32 is this file's dtype).  ``follow`` makes the MoE layers use
given expert choices in place of their own (a program's, recorded on its
device) and reports how far each followed expert's biased score lies below
this model's 6th best; ``cast`` puts every product's operands through a
lower precision (a control).

Weights are a dict under the port's checkpoint names
(``models/kimi_vl.flat_weight_shapes``: kernels (in, out), each expert's
gate / up / down on its own), taken to float32 as they are reached.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Mapping, Optional, Tuple

import torch
from torch.nn import functional as F


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _f(w: Mapping, name: str) -> torch.Tensor:
    return w[name].to(torch.float32)


def _mm(a, b, cast: Optional[Callable] = None):
    return a @ b if cast is None else cast(a) @ cast(b)


def _ln(x, w, prefix, eps):
    return F.layer_norm(x, (x.shape[-1],), _f(w, prefix + ".scale"), _f(w, prefix + ".bias"), eps)


def _dense(x, w, prefix, cast=None, bias=True):
    y = _mm(x, _f(w, prefix + ".kernel"), cast)
    return y + _f(w, prefix + ".bias") if bias else y


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


# ---------------------------------------------------------------------------
# MoonViT and the projector
# ---------------------------------------------------------------------------

def rope_2d(grid_h: int, grid_w: int, dim: int, theta: float, device) -> torch.Tensor:
    """The published ``Rope2DPosEmb`` table at a grid: (grid_h * grid_w,
    dim / 2) complex64, row-major patches."""
    flat = torch.arange(grid_h * grid_w, dtype=torch.float32, device=device)
    x_pos, y_pos = flat % grid_w, flat // grid_w
    dims = torch.arange(0, dim, 4, device=device)[:dim // 4].float()
    freqs = 1.0 / (theta ** (dims / dim))
    x_cis = torch.polar(torch.ones(len(flat), len(freqs), device=device), torch.outer(x_pos, freqs))
    y_cis = torch.polar(torch.ones(len(flat), len(freqs), device=device), torch.outer(y_pos, freqs))
    return torch.stack([x_cis, y_cis], dim=-1).reshape(len(flat), -1)


def _apply_rope_2d(x, cis):
    """x (F, S, H, D) f32 turned by cis (S, D / 2) complex."""
    xc = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(xc * cis[:, None]).flatten(-2)


def moonvit(pixels: torch.Tensor, w: Mapping, v: Mapping, cast=None) -> torch.Tensor:
    """(F, H, W, 3) normalised frames -> merged, projected tokens
    (F * H W / 784, text width) f32."""
    p, d, heads, eps = v["patch_size"], v["hidden_size"], v["num_attention_heads"], v["layer_norm_eps"]
    mh, mw = v["merge_kernel_size"]
    f, h, wd, _ = pixels.shape
    gh, gw = h // p, wd // p
    kernel = _f(w, "vision_tower.patch_embed.kernel").permute(3, 2, 0, 1)     # (D, 3, p, p)
    px = pixels.permute(0, 3, 1, 2)
    if cast is not None:
        px, kernel = cast(px), cast(kernel)
    x = F.conv2d(px, kernel, _f(w, "vision_tower.patch_embed.bias"), stride=p)
    x = x.flatten(2).transpose(1, 2)                                          # (F, S, D)
    table = _f(w, "vision_tower.pos_embedding")
    if (gh, gw) != tuple(table.shape[:2]):
        table = F.interpolate(table.permute(2, 0, 1)[None], size=(gh, gw), mode="bicubic",
                              align_corners=False)[0].permute(1, 2, 0)
    x = x + table.reshape(gh * gw, d)
    hd = d // heads
    cis = rope_2d(gh, gw, hd, v["rope_theta"], pixels.device)
    s = gh * gw
    for i in range(v["num_hidden_layers"]):
        lp = f"vision_tower.layers.{i}."
        a = _ln(x, w, lp + "norm0", eps)
        q, k, vv = (t.reshape(f, s, heads, hd) for t in _dense(a, w, lp + "wqkv", cast).split(d, -1))
        q, k = _apply_rope_2d(q, cis), _apply_rope_2d(k, cis)
        q, k, vv = (t.transpose(1, 2) for t in (q, k, vv))
        att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1) @ vv
        x = x + _dense(att.transpose(1, 2).reshape(f, s, d), w, lp + "wo", cast)
        a = _ln(x, w, lp + "norm1", eps)
        a = F.gelu(_dense(a, w, lp + "fc0", cast), approximate="tanh")
        x = x + _dense(a, w, lp + "fc1", cast)
    x = _ln(x, w, "vision_tower.final_layernorm", eps)
    x = (x.reshape(f, gh // mh, mh, gw // mw, mw, d).permute(0, 1, 3, 2, 4, 5)
         .reshape(f, (gh // mh) * (gw // mw), mh * mw, d))
    x = _ln(x, w, "vision_tower.pre_norm", eps).reshape(f, -1, mh * mw * d)
    x = F.gelu(_dense(x, w, "vision_tower.linear_1", cast))
    return _dense(x, w, "vision_tower.linear_2", cast).reshape(-1, w["vision_tower.linear_2.bias"].shape[0])


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------

def _deepseek_rope(x, cos, sin):
    """x (..., S, [H,] 64): the interleaved pairs gathered as [evens, odds]
    (DeepSeek's view / transpose), then rotate-half."""
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _swiglu(x, w, prefix, cast):
    gate = _mm(x, _f(w, prefix + ".gate_proj.kernel"), cast)
    up = _mm(x, _f(w, prefix + ".up_proj.kernel"), cast)
    return _mm(F.silu(gate) * up, _f(w, prefix + ".down_proj.kernel"), cast)


def _moe(x, w, lp, t, cast, follow):
    """-> (output, the experts chosen, the widest gap of a followed choice)."""
    k, scale = t["num_experts_per_tok"], t["routed_scaling_factor"]
    scores = torch.sigmoid(x @ _f(w, lp + "mlp.router.kernel"))
    biased = scores + _f(w, lp + "mlp.e_score_correction_bias")
    own = torch.topk(biased, k, dim=-1)
    ids = own.indices if follow is None else follow
    gap = (own.values[:, -1:] - biased.gather(1, ids)).clamp_min(0).max().item()
    weights = scores.gather(1, ids)
    if t["norm_topk_prob"]:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * scale
    out = torch.zeros_like(x)
    for e in ids.unique().tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        y = _swiglu(x[tok], w, f"{lp}mlp.experts.{e}", cast)
        out.index_add_(0, tok, y * weights[tok, slot][:, None])
    return out + _swiglu(x, w, lp + "mlp.shared_experts", cast), ids, gap


def logits_at(ids: torch.Tensor, media: Optional[torch.Tensor], media_id: int, positions,
              w: Mapping, t: Mapping, cast=None,
              follow: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """The head's logits at ``positions`` (each predicting the token after
    it) for the sequence ``ids`` (S,), its ``media_id`` positions taking the
    rows of ``media`` in order; causal attention, positions 0 .. S - 1.
    ``follow`` (MoE layers, S, K): the experts to use.  -> (logits (P,
    vocab), the experts used (MoE layers, S, K), the widest gap by which a
    used expert's biased score lies below this model's K-th best)."""
    d, nh = t["hidden_size"], t["num_attention_heads"]
    nope, rope_d, vd, r = t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"], \
        t["kv_lora_rank"]
    eps, dev = t["rms_norm_eps"], ids.device
    x = w["embed_tokens.embedding"][ids].to(torch.float32)
    if media is not None:
        slots = (ids == media_id).nonzero()[:, 0]
        x[slots] = media[:len(slots)].to(x.dtype)
    s = ids.shape[0]
    inv = 1.0 / (t["rope_theta"] ** (torch.arange(0, rope_d, 2, dtype=torch.float64, device=dev)
                                     / rope_d))
    ang = torch.arange(s, dtype=torch.float64, device=dev)[:, None] * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos().float(), emb.sin().float()
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))
    used: List[torch.Tensor] = []
    gap = 0.0
    for i in range(t["num_hidden_layers"]):
        lp = f"layers.{i}."
        a = _rms(x, _f(w, lp + "input_layernorm.scale"), eps)
        q = _mm(a, _f(w, lp + "self_attn.q_proj.kernel"), cast).reshape(s, nh, nope + rope_d)
        kv_a = _mm(a, _f(w, lp + "self_attn.kv_a_proj.kernel"), cast)
        c = _rms(kv_a[:, :r], _f(w, lp + "self_attn.kv_a_layernorm.scale"), 1e-6)
        k_pe = _deepseek_rope(kv_a[:, r:], cos, sin)
        kv = _mm(c, _f(w, lp + "self_attn.kv_b_proj.kernel"), cast).reshape(s, nh, nope + vd)
        qf = torch.cat([q[..., :nope], _deepseek_rope(q[..., nope:], cos[:, None], sin[:, None])],
                       dim=-1)
        k = torch.cat([kv[..., :nope], k_pe[:, None].expand(s, nh, rope_d)], dim=-1)
        scores = torch.einsum("qhd,khd->hqk", qf, k) / math.sqrt(nope + rope_d)
        scores = scores.masked_fill(~causal[None], float("-inf"))
        att = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), kv[..., nope:])
        x = x + _mm(att.reshape(s, nh * vd), _f(w, lp + "self_attn.o_proj.kernel"), cast)
        a = _rms(x, _f(w, lp + "post_attention_layernorm.scale"), eps)
        if i < t["first_k_dense_replace"]:
            x = x + _swiglu(a, w, lp + "mlp", cast)
        else:
            j = i - t["first_k_dense_replace"]
            out, chosen, g = _moe(a, w, lp, t, cast, None if follow is None else follow[j])
            used.append(chosen)
            gap = max(gap, g)
            x = x + out
    x = _rms(x[positions], _f(w, "norm.scale"), eps)
    return _mm(x, _f(w, "lm_head.kernel"), cast), torch.stack(used), gap


def forward(ids, pixels, w, cfg: Mapping, cast=None, follow=None, first: int = 0):
    """The logits of positions ``first`` ... of one request: ``moonvit`` on
    ``pixels`` (or none), then ``logits_at``.  ``cfg`` holds
    ``vision_config`` and the text model's keys at its top level."""
    with no_tf32():
        media = None if pixels is None else moonvit(pixels, w, cfg["vision_config"], cast)
        return logits_at(ids, media, cfg["media_placeholder_token_id"],
                         torch.arange(first, ids.shape[0], device=ids.device), w, cfg, cast,
                         follow)
