"""Plain float32 LLaVA-OneVision (Li et al. 2024, "LLaVA-OneVision: Easy
Visual Task Transfer"; Hugging Face ``LlavaOnevisionForConditionalGeneration``)
on its video path, written from the published architecture:

  * SigLIP so400m/14 at 384 px (Zhai et al. 2023): a stride-14 patch
    convolution, learned position embeddings, pre-LN layers with
    tanh-approximated GELU, the last layer's hidden states (no post-LN);
  * a two-layer GELU projector into the language model's width;
  * per frame, 2 x 2 bilinear pooling of the 27 x 27 token grid to 14 x 14
    (half-pixel samples, no antialiasing), the frames in order, then one
    ``image_newline`` vector;
  * the Qwen2 decoder (Qwen2 technical report, 2024): RMSNorm, grouped-query
    attention with biased q / k / v and rotary positions (theta 1e6), a
    SwiGLU MLP, a final RMSNorm and an untied output head.

Weights are a dict under the names of the benchmark's weight list.  It runs
layer by layer, each layer's weights taken to float32 as it is reached, so
that a 7B model's reference fits beside its bf16 weights.  Plain ``torch``
only; it imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
from torch.nn import functional as F


def _f(w: Mapping, name: str, device=None) -> torch.Tensor:
    return w[name].to(device=device, dtype=torch.float32)


def _mm(a, b, cast=None):
    return a @ b if cast is None else cast(a) @ cast(b)


def siglip(pixels: torch.Tensor, w: Mapping, cfg: Mapping, cast=None) -> torch.Tensor:
    """(F, S, S, 3) normalised frames -> the last layer's states (F, P, D)."""
    v = cfg["vision_config"]
    p, d, heads, eps = v["patch_size"], v["hidden_size"], v["num_attention_heads"], \
        v["layer_norm_eps"]
    pre = "vision_tower."
    kernel = _f(w, pre + "patch_embedding.kernel").permute(3, 2, 0, 1)      # (D, 3, p, p)
    px = pixels.permute(0, 3, 1, 2)
    if cast is not None:
        px, kernel = cast(px), cast(kernel)
    x = F.conv2d(px, kernel, _f(w, pre + "patch_embedding.bias"), stride=p)
    x = x.flatten(2).transpose(1, 2) + _f(w, pre + "position_embedding")
    n, s, _ = x.shape
    hd = d // heads
    for i in range(v["num_hidden_layers"]):
        lp = f"{pre}layers.{i}."
        h = F.layer_norm(x, (d,), _f(w, lp + "layer_norm1.scale"), _f(w, lp + "layer_norm1.bias"),
                         eps)
        qkv = _mm(h, _f(w, lp + "self_attn.qkv_kernel"), cast) + _f(w, lp + "self_attn.qkv_bias")
        q, k, vv = (t.reshape(n, s, heads, hd).transpose(1, 2) for t in qkv.split(d, dim=-1))
        att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1) @ vv
        att = att.transpose(1, 2).reshape(n, s, d)
        x = x + _mm(att, _f(w, lp + "self_attn.out_proj.kernel"), cast) \
            + _f(w, lp + "self_attn.out_proj.bias")
        h = F.layer_norm(x, (d,), _f(w, lp + "layer_norm2.scale"), _f(w, lp + "layer_norm2.bias"),
                         eps)
        h = F.gelu(_mm(h, _f(w, lp + "mlp.fc1.kernel"), cast) + _f(w, lp + "mlp.fc1.bias"),
                   approximate="tanh")
        x = x + _mm(h, _f(w, lp + "mlp.fc2.kernel"), cast) + _f(w, lp + "mlp.fc2.bias")
    return x


def video_embeddings(pixels: torch.Tensor, w: Mapping, cfg: Mapping, cast=None) -> torch.Tensor:
    """(F, S, S, 3) frames -> the video token stream (F * pooled + 1, H)."""
    v = cfg["vision_config"]
    feats = siglip(pixels, w, cfg, cast)
    h = F.gelu(_mm(feats, _f(w, "projector_linear_1.kernel"), cast)
               + _f(w, "projector_linear_1.bias"))
    h = _mm(h, _f(w, "projector_linear_2.kernel"), cast) + _f(w, "projector_linear_2.bias")
    side = v["image_size"] // v["patch_size"]
    out = -(-side // 2)
    grid = h.reshape(h.shape[0], side, side, -1).permute(0, 3, 1, 2)
    pooled = F.interpolate(grid, size=(out, out), mode="bilinear", align_corners=False,
                           antialias=False)
    flat = pooled.permute(0, 2, 3, 1).reshape(-1, h.shape[-1])
    return torch.cat([flat, _f(w, "image_newline")[None]])


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def logits_at(ids: torch.Tensor, video: torch.Tensor, video_token_id: int, positions,
              w: Mapping, cfg: Mapping, cast=None) -> torch.Tensor:
    """The output head's logits at ``positions`` (each predicting the token
    after it) for the sequence ``ids`` (S,), whose ``video_token_id``
    positions take the rows of ``video`` in order.  Causal attention over
    the whole sequence, rotary positions 0 ... S-1."""
    t = cfg["text_config"]
    h, nh, nkv = t["hidden_size"], t["num_attention_heads"], t["num_key_value_heads"]
    hd, eps = h // nh, t["rms_norm_eps"]
    dev = ids.device
    x = w["embed_tokens.embedding"][ids].to(torch.float32)
    slots = (ids == video_token_id).nonzero()[:, 0]
    x[slots] = video[:len(slots)].to(x.dtype)
    s = ids.shape[0]
    inv = 1.0 / (t["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float64, device=dev) / hd))
    ang = torch.arange(s, dtype=torch.float64, device=dev)[:, None] * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos().float()[:, None], emb.sin().float()[:, None]
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))
    for i in range(t["num_hidden_layers"]):
        lp = f"layers.{i}."
        a = _rms(x, _f(w, lp + "input_layernorm.scale"), eps)
        q, k, v = ((_mm(a, _f(w, lp + f"{n}_proj.kernel"), cast) + _f(w, lp + f"{n}_proj.bias"))
                   .reshape(s, heads, hd) for n, heads in (("q", nh), ("k", nkv), ("v", nkv)))
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        scores = scores.masked_fill(~causal[None], float("-inf"))
        att = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v).reshape(s, nh * hd)
        x = x + _mm(att, _f(w, lp + "o_proj.kernel"), cast)
        a = _rms(x, _f(w, lp + "post_attention_layernorm.scale"), eps)
        gate = _mm(a, _f(w, lp + "gate_proj.kernel"), cast)
        up = _mm(a, _f(w, lp + "up_proj.kernel"), cast)
        x = x + _mm(F.silu(gate) * up, _f(w, lp + "down_proj.kernel"), cast)
    x = _rms(x[positions], _f(w, "norm.scale"), eps)
    return _mm(x, _f(w, "lm_head.kernel"), cast)
