"""Qwen2-VL (port of ``tstar_tpu/models/qwen2vl.py``): the VLM for grounding and QA.

Architecture of HF ``Qwen2VLForConditionalGeneration``:

  * vision tower: 14 px patches embedded by one matmul over the flattened
    (C, T, P, P) patch (HF's stride = kernel Conv3d), 2D rotary embedding
    over the patch grid in spatial-merge raster order, pre-LN blocks with a
    fused q|k|v projection, and a 2x2 PatchMerger MLP into the LM width;
  * language model: the Qwen2 decoder (RMSNorm, GQA with biased q/k/v,
    SwiGLU MLP) under multimodal 3D RoPE (temporal / height / width channel
    sections; text tokens have equal t/h/w positions);
  * image features replace the ``image_token_id`` embeddings in order.

A module computes in its parameters' dtype (bf16 on the card, f32 in the
parity tests), at the reference's rounding points: projections round to
the compute dtype; RoPE runs in f32 and rounds back; the attention logits
and the bias add stay in the compute dtype, the softmax runs in f32 and
rounds back.  None of this is a Pallas kernel in the reference (XLA), so
the decoder's attention, RMSNorm, RoPE and SwiGLU are plain torch ops here
(``torch.matmul`` for the products, not SDPA, whose rounding differs).  The
vision LayerNorms are the port's ``LayerNorm`` (the same math as flax's).

``build_mrope_position_ids`` is host numpy, as in the reference: a caller
uploads the positions once a request.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from tstar_tpu_torch.kernels.image import device_constant
from tstar_tpu_torch.models.convert import Rule, convert_state_dict, rule
from tstar_tpu_torch.models.transformer import ACTIVATIONS, Dense, LayerNorm
from tstar_tpu_torch.models.tensor_parallel import all_gather_last, all_reduce_


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    mlp_ratio: float = 4.0
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    in_channels: int = 3
    hidden_size: int = 3584          # LM width the merger projects into
    hidden_act: str = "quick_gelu"
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


@dataclasses.dataclass(frozen=True)
class Qwen2VLTextConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    intermediate_size: int = 18944
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    vision: Qwen2VLVisionConfig = dataclasses.field(default_factory=Qwen2VLVisionConfig)
    text: Qwen2VLTextConfig = dataclasses.field(default_factory=Qwen2VLTextConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale.float()).to(self.scale.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: an (V, D) table read in the module's dtype.  Under
    tensor parallelism (``tp``) it holds vocabulary rows [vocab_start,
    vocab_start + V/T): a lookup reads its rows with the others masked to
    zero, then all-reduces; ``attend`` all-gathers the logits' columns."""

    tp = None
    vocab_start = 0

    def __init__(self, vocab: int, d: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, d))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.embedding[ids]
        n = self.embedding.shape[0]
        local = ids - self.vocab_start
        inside = (local >= 0) & (local < n)
        x = self.embedding[local.clamp(0, n - 1)] * inside[..., None].to(self.embedding.dtype)
        return all_reduce_(x, self.tp)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.embedding.t())
        return y if self.tp is None else all_gather_last(y, self.tp)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q/k: (..., S, H, D); cos/sin broadcastable to (..., S, 1, D).  f32."""
    qf, kf = q.float(), k.float()
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def _softmax_f32(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------

def vision_rope_angles(
    grid_h: int, grid_w: int, head_dim: int, merge: int = 2, theta: float = 10000.0
) -> np.ndarray:
    """Rotary angles per patch in spatial-merge raster order -> (P, head_dim/2):
    h/w position ids laid out as (h/merge, w/merge, merge, merge) blocks, the
    h-angles and w-angles (head_dim/4 frequencies each) side by side."""
    dim_quarter = head_dim // 4
    inv_freq = 1.0 / (theta ** (np.arange(0, dim_quarter * 2, 2, np.float32) / (dim_quarter * 2)))

    def block_order(ids_2d: np.ndarray) -> np.ndarray:
        h, w = ids_2d.shape
        return (
            ids_2d.reshape(h // merge, merge, w // merge, merge)
            .transpose(0, 2, 1, 3)
            .reshape(-1)
        )

    hpos = block_order(np.broadcast_to(np.arange(grid_h)[:, None], (grid_h, grid_w)))
    wpos = block_order(np.broadcast_to(np.arange(grid_w)[None, :], (grid_h, grid_w)))
    freqs_h = hpos[:, None].astype(np.float32) * inv_freq[None]
    freqs_w = wpos[:, None].astype(np.float32) * inv_freq[None]
    return np.concatenate([freqs_h, freqs_w], axis=-1)


class VisionBlock(nn.Module):
    def __init__(self, cfg: Qwen2VLVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads      # this rank's under tensor parallelism
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d, cfg.eps)
        self.qkv = Dense(d, 3 * d)
        self.proj = Dense(d, d)
        self.norm2 = LayerNorm(d, cfg.eps)
        self.fc1 = Dense(d, cfg.mlp_hidden)
        self.fc2 = Dense(cfg.mlp_hidden, d)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        heads = self.num_heads
        qkv = self.qkv(self.norm1(x)).reshape(*x.shape[:-1], 3, heads, c.head_dim)
        q, k, v = qkv.unbind(dim=-3)                       # (..., P, H, hd)
        q, k = apply_rope(q, k, cos, sin)
        scale = c.head_dim ** -0.5
        qh, kh, vh = (t.transpose(-3, -2) for t in (q * scale, k.to(q.dtype), v))
        probs = _softmax_f32(torch.matmul(qh, kh.transpose(-1, -2)), x.dtype)
        out = torch.matmul(probs, vh).transpose(-3, -2).reshape(*x.shape[:-1], heads * c.head_dim)
        x = x + self.proj(out)
        h = ACTIVATIONS[c.hidden_act](self.fc1(self.norm2(x)))
        return x + self.fc2(h)


class Qwen2VLVisionTower(nn.Module):
    """Per-image encoder: flattened patches (..., P, patch_dim) in
    spatial-merge raster order (what ``preprocess_image`` emits) and the
    static (grid_h, grid_w) -> (..., P / merge^2, hidden_size) tokens."""

    def __init__(self, cfg: Qwen2VLVisionConfig):
        super().__init__()
        self.cfg = cfg
        d, m2 = cfg.embed_dim, cfg.spatial_merge_size ** 2
        self.patch_embed = Dense(cfg.patch_dim, d, use_bias=False)
        self.blocks = nn.ModuleList(VisionBlock(cfg) for _ in range(cfg.depth))
        self.merger_ln = LayerNorm(d, cfg.eps)
        self.merger_fc1 = Dense(m2 * d, m2 * d)
        self.merger_fc2 = Dense(m2 * d, cfg.hidden_size)

    def forward(self, patches: torch.Tensor, grid_hw: Tuple[int, int]) -> torch.Tensor:
        c = self.cfg
        x = self.patch_embed(patches.to(self.patch_embed.kernel.dtype))
        key = ("qwen2vl_vision_rope", *grid_hw, c.head_dim, c.spatial_merge_size)

        def table():
            angles = vision_rope_angles(*grid_hw, c.head_dim, c.spatial_merge_size)
            return np.concatenate([angles, angles], axis=-1)

        emb = device_constant(key, table, x.device)             # (P, head_dim) f32
        cos, sin = torch.cos(emb)[:, None, :], torch.sin(emb)[:, None, :]
        for block in self.blocks:
            x = block(x, cos, sin)
        x = self.merger_ln(x)
        m2 = c.spatial_merge_size ** 2
        x = x.reshape(*x.shape[:-2], x.shape[-2] // m2, m2 * c.embed_dim)
        return self.merger_fc2(F.gelu(self.merger_fc1(x), approximate="none"))


# ---------------------------------------------------------------------------
# Language model
# ---------------------------------------------------------------------------

def mrope_cos_sin(
    position_ids: torch.Tensor,    # (3, B, S) t/h/w positions
    head_dim: int,
    mrope_section: Sequence[int],
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE tables -> cos/sin (B, S, 1, head_dim) f32, channels as
    HF ``apply_multimodal_rotary_pos_emb``: the head_dim/2 frequencies split
    into (t, h, w) sections, duplicated for both rotary halves."""
    half = head_dim // 2
    sections = list(mrope_section)
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    inv_freq = device_constant(
        ("mrope_inv_freq", head_dim, float(theta)),
        lambda: 1.0 / (theta ** (np.arange(0, head_dim, 2, np.float32) / head_dim)),
        position_ids.device,
    )
    freqs = position_ids[..., None].float() * inv_freq           # (3, B, S, half)
    chunks, start = [], 0
    for i, sec in enumerate(sections):
        chunks.append(freqs[i, :, :, start:start + sec])
        start += sec
    sel = torch.cat(chunks, dim=-1)
    emb = torch.cat([sel, sel], dim=-1)
    return torch.cos(emb)[..., None, :], torch.sin(emb)[..., None, :]


KVCache = Tuple[torch.Tensor, torch.Tensor]     # (B, max_len, kv_heads, head_dim) each


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2VLTextConfig):
        super().__init__()
        self.cfg = cfg
        # this rank's heads under tensor parallelism
        self.num_heads, self.num_kv_heads = cfg.num_heads, cfg.num_kv_heads
        d, hd = cfg.hidden_size, cfg.head_dim
        self.input_layernorm = RMSNorm(d, cfg.rms_norm_eps)
        self.q_proj = Dense(d, cfg.num_heads * hd)
        self.k_proj = Dense(d, cfg.num_kv_heads * hd)
        self.v_proj = Dense(d, cfg.num_kv_heads * hd)
        self.o_proj = Dense(cfg.num_heads * hd, d, use_bias=False)
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_norm_eps)
        self.gate_proj = Dense(d, cfg.intermediate_size, use_bias=False)
        self.up_proj = Dense(d, cfg.intermediate_size, use_bias=False)
        self.down_proj = Dense(cfg.intermediate_size, d, use_bias=False)

    def forward(
        self,
        x: torch.Tensor,                      # (B, S, D)
        cos: torch.Tensor,
        sin: torch.Tensor,
        attn_bias: Optional[torch.Tensor],    # (B, 1, S, S_kv) additive
        cache: Optional[KVCache] = None,
        cache_index=None,                     # int or 0-d device tensor
    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """-> (x, cache).  With a cache, this step's K/V are written into it
        in place at ``cache_index`` and attention reads every cache slot."""
        c = self.cfg
        hd, nh, nkv = c.head_dim, self.num_heads, self.num_kv_heads
        b, s = x.shape[:2]
        h = self.input_layernorm(x)
        q = self.q_proj(h).reshape(b, s, nh, hd)
        k = self.k_proj(h).reshape(b, s, nkv, hd)
        v = self.v_proj(h).reshape(b, s, nkv, hd)
        q, k = apply_rope(q, k, cos, sin)
        if cache is not None:
            k_all, v_all = cache
            slots = cache_index + torch.arange(s, device=x.device)
            k_all.index_copy_(1, slots, k.to(k_all.dtype))
            v_all.index_copy_(1, slots, v.to(v_all.dtype))
        else:
            k_all, v_all = k, v
        groups = nh // nkv
        # (B, KV, G*S, hd) @ (B, KV, hd, M): heads kv*G + g share K/V head kv
        qg = (q * hd ** -0.5).reshape(b, s, nkv, groups, hd).permute(0, 2, 3, 1, 4)
        kt = k_all.to(q.dtype).permute(0, 2, 3, 1)
        logits = torch.matmul(qg.reshape(b, nkv, groups * s, hd), kt)
        logits = logits.reshape(b, nkv, groups, s, -1)
        if attn_bias is not None:
            logits = logits + attn_bias[:, :, None].to(logits.dtype)
        probs = _softmax_f32(logits, x.dtype).reshape(b, nkv, groups * s, -1)
        vv = v_all.permute(0, 2, 1, 3)
        ctype = torch.promote_types(probs.dtype, vv.dtype)
        out = torch.matmul(probs.to(ctype), vv.to(ctype)).reshape(b, nkv, groups, s, hd)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, s, nh * hd)
        x = x + self.o_proj(out.to(x.dtype))
        h = self.post_attention_layernorm(x)
        down = self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))
        return x + down, cache


class Qwen2LM(nn.Module):
    """The Qwen2 language model with its multimodal surface, shared by
    ``Qwen2VLModel`` and LLaVA-OneVision: token embedding with vision
    features scattered in, decoder, final norm and logits."""

    def _init_lm(self, t: Qwen2VLTextConfig):
        self.embed_tokens = Embed(t.vocab_size, t.hidden_size)
        self.layers = nn.ModuleList(Qwen2DecoderLayer(t) for _ in range(t.num_layers))
        self.norm = RMSNorm(t.hidden_size, t.rms_norm_eps)
        self.lm_head = (
            None if t.tie_word_embeddings else Dense(t.hidden_size, t.vocab_size, use_bias=False)
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.embedding.dtype

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.embedding.device

    def _scatter(self, input_ids, image_embeds, token_id) -> torch.Tensor:
        """Embeddings with the k-th ``token_id`` position (in (B, S) order)
        taking the k-th row of ``image_embeds`` (HF's masked_scatter)."""
        x = self.embed_tokens(input_ids)
        if image_embeds is None:
            return x
        flat_mask = (input_ids == token_id).reshape(-1)
        order = torch.cumsum(flat_mask.to(torch.int64), 0) - 1
        gathered = image_embeds[order.clamp(0, image_embeds.shape[0] - 1)]
        flat_x = x.reshape(-1, x.shape[-1])
        flat_x = torch.where(flat_mask[:, None], gathered.to(x.dtype), flat_x)
        return flat_x.reshape(x.shape)

    def decoder(self, hidden, position_ids, attn_bias, caches=None, cache_index=None):
        t = self.cfg.text
        cos, sin = mrope_cos_sin(position_ids, t.head_dim, t.mrope_section, t.rope_theta)
        for i, layer in enumerate(self.layers):
            hidden, _ = layer(hidden, cos, sin, attn_bias,
                              caches[i] if caches is not None else None, cache_index)
        return self.norm(hidden), caches

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return self.embed_tokens.attend(hidden).float()
        return self.lm_head(hidden).float()

    def _full_forward(self, input_ids, position_ids, attention_mask, image_embeds, token_id):
        s = input_ids.shape[1]
        hidden = self._scatter(input_ids, image_embeds, token_id)
        neg = torch.finfo(torch.float32).min
        causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=input_ids.device))
        bias = torch.where(causal, 0.0, neg)[None, None]
        if attention_mask is not None:
            bias = bias + torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg)
        hidden, _ = self.decoder(hidden, position_ids, bias)
        return self.logits(hidden)


class Qwen2VLModel(Qwen2LM):
    """Full VLM: embeds tokens, scatters vision features, runs the decoder."""

    def __init__(self, cfg: Qwen2VLConfig):
        super().__init__()
        self.cfg = cfg
        if hasattr(cfg.vision, "window_size"):
            # Qwen2.5-VL: RMSNorm, SwiGLU and windowed attention
            from tstar_tpu_torch.models.qwen25_vision import Qwen25VisionTower

            self.visual = Qwen25VisionTower(cfg.vision)
        else:
            self.visual = Qwen2VLVisionTower(cfg.vision)
        self._init_lm(cfg.text)

    def encode_images(self, patches: torch.Tensor, grid_hw: Tuple[int, int]) -> torch.Tensor:
        """(N_imgs, P, patch_dim) -> (N_imgs, P / merge^2, hidden)."""
        return self.visual(patches, grid_hw)

    def embed(self, input_ids: torch.Tensor, image_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        return self._scatter(input_ids, image_embeds, self.cfg.image_token_id)

    def forward(self, input_ids, position_ids, attention_mask=None, image_patches=None,
                image_grid_hw=None) -> torch.Tensor:
        """Full forward -> logits (B, S, vocab) f32, causal."""
        embeds = None
        if image_patches is not None:
            enc = self.encode_images(image_patches, image_grid_hw)
            embeds = enc.reshape(-1, enc.shape[-1])
        return self._full_forward(input_ids, position_ids, attention_mask, embeds,
                                  self.cfg.image_token_id)


# ---------------------------------------------------------------------------
# 3D rope position ids (host-side; HF get_rope_index equivalent)
# ---------------------------------------------------------------------------

def build_mrope_position_ids(
    input_ids: np.ndarray,            # (S,) single sequence, no padding
    image_token_id: int,
    grids_thw: Sequence[Tuple[int, int, int]],  # per image: (t, h, w) BEFORE merge
    spatial_merge_size: int = 2,
) -> np.ndarray:
    """(3, S) t/h/w position ids; text runs use equal positions continuing
    from max(previous) + 1; each image block uses its 3D grid positions."""
    s = len(input_ids)
    out = np.zeros((3, s), np.int64)
    img_iter = iter(grids_thw)
    pos = 0
    i = 0
    while i < s:
        if input_ids[i] == image_token_id:
            t, h, w = next(img_iter)
            hh, ww = h // spatial_merge_size, w // spatial_merge_size
            n = t * hh * ww
            tt = np.repeat(np.arange(t), hh * ww)
            hp = np.tile(np.repeat(np.arange(hh), ww), t)
            wp = np.tile(np.arange(ww), t * hh)
            out[0, i:i + n] = pos + tt
            out[1, i:i + n] = pos + hp
            out[2, i:i + n] = pos + wp
            pos = out[:, i:i + n].max() + 1
            i += n
        else:
            out[:, i] = pos
            pos += 1
            i += 1
    return out


# ---------------------------------------------------------------------------
# Weights: HF names and the reference's flax variables
# ---------------------------------------------------------------------------

_LM_PREFIXES = ("model.language_model.", "language_model.model.", "model.")


def lm_rules(t: Qwen2VLTextConfig, prefixes: Sequence[str] = _LM_PREFIXES) -> List[Rule]:
    """HF Qwen2 decoder names -> the LM's parameters (``_assemble_lm_params``)."""

    def tp(name):
        return tuple(p + name for p in prefixes)

    def lin(port, hf, bias=True):
        out = [rule(port + ".kernel", *tp(hf + ".weight"), kind="T")]
        return out + ([rule(port + ".bias", *tp(hf + ".bias"))] if bias else [])

    rules = [rule("embed_tokens.embedding", *tp("embed_tokens.weight")),
             rule("norm.scale", *tp("norm.weight"))]
    for i in range(t.num_layers):
        lp = f"layers.{i}"
        rules += [
            rule(f"{lp}.input_layernorm.scale", *tp(f"{lp}.input_layernorm.weight")),
            rule(f"{lp}.post_attention_layernorm.scale", *tp(f"{lp}.post_attention_layernorm.weight")),
            *lin(f"{lp}.q_proj", f"{lp}.self_attn.q_proj"),
            *lin(f"{lp}.k_proj", f"{lp}.self_attn.k_proj"),
            *lin(f"{lp}.v_proj", f"{lp}.self_attn.v_proj"),
            *lin(f"{lp}.o_proj", f"{lp}.self_attn.o_proj", bias=False),
            *lin(f"{lp}.gate_proj", f"{lp}.mlp.gate_proj", bias=False),
            *lin(f"{lp}.up_proj", f"{lp}.mlp.up_proj", bias=False),
            *lin(f"{lp}.down_proj", f"{lp}.mlp.down_proj", bias=False),
        ]
    if not t.tie_word_embeddings:
        rules.append(rule("lm_head.kernel", "lm_head.weight", kind="T"))
    return rules


def qwen2vl_rules(cfg: Qwen2VLConfig) -> List[Rule]:
    v = cfg.vision
    if hasattr(v, "window_size"):
        from tstar_tpu_torch.models.qwen25_vision import qwen25_vision_rules

        return qwen25_vision_rules(v) + lm_rules(cfg.text)

    def vp(name):
        return (f"visual.{name}", f"model.visual.{name}")

    def lin(port, hf):
        return [rule(f"visual.{port}.kernel", *vp(hf + ".weight"), kind="T"),
                rule(f"visual.{port}.bias", *vp(hf + ".bias"))]

    def ln(port, hf):
        return [rule(f"visual.{port}.scale", *vp(hf + ".weight")),
                rule(f"visual.{port}.bias", *vp(hf + ".bias"))]

    shape = (v.embed_dim, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size)
    rules = [
        rule("visual.patch_embed.kernel", *vp("patch_embed.proj.weight"), kind="flat", shape=shape),
        *ln("merger_ln", "merger.ln_q"),
        *lin("merger_fc1", "merger.mlp.0"),
        *lin("merger_fc2", "merger.mlp.2"),
    ]
    for i in range(v.depth):
        b = f"blocks.{i}"
        rules += [*ln(f"{b}.norm1", f"{b}.norm1"), *ln(f"{b}.norm2", f"{b}.norm2"),
                  *lin(f"{b}.qkv", f"{b}.attn.qkv"), *lin(f"{b}.proj", f"{b}.attn.proj"),
                  *lin(f"{b}.fc1", f"{b}.mlp.fc1"), *lin(f"{b}.fc2", f"{b}.mlp.fc2")]
    return rules + lm_rules(cfg.text)


def convert_hf_qwen2vl_state_dict(sd: Mapping[str, torch.Tensor], cfg: Qwen2VLConfig) -> Dict[str, torch.Tensor]:
    """HF ``Qwen2VLForConditionalGeneration`` (or Qwen2.5-VL's, whose
    config's vision part has a ``window_size``) state dict -> a state dict
    for ``Qwen2VLModel`` (tensors keep their dtype and device)."""
    return convert_state_dict(sd, qwen2vl_rules(cfg))


def params_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's flax variables of a Qwen2-VL, Qwen2.5-VL or
    LLaVA-OneVision model -> a state dict for the port's model: names map
    one to one (``layers_3`` -> ``layers.3``, ``blocks_3`` -> ``blocks.3``;
    the Qwen2.5 tower's ``norm1.scale``, ``qkv``, ``gate_proj`` /
    ``up_proj`` / ``down_proj`` and ``merger_ln.scale`` keep their names);
    SigLIP's separate q/k/v projections fuse into ``qkv_kernel`` /
    ``qkv_bias``."""
    from tstar_tpu_torch.models.owlvit import params_from_jax as owlvit_params

    state = owlvit_params(variables)
    return {re.sub(r"\bblocks_(\d+)\b", r"blocks.\1", k): v for k, v in state.items()}


def random_model(cls, cfg, dtype=torch.bfloat16, device="cuda", seed: int = 0) -> nn.Module:
    """``cls(cfg)`` made on the meta device, given memory on ``device`` in
    ``dtype`` and seeded random weights drawn there by ``init_random_``:
    no host copy and no default initialiser, so a 7B model is built on the
    card in seconds."""
    with torch.device("meta"):
        model = cls(cfg)
    model = model.to(dtype).to_empty(device=device)
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    return model.requires_grad_(False).eval()


def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights drawn in place, on the parameters' device (the
    card's, for a model made on the meta device and moved with
    ``to_empty``): kernels N(0, 1/fan_in), embeddings N(0, 0.02^2), norm
    scales 1, biases 0."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("kernel", "qkv_kernel"):
                p.normal_(0.0, 1.0 / math.sqrt(math.prod(p.shape[:-1])), generator=generator)
            elif leaf in ("embedding", "position_embedding", "image_newline"):
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf.endswith("bias"):
                p.zero_()
            else:
                raise ValueError(f"no initializer for parameter {name}")
    return model
