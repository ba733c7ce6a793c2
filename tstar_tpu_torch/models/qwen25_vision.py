"""Qwen2.5-VL's vision tower (port of ``tstar_tpu/models/qwen25_vision.py``),
the tower of the VLM family the reference's ``QwenInterface`` serves.

What differs from the Qwen2-VL tower (``models/qwen2vl.py``):
  * RMSNorm in place of LayerNorm (the blocks' norms and the merger's);
  * a SwiGLU MLP with biases in place of the 2-layer GELU MLP;
  * windowed attention: the patches are reordered into window-raster order,
    and all blocks but ``fullatt_block_indexes`` attend only within their
    112 px window, through an additive (N, N) bias built from static
    segment ids; the tokens return to the image's order after the merger.

The language model is the Qwen2 decoder, unchanged.  The reference computes
this tower with plain ``einsum`` / ``softmax`` (XLA, no Pallas kernel), so
the port keeps plain torch ops at the reference's rounding points: the
logits and the bias add in the compute dtype, the softmax in f32 and
rounded back (no SDPA, whose rounding differs).  The window bias is built
once a forward, in the compute dtype, and shared by the windowed blocks;
the full-attention blocks add none (the reference adds zeros).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from tstar_tpu_torch.kernels.image import device_constant
from tstar_tpu_torch.models.convert import Rule, rule
from tstar_tpu_torch.models.qwen2vl import RMSNorm, _softmax_f32, apply_rope, vision_rope_angles
from tstar_tpu_torch.models.transformer import Dense


@dataclasses.dataclass(frozen=True)
class Qwen25VisionConfig:
    depth: int = 32
    embed_dim: int = 1280            # HF: vision hidden_size
    num_heads: int = 16
    intermediate_size: int = 3456
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    in_channels: int = 3
    hidden_size: int = 3584          # LM width (HF: out_hidden_size)
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2


def window_partition(grid_h: int, grid_w: int, cfg: Qwen25VisionConfig):
    """The static window layout of one image (host numpy) -> (window index
    over merge units, segment id of each PATCH in window order), as HF
    ``get_window_index``: merge units (2x2 patch groups) gathered window by
    window, the padding units dropped."""
    m = cfg.spatial_merge_size
    win = cfg.window_size // m // cfg.patch_size     # units a window side
    uh, uw = grid_h // m, grid_w // m
    index = np.arange(uh * uw).reshape(uh, uw)
    pad_h, pad_w = (-uh) % win, (-uw) % win
    padded = np.full((uh + pad_h, uw + pad_w), -1, np.int64)
    padded[:uh, :uw] = index
    nwh, nww = (uh + pad_h) // win, (uw + pad_w) // win
    blocks = padded.reshape(nwh, win, nww, win).transpose(0, 2, 1, 3).reshape(-1, win * win)
    window_index: List[int] = []
    seg_units: List[int] = []
    for w, block in enumerate(blocks):
        units = block[block >= 0]
        window_index.extend(units.tolist())
        seg_units.extend([w] * len(units))
    seg_patches = np.repeat(np.asarray(seg_units, np.int64), m * m)
    return np.asarray(window_index, np.int64), seg_patches


@functools.lru_cache(maxsize=16)
def window_layout(cfg: Qwen25VisionConfig, grid_hw: Tuple[int, int]):
    """(patch permutation into window order, the rotary table (P, head_dim)
    in that order, segment ids, the inverse permutation of merge units),
    host numpy."""
    unit = cfg.spatial_merge_size ** 2
    window_index, seg = window_partition(*grid_hw, cfg)
    n_units = grid_hw[0] * grid_hw[1] // unit
    perm = np.repeat(window_index * unit, unit) + np.tile(np.arange(unit), n_units)
    angles = vision_rope_angles(*grid_hw, cfg.head_dim, cfg.spatial_merge_size)[perm]
    return perm, np.concatenate([angles, angles], axis=-1), seg, np.argsort(window_index)


class Qwen25VisionBlock(nn.Module):
    def __init__(self, cfg: Qwen25VisionConfig):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads      # this rank's under tensor parallelism
        d, i = cfg.embed_dim, cfg.intermediate_size
        self.norm1 = RMSNorm(d, cfg.eps)
        self.qkv = Dense(d, 3 * d)
        self.proj = Dense(d, d)
        self.norm2 = RMSNorm(d, cfg.eps)
        self.gate_proj = Dense(d, i)
        self.up_proj = Dense(d, i)
        self.down_proj = Dense(i, d)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                attn_bias) -> torch.Tensor:
        """``attn_bias``: (P, P) additive in the compute dtype, or None."""
        c = self.cfg
        heads = self.num_heads
        qkv = self.qkv(self.norm1(x)).reshape(*x.shape[:-1], 3, heads, c.head_dim)
        q, k, v = qkv.unbind(dim=-3)                       # (..., P, H, hd)
        q, k = apply_rope(q, k, cos, sin)
        scale = c.head_dim ** -0.5
        qh, kh, vh = (t.transpose(-3, -2) for t in (q * scale, k.to(q.dtype), v))
        logits = torch.matmul(qh, kh.transpose(-1, -2))
        if attn_bias is not None:
            logits = logits + attn_bias
        out = torch.matmul(_softmax_f32(logits, x.dtype), vh).transpose(-3, -2)
        out = out.reshape(*x.shape[:-1], heads * c.head_dim)
        x = x + self.proj(out)
        h = self.norm2(x)
        return x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class Qwen25VisionTower(nn.Module):
    """``Qwen2VLVisionTower``'s call: flattened patches (..., P, patch_dim)
    in spatial-merge raster order and the static (grid_h, grid_w) ->
    (..., P / merge^2, hidden_size) tokens in that order."""

    def __init__(self, cfg: Qwen25VisionConfig):
        super().__init__()
        self.cfg = cfg
        d, m2 = cfg.embed_dim, cfg.spatial_merge_size ** 2
        self.patch_embed = Dense(cfg.patch_dim, d, use_bias=False)
        self.blocks = nn.ModuleList(Qwen25VisionBlock(cfg) for _ in range(cfg.depth))
        self.merger_ln = RMSNorm(d, cfg.eps)
        self.merger_fc1 = Dense(m2 * d, m2 * d)
        self.merger_fc2 = Dense(m2 * d, cfg.hidden_size)

    def forward(self, patches: torch.Tensor, grid_hw: Tuple[int, int]) -> torch.Tensor:
        c = self.cfg
        dev = patches.device
        key = ("qwen25_vision", c, *grid_hw)
        perm, emb, seg, reverse = (
            device_constant(key + (i,), lambda i=i: window_layout(c, tuple(grid_hw))[i], dev)
            for i in range(4))
        x = self.patch_embed(patches.to(self.patch_embed.kernel.dtype))
        x = x.index_select(-2, perm)
        cos, sin = torch.cos(emb)[:, None, :], torch.sin(emb)[:, None, :]
        # the window bias, once a forward: 0 within a window, f32's lowest
        # between windows, in the compute dtype (bf16 rounds it to -inf)
        neg = torch.finfo(torch.float32).min
        window_bias = torch.where(seg[:, None] == seg[None, :], 0.0, neg).to(x.dtype)
        for i, block in enumerate(self.blocks):
            x = block(x, cos, sin, None if i in c.fullatt_block_indexes else window_bias)
        x = self.merger_ln(x)
        m2 = c.spatial_merge_size ** 2
        x = x.reshape(*x.shape[:-2], x.shape[-2] // m2, m2 * c.embed_dim)
        x = self.merger_fc2(F.gelu(self.merger_fc1(x), approximate="none"))
        return x.index_select(-2, reverse)


def qwen25_vision_rules(v: Qwen25VisionConfig) -> List[Rule]:
    """HF Qwen2.5-VL vision names (``visual.`` or ``model.visual.``) -> the
    tower's parameters under ``visual.`` (the reference's
    ``convert_hf_qwen25_vision``)."""

    def vp(name):
        return (f"visual.{name}", f"model.visual.{name}")

    def lin(port, hf):
        return [rule(f"visual.{port}.kernel", *vp(hf + ".weight"), kind="T"),
                rule(f"visual.{port}.bias", *vp(hf + ".bias"))]

    def rms(port, hf):
        return [rule(f"visual.{port}.scale", *vp(hf + ".weight"))]

    shape = (v.embed_dim, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size)
    rules = [
        rule("visual.patch_embed.kernel", *vp("patch_embed.proj.weight"), kind="flat", shape=shape),
        *rms("merger_ln", "merger.ln_q"),
        *lin("merger_fc1", "merger.mlp.0"),
        *lin("merger_fc2", "merger.mlp.2"),
    ]
    for i in range(v.depth):
        b = f"blocks.{i}"
        rules += [*rms(f"{b}.norm1", f"{b}.norm1"), *rms(f"{b}.norm2", f"{b}.norm2"),
                  *lin(f"{b}.qkv", f"{b}.attn.qkv"), *lin(f"{b}.proj", f"{b}.attn.proj"),
                  *lin(f"{b}.gate_proj", f"{b}.mlp.gate_proj"),
                  *lin(f"{b}.up_proj", f"{b}.mlp.up_proj"),
                  *lin(f"{b}.down_proj", f"{b}.mlp.down_proj")]
    return rules
