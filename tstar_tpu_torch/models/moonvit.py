"""MoonViT, Kimi-VL's native-resolution vision tower (Kimi-VL technical
report, arXiv 2504.07491, section 2.1; the published ``modeling_kimi_vl.py``),
with its 2 x 2 patch merge and the two-layer projector into the language
model's width.  No JAX counterpart: the reference package has no Kimi-VL.

  * Patch embedding: a stride-14 convolution, one matmul over the flattened
    patches (as ``siglip.PatchEmbedding``), at the frame's own size: an
    H x W frame (multiples of 28) gives an (H/14) x (W/14) patch grid.
  * A learned 64 x 64 position table, resampled bicubically (half-pixel
    centres, a = -0.75, no antialiasing: ``F.interpolate``) to the patch grid
    in f32 and rounded, added to the patch embeddings.
  * 27 pre-LN layers: a fused q|k|v projection with bias; 2D rotary
    positions on q and k (head 72: 18 frequencies 10,000^(-4i/72); the
    interleaved pair 2i turns by the patch's column times frequency i, the
    pair 2i + 1 by its row, in f32, rounded back); attention within one
    frame only (a frame is a batch row); a tanh-GELU MLP.  Then a final LN.
  * The merge: each 2 x 2 block of patches (row-major blocks, the four in
    row-major order) becomes one token of 4 x 1,152 values; the projector
    LayerNorms each of the four, then Linear 4,608 -> 4,608, GELU (erf),
    Linear -> the language model's width.

A module computes in its parameters' dtype; LayerNorms take K3 where it
takes their width (``transformer.LayerNorm``), attention is
``transformer.dot_product_attention`` (f32 logits and softmax, as SigLIP's
heads of 72 take).  The frames of one call share one size.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from tstar_tpu_torch.kernels.image import device_constant, patchify_rect
from tstar_tpu_torch.models.transformer import ACTIVATIONS, Dense, LayerNorm, dot_product_attention


@dataclasses.dataclass(frozen=True)
class MoonViTConfig:
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    patch_size: int = 14
    pos_emb_height: int = 64
    pos_emb_width: int = 64
    merge_kernel: Tuple[int, int] = (2, 2)
    rope_theta: float = 10000.0
    eps: float = 1e-5               # every LayerNorm of the tower and the projector
    text_hidden_size: int = 2048    # the projector's output

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def merged_size(self) -> int:
        return self.hidden_size * self.merge_kernel[0] * self.merge_kernel[1]


def rope_2d_angles(grid_h: int, grid_w: int, head_dim: int, theta: float) -> np.ndarray:
    """(grid_h * grid_w, head_dim / 2) f32 angles of the patches in row-major
    order: pair 2i turns by column * f_i, pair 2i + 1 by row * f_i, with
    f_i = theta^(-4i / head_dim), i < head_dim / 4."""
    freqs = (1.0 / theta ** (np.arange(0, head_dim, 4, dtype=np.float32)[:head_dim // 4]
                             / np.float32(head_dim))).astype(np.float32)
    rows, cols = np.divmod(np.arange(grid_h * grid_w), grid_w)
    ang = np.empty((grid_h * grid_w, head_dim // 2), np.float32)
    ang[:, 0::2] = cols[:, None].astype(np.float32) * freqs[None]
    ang[:, 1::2] = rows[:, None].astype(np.float32) * freqs[None]
    return ang


def apply_rope_2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) turned pairwise in f32 by angles whose cos / sin are
    (S, 1, D / 2), rounded back to x's dtype: (x0 + i x1) e^(i angle)."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class MoonViTLayer(nn.Module):
    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.norm0 = LayerNorm(d, cfg.eps)
        self.wqkv = Dense(d, 3 * d)
        self.wo = Dense(d, d)
        self.norm1 = LayerNorm(d, cfg.eps)
        self.fc0 = Dense(d, cfg.intermediate_size)
        self.fc1 = Dense(cfg.intermediate_size, d)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        f, s, d = x.shape
        q, k, v = (t.reshape(f, s, self.num_heads, -1)
                   for t in self.wqkv(self.norm0(x)).split(d, dim=-1))
        out = dot_product_attention(apply_rope_2d(q, cos, sin), apply_rope_2d(k, cos, sin), v,
                                    None)
        x = x + self.wo(out.reshape(f, s, d))
        return x + self.fc1(ACTIVATIONS["gelu_tanh"](self.fc0(self.norm1(x))))


class MoonViT(nn.Module):
    """Frames (F, H, W, 3) normalised, H and W multiples of the merge cell ->
    merged tokens projected into the language model (F, H W / 784, text
    width)."""

    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = nn.Parameter(torch.empty(p, p, 3, d))
        self.patch_embed.bias = nn.Parameter(torch.zeros(d))
        self.pos_embedding = nn.Parameter(torch.empty(cfg.pos_emb_height, cfg.pos_emb_width, d))
        self.layers = nn.ModuleList(MoonViTLayer(cfg) for _ in range(cfg.num_layers))
        self.final_layernorm = LayerNorm(d, cfg.eps)
        # the projector
        self.pre_norm = LayerNorm(d, cfg.eps)
        self.linear_1 = Dense(cfg.merged_size, cfg.merged_size)
        self.linear_2 = Dense(cfg.merged_size, cfg.text_hidden_size)

    def position_table(self, grid_h: int, grid_w: int) -> torch.Tensor:
        """The learned table at the patch grid: (grid_h * grid_w, D)."""
        table = self.pos_embedding
        if (grid_h, grid_w) != tuple(table.shape[:2]):
            table = F.interpolate(table.float().permute(2, 0, 1)[None], size=(grid_h, grid_w),
                                  mode="bicubic", align_corners=False)[0].permute(1, 2, 0)
        return table.reshape(grid_h * grid_w, -1).to(self.pos_embedding.dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        p, (mh, mw) = cfg.patch_size, cfg.merge_kernel
        f, h, w, _ = pixels.shape
        if h % (p * mh) or w % (p * mw):
            raise ValueError(f"frames of {h} x {w} are not whole {p * mh} x {p * mw} merge cells")
        gh, gw = h // p, w // p
        dtype = self.pos_embedding.dtype
        kernel = self.patch_embed.kernel
        x = torch.matmul(patchify_rect(pixels.to(dtype), p, p), kernel.reshape(-1, kernel.shape[-1]))
        x = x + self.patch_embed.bias + self.position_table(gh, gw)
        ang = device_constant(("moonvit_rope", gh, gw, cfg.head_dim, float(cfg.rope_theta)),
                              lambda: rope_2d_angles(gh, gw, cfg.head_dim, cfg.rope_theta),
                              pixels.device)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        for layer in self.layers:
            x = layer(x, cos, sin)
        x = self.final_layernorm(x)
        d = x.shape[-1]
        x = (x.reshape(f, gh // mh, mh, gw // mw, mw, d).permute(0, 1, 3, 2, 4, 5)
             .reshape(f, (gh // mh) * (gw // mw), mh * mw, d))
        x = self.pre_norm(x).reshape(f, -1, cfg.merged_size)
        return self.linear_2(ACTIVATIONS["gelu"](self.linear_1(x)))
