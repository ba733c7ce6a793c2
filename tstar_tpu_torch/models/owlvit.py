"""OWL-ViT open-vocabulary detector (port of ``tstar_tpu/models/owlvit.py``).

Same architecture as the reference (and HF ``OwlViTForObjectDetection``):
CLIP ViT vision tower, CLIP text tower with EOT pooling, box head with a
per-patch logit-space bias, class head with a learned shift and ELU+1 scale.
Text prompts are encoded once per video (``encode_text``) and reused.

Layouts at the public functions follow the reference: pixels (B, H, W, 3)
NHWC, the patch kernel HWIO (p, p, C, D), Dense kernels (in, out).
Weights come from ``params_from_jax`` (the reference's flax variables as
numpy arrays) or from ``init_params`` (a seeded random init with flax's
initializer families, for ``owl-vit-random``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from tstar_tpu_torch.kernels.image import device_constant
from tstar_tpu_torch.kernels.patch_matmul import patch_embed_matmul
from tstar_tpu_torch.models.transformer import (
    Dense,
    Encoder,
    LayerNorm,
    causal_bias,
    padding_bias,
)
from tstar_tpu_torch.models.tensor_parallel import tensor_parallel


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 32
    image_size: int = 768
    activation: str = "quick_gelu"
    eps: float = 1e-5

    @property
    def num_patches_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_side ** 2


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    max_length: int = 16
    activation: str = "quick_gelu"
    eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class OwlViTConfig:
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    projection_dim: int = 512


def owlvit_base_patch32() -> OwlViTConfig:
    """OWL-ViT B/32, the reference's default detector."""
    return OwlViTConfig()


class PatchEmbed(nn.Module):
    """Stride = kernel patch conv as one implicit GEMM (K2 on CUDA)."""

    def __init__(self, in_channels: int, features: int, patch_size: int):
        super().__init__()
        p = patch_size
        self.kernel = nn.Parameter(torch.empty(p, p, in_channels, features))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return patch_embed_matmul(pixels.to(self.kernel.dtype).contiguous(), self.kernel)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.patch_embedding = PatchEmbed(3, c.hidden_size, c.patch_size)
        self.class_embedding = nn.Parameter(torch.empty(c.hidden_size))
        self.position_embedding = nn.Parameter(torch.empty(1 + c.num_patches, c.hidden_size))
        self.pre_layernorm = LayerNorm(c.hidden_size, c.eps)
        self.encoder = Encoder(
            c.num_layers, c.hidden_size, c.num_heads, c.intermediate_size,
            c.activation, c.eps,
        )

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized pixels -> last hidden states (B, 1+P, D)."""
        return self.from_patches(self.patch_embedding(pixels))

    def from_patches(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, P, D) patch embeddings -> last hidden states (B, 1+P, D); the
        entry of the paths that embed the grid without detector pixels (the
        composed projection, K6)."""
        patches = patches.to(self.class_embedding.dtype)
        b = patches.shape[0]
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding[None]
        return self.encoder(self.pre_layernorm(x))


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        c = cfg
        self.token_embedding = nn.Parameter(torch.empty(c.vocab_size, c.hidden_size))
        self.position_embedding = nn.Parameter(torch.empty(c.max_length, c.hidden_size))
        self.encoder = Encoder(
            c.num_layers, c.hidden_size, c.num_heads, c.intermediate_size,
            c.activation, c.eps,
        )
        self.final_layer_norm = LayerNorm(c.hidden_size, c.eps)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """(Q, S) token ids -> pooled EOT features (Q, D), pre-projection."""
        seq = input_ids.shape[-1]
        ids = input_ids.long()
        x = self.token_embedding[ids] + self.position_embedding[None, :seq]
        bias = causal_bias(seq, torch.float32, device=x.device)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask, torch.float32)
        x = self.final_layer_norm(self.encoder(x, bias))
        eot = torch.argmax(ids, dim=-1)            # EOT has the highest id
        return x[torch.arange(x.shape[0], device=x.device), eot]


class BoxHead(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dense0 = Dense(d, d)
        self.dense1 = Dense(d, d)
        self.dense2 = Dense(d, 4)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.dense0(feats), approximate="none")
        x = F.gelu(self.dense1(x), approximate="none")
        return self.dense2(x)


class ClassHead(nn.Module):
    def __init__(self, d: int, out_dim: int):
        super().__init__()
        self.dense0 = Dense(d, out_dim)
        self.logit_shift = Dense(d, 1)
        self.logit_scale = Dense(d, 1)

    def forward(
        self, image_feats: torch.Tensor, query_embeds: torch.Tensor,
        query_mask: Optional[torch.Tensor],
    ) -> torch.Tensor:
        """(B, P, D) feats -> (B, P, Q) f32 logits, against (Q, proj) queries
        shared by the image batch with a (Q,) mask, or per-image (B, Q, proj)
        queries with a (B, Q) mask (the flat multi-video detector batch)."""
        img = self.dense0(image_feats)
        img = img / (torch.linalg.vector_norm(img, dim=-1, keepdim=True) + 1e-6)
        q = query_embeds / (torch.linalg.vector_norm(query_embeds, dim=-1, keepdim=True) + 1e-6)
        if q.ndim == 3:
            logits = torch.einsum("bpd,bqd->bpq", img, q.to(img.dtype))
        else:
            logits = torch.einsum("bpd,qd->bpq", img, q.to(img.dtype))
        shift = self.logit_shift(image_feats)
        scale = F.elu(self.logit_scale(image_feats)) + 1.0
        logits = ((logits + shift) * scale).float()
        if query_mask is not None:
            neg = torch.finfo(torch.float32).min
            mask = query_mask[:, None, :] if query_mask.ndim == 2 else query_mask[None, None, :]
            logits = torch.where(mask, logits, neg)
        return logits


def box_bias(num_patches_side: int, device=None) -> torch.Tensor:
    """Per-patch logit-space prior over box center/size (HF compute_box_bias)."""
    n = num_patches_side
    coords = torch.arange(1, n + 1, dtype=torch.float32, device=device) / n
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    centers = torch.stack([xx, yy], dim=-1).reshape(-1, 2).clamp(0.0, 1.0)
    coord_bias = torch.log(centers + 1e-4) - torch.log1p(-centers + 1e-4)
    size = torch.full_like(centers, 1.0 / n)
    size_bias = torch.log(size + 1e-4) - torch.log1p(-size + 1e-4)
    return torch.cat([coord_bias, size_bias], dim=-1)


class OwlViTDetector(nn.Module):
    def __init__(self, cfg: OwlViTConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.vision = VisionTower(c.vision)
        self.text = TextTower(c.text)
        self.text_projection = Dense(c.text.hidden_size, c.projection_dim, use_bias=False)
        self.post_layernorm = LayerNorm(c.vision.hidden_size, c.vision.eps)
        self.merged_layernorm = LayerNorm(c.vision.hidden_size, c.vision.eps)
        self.box_head = BoxHead(c.vision.hidden_size)
        self.class_head = ClassHead(c.vision.hidden_size, c.text.hidden_size)

    @property
    def dtype(self) -> torch.dtype:
        return self.vision.patch_embedding.kernel.dtype

    @property
    def device(self) -> torch.device:
        return self.vision.patch_embedding.kernel.device

    def encode_text(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(Q, S) token ids -> L2-normalized query embeddings (Q, proj_dim)."""
        proj = self.text_projection(self.text(input_ids, attention_mask))
        return proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> merged per-patch features (B, P, D)."""
        return self._merge(self.vision(pixels))

    def encode_patches(self, patch_embeds: torch.Tensor) -> torch.Tensor:
        """(B, P, D) patch embeddings -> merged features (B, P, D):
        ``encode_image`` after the patch-embedding matmul."""
        return self._merge(self.vision.from_patches(patch_embeds))

    def _merge(self, hidden: torch.Tensor) -> torch.Tensor:
        hidden = self.post_layernorm(hidden)
        feats = hidden[:, 1:, :] * hidden[:, :1, :]
        return self.merged_layernorm(feats)

    def predict(
        self, image_feats: torch.Tensor, query_embeds: torch.Tensor,
        query_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, P, Q) f32, boxes cxcywh in [0, 1] (B, P, 4) f32)."""
        logits = self.class_head(image_feats, query_embeds, query_mask)
        raw = self.box_head(image_feats)
        bias = box_bias(self.cfg.vision.num_patches_side, device=raw.device)
        return logits, torch.sigmoid(raw.float() + bias)

    def forward(self, pixels, input_ids, attention_mask=None, query_mask=None):
        queries = self.encode_text(input_ids, attention_mask)
        return self.predict(self.encode_image(pixels), queries, query_mask)


def interpolate_position_embedding(
    pos: torch.Tensor, src_side: int, dst_side: int
) -> torch.Tensor:
    """Bicubically resample a ViT position embedding to a new patch grid.

    ``pos`` is (1 + src_side^2, D) with the CLS row first.  The reference
    resizes with ``jax.image.resize(method="cubic")``: the Keys cubic
    (a = -0.5), antialiased when it shrinks, weights renormalized at the
    edges.  ``F.interpolate(mode="bicubic", antialias=True)`` is that filter
    (without ``antialias`` PyTorch uses a = -0.75 and no antialiasing); it
    runs in f32 and the result takes ``pos``'s dtype.
    """
    cls_row, grid = pos[:1], pos[1:]
    d = grid.shape[-1]
    grid = grid.float().reshape(src_side, src_side, d).permute(2, 0, 1)[None]
    grid = F.interpolate(
        grid, size=(dst_side, dst_side), mode="bicubic", align_corners=False, antialias=True
    )
    grid = grid[0].permute(1, 2, 0).reshape(dst_side * dst_side, d).to(pos.dtype)
    return torch.cat([cls_row, grid], dim=0)


@torch.no_grad()
def resize_detector(model: OwlViTDetector, image_size: int) -> OwlViTDetector:
    """A detector view at another input resolution, sharing every weight.

    Only the vision position embedding is resampled (a new tensor); every
    other parameter of the returned module IS the original's tensor, so no
    weight is copied on the device (a tensor-parallel model's view holds
    the same shards).  The config's ``image_size`` changes, so
    the box bias and heads follow the new patch grid.
    """
    src = model.cfg.vision
    if image_size == src.image_size:
        return model
    if image_size % src.patch_size:
        raise ValueError(f"image_size {image_size} not a multiple of patch {src.patch_size}")
    new_cfg = dataclasses.replace(
        model.cfg, vision=dataclasses.replace(src, image_size=image_size)
    )
    with torch.device("meta"):   # shapes only; the tensors come from ``model``
        view = OwlViTDetector(new_cfg)
    tp = tensor_parallel(model)
    if tp is not None:           # the view takes the model's shards
        from tstar_tpu_torch.parallel.shardings import shard_module   # it imports the models
        shard_module(view, tp.mesh)
    state = dict(model.state_dict())
    state["vision.position_embedding"] = interpolate_position_embedding(
        model.vision.position_embedding, src.num_patches_side, image_size // src.patch_size
    )
    view.load_state_dict(state, strict=True, assign=True)
    return view.requires_grad_(False).train(model.training)


def postprocess_detections(
    logits: torch.Tensor,   # (B, P, Q)
    boxes: torch.Tensor,    # (B, P, 4) cxcywh normalized
    image_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (scores (B, P), class_ids (B, P), boxes_xyxy_pixels (B, P, 4))."""
    best = logits.amax(dim=-1)
    class_ids = torch.argmax(logits, dim=-1)      # first max, as jnp.argmax
    scores = torch.sigmoid(best)
    cx, cy, w, h = boxes.unbind(dim=-1)
    xyxy = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
    ih, iw = image_hw
    scale = device_constant(
        ("box_scale", iw, ih), lambda: np.array([iw, ih, iw, ih], np.float32), xyxy.device
    )
    return scores, class_ids, xyxy * scale.to(xyxy.dtype)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

_EMBEDDINGS = ("class_embedding", "position_embedding", "token_embedding")
_LECUN_TRUNC = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init with flax's initializer families: lecun_normal
    (truncated) for Dense/patch kernels, normal(0.02) for embeddings, zero
    biases, unit LayerNorm scales.  Not bit-identical to flax's draws."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _EMBEDDINGS:
            vals = torch.empty(p.shape).normal_(0.0, 0.02, generator=gen)
        elif leaf.endswith("kernel"):
            fan_in = math.prod(p.shape[:-1])
            std = math.sqrt(1.0 / fan_in) / _LECUN_TRUNC
            vals = torch.empty(p.shape)
            nn.init.trunc_normal_(vals, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        elif leaf == "scale":
            vals = torch.ones(p.shape)
        elif leaf.endswith("bias"):
            vals = torch.zeros(p.shape)
        else:
            raise ValueError(f"no initializer for parameter {name}")
        p.copy_(vals)
    return model


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.array(v, np.float32)  # a writable copy
    return out


def params_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's flax variables (``{"params": ...}``, leaves as numpy
    or jax arrays) -> a state dict for ``OwlViTDetector``.

    Names map one to one (``layers_3`` -> ``layers.3``), except that the
    separate q/k/v projections concatenate into the fused ``qkv_kernel``
    (D, 3D) and ``qkv_bias`` (3D,), columns [q | k | v].
    """
    flat = _flatten(variables["params"])
    state: Dict[str, torch.Tensor] = {}
    fused: Dict[str, Dict[str, np.ndarray]] = {}
    for key, arr in flat.items():
        key = re.sub(r"\blayers_(\d+)\b", r"layers.\1", key)
        m = re.match(r"(.*self_attn)\.([qkv])_proj\.(kernel|bias)$", key)
        if m:
            fused.setdefault(f"{m.group(1)}.qkv_{m.group(3)}", {})[m.group(2)] = arr
            continue
        state[key] = torch.from_numpy(arr)
    for key, parts in fused.items():
        qkv = np.concatenate([parts["q"], parts["k"], parts["v"]], axis=-1)
        state[key] = torch.from_numpy(np.ascontiguousarray(qkv))
    return state
