"""Plain float32 OWL-ViT (Minderer et al. 2022, "Simple Open-Vocabulary
Object Detection with Vision Transformers"; Hugging Face
``OwlViTForObjectDetection``), written from the published architecture.

A weights dict, names as in ``BENCHMARK``'s weight list: dense kernels are
(in, out), the patch kernel (p, p, 3, D), the q|k|v projections one (D, 3D)
kernel with columns [q | k | v].  Plain ``torch`` only; it imports nothing
of the program.

The search's use of the detector is here too: the 4 x 4 grid canvas and the
verification image built from the uint8 frame cache (cv2 INTER_LINEAR
resampling: half-pixel centres, edge clamp, no antialiasing; CLIP
normalisation), the post-processing (best query, its sigmoid, boxes), and
the per-cell confidence: the largest class-weighted score of the boxes whose
centre falls in the cell and that pass the detector threshold.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.nn import functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _layer_norm(x, w: Mapping, prefix: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), w[prefix + ".scale"], w[prefix + ".bias"], eps)


def _mm(a, b, cast=None):
    """a @ b; with ``cast``, of both operands as ``cast`` rounds them."""
    return a @ b if cast is None else cast(a) @ cast(b)


def _dense(x, w: Mapping, prefix: str, cast=None):
    y = _mm(x, w[prefix + ".kernel"], cast)
    bias = w.get(prefix + ".bias")
    return y if bias is None else y + bias


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale that maps its
    largest magnitude to the format's largest, as fp8 matrix products take
    their operands; returned in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def encoder(x, w: Mapping, prefix: str, layers: int, heads: int, eps: float,
            mask: Optional[torch.Tensor] = None, cast=None):
    """Pre-norm layers: x += attn(ln1(x)); x += mlp(ln2(x)); ``mask`` (B, 1,
    S, S) bool, True where a query may attend; ``cast`` rounds the operands
    of each projection (``_mm``)."""
    b, s, d = x.shape
    hd = d // heads
    for i in range(layers):
        p = f"{prefix}.layers.{i}"
        h = _layer_norm(x, w, p + ".layer_norm1", eps)
        qkv = _mm(h, w[p + ".self_attn.qkv_kernel"], cast) + w[p + ".self_attn.qkv_bias"]
        q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2) for t in qkv.split(d, dim=-1))
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        att = torch.softmax(logits, dim=-1) @ v
        x = x + _dense(att.transpose(1, 2).reshape(b, s, d), w, p + ".self_attn.out_proj", cast)
        h = _layer_norm(x, w, p + ".layer_norm2", eps)
        x = x + _dense(quick_gelu(_dense(h, w, p + ".mlp.fc1", cast)), w, p + ".mlp.fc2", cast)
    return x


def image_features(pixels: torch.Tensor, w: Mapping, cfg: Mapping, cast=None) -> torch.Tensor:
    """(B, H, W, 3) CLIP-normalised pixels -> merged patch features (B, P, D)."""
    v = cfg["vision_config"]
    eps = v["layer_norm_eps"]
    kernel = w["vision.patch_embedding.kernel"].permute(3, 2, 0, 1)     # (D, 3, p, p)
    px = pixels.permute(0, 3, 1, 2)
    if cast is not None:
        px, kernel = cast(px), cast(kernel)
    x = F.conv2d(px, kernel, stride=v["patch_size"])
    x = x.flatten(2).transpose(1, 2)                                    # (B, P, D)
    cls = w["vision.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + w["vision.position_embedding"][None]
    x = _layer_norm(x, w, "vision.pre_layernorm", eps)
    x = encoder(x, w, "vision.encoder", v["num_hidden_layers"], v["num_attention_heads"], eps,
                cast=cast)
    x = _layer_norm(x, w, "post_layernorm", eps)
    return _layer_norm(x[:, 1:] * x[:, :1], w, "merged_layernorm", eps)


def text_queries(ids: torch.Tensor, mask: torch.Tensor, w: Mapping, cfg: Mapping,
                 cast=None) -> torch.Tensor:
    """(Q, S) token ids and 0/1 mask -> L2-normalised query embeddings."""
    t = cfg["text_config"]
    eps = t["layer_norm_eps"]
    q, s = ids.shape
    x = w["text.token_embedding"][ids.long()] + w["text.position_embedding"][None, :s]
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=ids.device))
    allowed = causal[None, None] & (mask[:, None, None, :] > 0)
    x = encoder(x, w, "text.encoder", t["num_hidden_layers"], t["num_attention_heads"], eps,
                allowed, cast)
    x = _layer_norm(x, w, "text.final_layer_norm", eps)
    pooled = x[torch.arange(q, device=ids.device), ids.long().argmax(dim=-1)]
    proj = _mm(pooled, w["text_projection.kernel"], cast)
    return proj / proj.norm(dim=-1, keepdim=True)


def detect(feats: torch.Tensor, queries: torch.Tensor, query_mask: torch.Tensor,
           w: Mapping, image_size: int, patch_size: int, cast=None):
    """The heads -> (class logits (B, P, Q), masked queries at -inf; box
    centres in pixels (B, P, 2))."""
    img = _dense(feats, w, "class_head.dense0", cast)
    img = img / (img.norm(dim=-1, keepdim=True) + 1e-6)
    q = queries / (queries.norm(dim=-1, keepdim=True) + 1e-6)
    logits = img @ q.transpose(-1, -2) if q.ndim == 2 else torch.einsum("bpd,bqd->bpq", img, q)
    shift = _dense(feats, w, "class_head.logit_shift", cast)
    scale = F.elu(_dense(feats, w, "class_head.logit_scale", cast)) + 1.0
    logits = (logits + shift) * scale
    qm = query_mask if query_mask.ndim == 2 else query_mask[None]
    logits = logits.masked_fill(~qm[:, None, :], float("-inf"))
    h = F.gelu(_dense(feats, w, "box_head.dense0", cast))
    h = F.gelu(_dense(h, w, "box_head.dense1", cast))
    side = image_size // patch_size
    grid = torch.arange(1, side + 1, dtype=torch.float32, device=feats.device) / side
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    centres = torch.stack([xx, yy], dim=-1).reshape(-1, 2).clamp(0.0, 1.0)
    bias_c = torch.log(centres + 1e-4) - torch.log1p(-centres + 1e-4)
    size = torch.full_like(centres, 1.0 / side)
    bias_s = torch.log(size + 1e-4) - torch.log1p(-size + 1e-4)
    boxes = torch.sigmoid(_dense(h, w, "box_head.dense2", cast) + torch.cat([bias_c, bias_s], -1))
    return logits, boxes[..., :2] * image_size


def resize_bilinear(frames: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(K, h, w, 3) uint8 -> (K, H, W, 3) float32, cv2 INTER_LINEAR."""
    x = frames.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1)


def clip_normalise(pixels: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(CLIP_MEAN, device=pixels.device)
    std = torch.tensor(CLIP_STD, device=pixels.device)
    return (pixels / 255.0 - mean) / std


def grid_canvas(frames: torch.Tensor, rows: int, cols: int, size: int) -> torch.Tensor:
    """(rows*cols, h, w, 3) uint8 frames -> one (1, size, size, 3) canvas,
    cell k (row-major) holding frame k."""
    ch, cw = size // rows, size // cols
    cells = clip_normalise(resize_bilinear(frames, (ch, cw)))
    return cells.reshape(rows, cols, ch, cw, 3).permute(0, 2, 1, 3, 4).reshape(1, size, size, 3)


def cell_confidence_bounds(logits, centres, class_weights, threshold: float, rows: int,
                           cols: int, size: int, tie: float, edge: float):
    """(B, P, Q) class logits and (B, P, 2) box centres of B images -> the
    (low, high) bounds of each cell's confidence, (B, rows*cols) each.

    A cell's confidence is the largest class-weighted score (the sigmoid of
    the box's best logit, times the weight of its best query) of the boxes
    whose centre falls in the cell and whose score passes ``threshold``;
    0 where none does.  Under rounding a box's best query may be any query
    whose logit lies within ``tie`` of the best, and a centre within
    ``edge`` pixels of a cell's border may fall on either side: the high
    bound takes the largest weight and every cell a box may fall in, the low
    bound the smallest weight and only the boxes that fall in one cell."""
    best = logits.amax(dim=-1)
    score = torch.sigmoid(best)
    near = logits >= best[..., None] - tie
    cw = class_weights if class_weights.ndim == 2 else class_weights[None]
    cw = cw[:, None, :].expand_as(logits)
    w_hi = torch.where(near, cw, torch.full_like(cw, -1.0)).amax(dim=-1)
    w_lo = torch.where(near, cw, torch.full_like(cw, 2.0)).amin(dim=-1)
    keep = score > threshold
    v_hi = torch.where(keep, score * w_hi, torch.zeros_like(score))
    v_lo = torch.where(keep, score * w_lo, torch.zeros_like(score))

    def cell(coord, d, n, cells):
        return torch.floor((coord + d) / (size / cells)).long().clamp(0, n - 1)

    x, y = centres[..., 0], centres[..., 1]
    gx = (cell(x, -edge, cols, cols), cell(x, edge, cols, cols))
    gy = (cell(y, -edge, rows, rows), cell(y, edge, rows, rows))
    b = score.shape[0]
    hi = torch.zeros(b, rows * cols, device=score.device)
    for yy in gy:
        for xx in gx:
            hi = hi.scatter_reduce(1, yy * cols + xx, v_hi, reduce="amax", include_self=True)
    sure = (gx[0] == gx[1]) & (gy[0] == gy[1])
    lo = torch.zeros(b, rows * cols, device=score.device).scatter_reduce(
        1, gy[0] * cols + gx[0], torch.where(sure, v_lo, torch.zeros_like(v_lo)),
        reduce="amax", include_self=True)
    return lo, hi


def to_float32(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in weights.items()}
