"""YOLO-World v2 open-vocabulary detector (port of ``tstar_tpu/models/yoloworld.py``).

The reference's evaluation detector (YOLO-World v2-XL): a YOLOv8 CSPDarknet
backbone with SPPF, a YOLOWorldPAFPN neck whose fusion blocks gate a branch
per head with ``sigmoid(max_text(embed . guide) / sqrt(head_c) + bias)``
against the text embeddings, and a decoupled head with a DFL box branch
and a BN contrastive class branch.  The text side is the CLIP text tower
(``models/owlvit.TextTower``) + projection + L2 normalize, run once per
video.  Every BatchNorm is folded into a per-channel ``bn_scale`` /
``bn_bias`` (the checkpoint converter, ``models/yolo_loader.py``, folds it).

Layouts at the public functions follow the reference: pixels (B, S, S, 3)
RGB in [0, 1]; logits (B, A, T) and boxes (B, A, 4) xyxy pixels, both f32.
Inside, activations are NCHW tensors in channels-last memory (the layout the
card's convolutions take in bf16), and conv weights are PyTorch's (O, I, k,
k); ``params_from_jax`` transposes the reference's HWIO kernels.

Rounding points kept from the flax model: every conv computes in the
model's dtype, its folded-BN affine and SiLU too; the MaxSigmoid gate runs
in f32 (the reference divides by a numpy scalar, which promotes it), and so
do the BN contrastive head, the DFL softmax and the box decode.  The
reference's convolutions pad "SAME" as XLA does: a stride-2 3x3 conv on an
even size pads one row and column after and none before (mmyolo pads one
on each side; ROADMAP "The reference's own faults"), and so does this port.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from tstar_tpu_torch.models.owlvit import _LECUN_TRUNC, TextConfig, TextTower, _flatten
from tstar_tpu_torch.models.transformer import Dense
from tstar_tpu_torch.ops.nms import batched_class_nms


@dataclasses.dataclass(frozen=True)
class YoloWorldConfig:
    # XL = yolov8-x scaled dims (deepen 1.0, widen 1.25)
    widths: Tuple[int, ...] = (80, 160, 320, 640, 640)   # stem + 4 stages
    depths: Tuple[int, ...] = (3, 6, 6, 3)               # bottlenecks a stage
    neck_depth: int = 3                                  # CSP blocks a fusion
    neck_embed: Tuple[int, int, int] = (160, 320, 320)
    neck_heads: Tuple[int, int, int] = (5, 10, 10)
    text_dim: int = 512           # guide channels == head embed dims
    reg_max: int = 16             # DFL bins
    strides: Tuple[int, ...] = (8, 16, 32)
    image_size: int = 640
    num_classes: int = 100        # only bounds the cls branch width
    score_threshold: float = 0.12
    nms_iou: float = 0.7
    max_dets: int = 50

    @property
    def cls_branch_width(self) -> int:
        return max(self.widths[2], min(self.num_classes, 100))

    @property
    def reg_branch_width(self) -> int:
        return max(self.widths[2] // 4, 16, self.reg_max * 4)

    @property
    def num_anchors(self) -> int:
        return sum((self.image_size // s) ** 2 for s in self.strides)


def yoloworld_xl() -> YoloWorldConfig:
    """The reference's production checkpoint architecture."""
    return YoloWorldConfig()


def yoloworld_small() -> YoloWorldConfig:
    """Tiny variant for tests (same graph, small dims)."""
    return YoloWorldConfig(
        widths=(16, 32, 64, 128, 128), depths=(1, 1, 1, 1), neck_depth=1,
        neck_embed=(32, 64, 64), neck_heads=(2, 4, 4), text_dim=64, image_size=160,
    )


def text_config(cfg: YoloWorldConfig, size: str) -> TextConfig:
    """The random-weight text tower of ``yolo-world-random`` at ``size``: the
    CLIP-base tower at the model's text width (tiny for ``small``)."""
    return TextConfig(
        hidden_size=cfg.text_dim,
        num_layers=2 if size == "small" else 12,
        num_heads=4 if size == "small" else 8,
        intermediate_size=4 * cfg.text_dim,
    )


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class ConvBN(nn.Module):
    """Conv (no bias) + folded-BN affine (+ SiLU), "SAME" padding."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, stride: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv(c_in, c_out, kernel, stride, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(c_out))
        self.bn_bias = nn.Parameter(torch.zeros(c_out))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        y = y * self.bn_scale.to(y.dtype)[:, None, None] + self.bn_bias.to(y.dtype)[:, None, None]
        return F.silu(y) if self.act else y


class Conv(nn.Module):
    """A conv with flax's "SAME" padding; weight (O, I, k, k)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.kernel, self.stride = kernel, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel, self.stride
        (top, bottom), (left, right) = (_same_pads(x.shape[2], k, s), _same_pads(x.shape[3], k, s))
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, s, (top, left))
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, s)


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.conv1 = ConvBN(c, c, 3)
        self.conv2 = ConvBN(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        h = self.conv2(self.conv1(x))
        return x + h if self.shortcut else h


class CSPLayer(nn.Module):
    """mmyolo CSPLayerWithTwoConv: split, bottlenecks, concat, fuse."""

    def __init__(self, c_in: int, c_out: int, depth: int, shortcut: bool = True):
        super().__init__()
        self.mid = c_out // 2
        self.main_conv = ConvBN(c_in, 2 * self.mid, 1)
        for i in range(depth):
            self.add_module(f"blocks_{i}", Bottleneck(self.mid, shortcut))
        self.depth = depth
        self.final_conv = ConvBN((2 + depth) * self.mid, c_out, 1)

    def _branches(self, x) -> List[torch.Tensor]:
        a, b = self.main_conv(x).split(self.mid, dim=1)
        outs = [a, b]
        for i in range(self.depth):
            b = getattr(self, f"blocks_{i}")(b)
            outs.append(b)
        return outs

    def forward(self, x):
        return self.final_conv(torch.cat(self._branches(x), dim=1))


class SPPF(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = ConvBN(c, c // 2, 1)
        self.conv2 = ConvBN(c // 2 * 4, c, 1)

    def forward(self, x):
        pools = [self.conv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.conv2(torch.cat(pools, dim=1))


class MaxSigmoidAttnBlock(nn.Module):
    """x (B, C_in, H, W) + guide (T, G) or per image (B, T, G) -> (B, C_out, H, W)."""

    def __init__(self, c_in: int, c_out: int, guide: int, embed: int, num_heads: int):
        super().__init__()
        self.num_heads, self.head_c = num_heads, embed // num_heads
        self.guide_fc = Dense(guide, embed)
        self.embed_conv = ConvBN(c_in, embed, 1, act=False) if embed != c_in else None
        self.bias = nn.Parameter(torch.zeros(num_heads))
        self.project_conv = ConvBN(c_in, c_out, 3, act=False)

    def forward(self, x, guide):
        m, c = self.num_heads, self.head_c
        g = self.guide_fc(guide.to(self.guide_fc.kernel.dtype))
        g = g.reshape(*g.shape[:-1], m, c)
        e = self.embed_conv(x) if self.embed_conv is not None else x
        b, _, h, w = e.shape
        e = e.permute(0, 2, 3, 1).reshape(b, h, w, m, c)
        if g.ndim == 3:
            logit = torch.einsum("bhwmc,tmc->bhwmt", e, g)
        else:
            logit = torch.einsum("bhwmc,btmc->bhwmt", e, g)
        logit = logit.amax(dim=-1).float() / math.sqrt(c)
        gate = torch.sigmoid(logit + self.bias.to(x.dtype).float())
        p = self.project_conv(x)
        c_out = p.shape[1]
        p = p.permute(0, 2, 3, 1).reshape(b, h, w, m, c_out // m).float() * gate[..., None]
        return p.reshape(b, h, w, c_out).permute(0, 3, 1, 2)


class MaxSigmoidCSPLayer(CSPLayer):
    """CSP whose fuse conv also sees the text-gated projection of the last
    block's output ((3 + depth) * mid inputs); blocks without shortcut."""

    def __init__(self, c_in, c_out, depth, guide, embed, num_heads):
        super().__init__(c_in, c_out, depth, shortcut=False)
        self.attn_block = MaxSigmoidAttnBlock(self.mid, self.mid, guide, embed, num_heads)
        self.final_conv = ConvBN((3 + depth) * self.mid, c_out, 1)

    def forward(self, x, guide):
        outs = self._branches(x)
        outs.append(self.attn_block(outs[-1], guide).to(x.dtype))
        return self.final_conv(torch.cat(outs, dim=1))


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YoloWorldDetector(nn.Module):
    def __init__(self, cfg: YoloWorldConfig):
        super().__init__()
        self.cfg = c = cfg
        w = c.widths
        self.stem = ConvBN(3, w[0], 3, 2)
        prev = w[0]
        for i, (width, depth) in enumerate(zip(w[1:], c.depths), start=1):
            self.add_module(f"stage{i}_down", ConvBN(prev, width, 3, 2))
            self.add_module(f"stage{i}_csp", CSPLayer(width, width, depth))
            prev = width
        self.sppf = SPPF(w[4])
        e, m, g, n = c.neck_embed, c.neck_heads, c.text_dim, c.neck_depth
        self.top_down0 = MaxSigmoidCSPLayer(w[4] + w[3], w[3], n, g, e[1], m[1])
        self.top_down1 = MaxSigmoidCSPLayer(w[3] + w[2], w[2], n, g, e[0], m[0])
        self.downsample0 = ConvBN(w[2], w[2], 3, 2)
        self.bottom_up0 = MaxSigmoidCSPLayer(w[2] + w[3], w[3], n, g, e[1], m[1])
        self.downsample1 = ConvBN(w[3], w[3], 3, 2)
        self.bottom_up1 = MaxSigmoidCSPLayer(w[3] + w[4], w[4], n, g, e[2], m[2])
        cls_w, reg_w = c.cls_branch_width, c.reg_branch_width
        for li, c_in in enumerate((w[2], w[3], w[4])):
            self.add_module(f"reg_pred{li}_0", ConvBN(c_in, reg_w, 3))
            self.add_module(f"reg_pred{li}_1", ConvBN(reg_w, reg_w, 3))
            self.add_module(f"reg_pred{li}_2", Conv(reg_w, 4 * c.reg_max, 1))
            self.add_module(f"cls_pred{li}_0", ConvBN(c_in, cls_w, 3))
            self.add_module(f"cls_pred{li}_1", ConvBN(cls_w, cls_w, 3))
            self.add_module(f"cls_pred{li}_2", Conv(cls_w, c.text_dim, 1))
            self.register_parameter(f"contrast{li}_bn_scale", nn.Parameter(torch.ones(c.text_dim)))
            self.register_parameter(f"contrast{li}_bn_bias", nn.Parameter(torch.zeros(c.text_dim)))
            self.register_parameter(f"contrast{li}_logit_scale", nn.Parameter(torch.tensor(-1.0)))
            self.register_parameter(f"contrast{li}_bias", nn.Parameter(torch.tensor(0.0)))

    def cast(self, dtype: torch.dtype) -> "YoloWorldDetector":
        """Every parameter in ``dtype`` but the contrastive head's, which stay
        f32: the reference keeps them f32 and applies them in f32."""
        for name, p in self.named_parameters():
            p.data = p.data.to(torch.float32 if name.startswith("contrast") else dtype)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.stem.conv.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.stem.conv.weight.device

    def forward(self, pixels: torch.Tensor, text_embeds: torch.Tensor):
        """pixels (B, S, S, 3) in [0, 1]; text (T, D), or (B, T, D) one set per
        image, L2-normalized projected CLIP embeddings -> (logits (B, A, T)
        f32 pre-sigmoid, boxes xyxy (B, A, 4) f32 in pixels)."""
        c = self.cfg
        guide = text_embeds.to(self.dtype)
        x = self.stem(pixels.to(self.dtype).permute(0, 3, 1, 2))
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"stage{i}_csp")(getattr(self, f"stage{i}_down")(x))
            if i == 4:
                x = self.sppf(x)
            if i >= 2:
                feats.append(x)
        p3, p4, p5 = feats
        t4 = self.top_down0(torch.cat([_upsample2(p5), p4], dim=1), guide)
        t3 = self.top_down1(torch.cat([_upsample2(t4), p3], dim=1), guide)
        b4 = self.bottom_up0(torch.cat([self.downsample0(t3), t4], dim=1), guide)
        b5 = self.bottom_up1(torch.cat([self.downsample1(b4), p5], dim=1), guide)

        text = text_embeds.float()
        text_n = text / (torch.linalg.vector_norm(text, dim=-1, keepdim=True) + 1e-12)
        bins = torch.arange(c.reg_max, dtype=torch.float32, device=pixels.device)
        all_logits, all_boxes = [], []
        for li, (feat, stride) in enumerate(zip((t3, b4, b5), c.strides)):
            dfl = getattr(self, f"reg_pred{li}_2")(
                getattr(self, f"reg_pred{li}_1")(getattr(self, f"reg_pred{li}_0")(feat)))
            emb = getattr(self, f"cls_pred{li}_2")(
                getattr(self, f"cls_pred{li}_1")(getattr(self, f"cls_pred{li}_0")(feat)))
            emb = emb.permute(0, 2, 3, 1).float()
            emb = emb * getattr(self, f"contrast{li}_bn_scale").float() + getattr(
                self, f"contrast{li}_bn_bias").float()
            if text_n.ndim == 3:
                logits = torch.einsum("bhwc,btc->bhwt", emb, text_n)
            else:
                logits = torch.einsum("bhwc,tc->bhwt", emb, text_n)
            logits = logits * torch.exp(getattr(self, f"contrast{li}_logit_scale").float()) + getattr(
                self, f"contrast{li}_bias").float()

            b, _, hh, ww = dfl.shape
            dist = dfl.permute(0, 2, 3, 1).reshape(b, hh, ww, 4, c.reg_max)
            ltrb = torch.einsum("bhwkr,r->bhwk", torch.softmax(dist.float(), dim=-1), bins)
            cy, cx = torch.meshgrid(
                torch.arange(hh, dtype=torch.float32, device=pixels.device) + 0.5,
                torch.arange(ww, dtype=torch.float32, device=pixels.device) + 0.5,
                indexing="ij",
            )
            boxes = torch.stack([(cx - ltrb[..., 0]) * stride, (cy - ltrb[..., 1]) * stride,
                                 (cx + ltrb[..., 2]) * stride, (cy + ltrb[..., 3]) * stride], dim=-1)
            all_logits.append(logits.reshape(b, hh * ww, -1))
            all_boxes.append(boxes.reshape(b, hh * ww, 4))
        return torch.cat(all_logits, dim=1), torch.cat(all_boxes, dim=1)


class YoloTextEncoder(nn.Module):
    """HuggingCLIPLanguageBackbone: CLIP text tower + projection + L2 norm."""

    def __init__(self, text_cfg: TextConfig, projection_dim: int = 512):
        super().__init__()
        self.text_cfg = text_cfg
        self.text = TextTower(text_cfg)
        self.text_projection = Dense(text_cfg.hidden_size, projection_dim, use_bias=False)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(Q, S) ids -> (Q, projection_dim) f32, L2-normalized."""
        proj = self.text_projection(self.text(input_ids, attention_mask)).float()
        return proj / (torch.linalg.vector_norm(proj, dim=-1, keepdim=True) + 1e-12)


def postprocess_yolo(
    logits: torch.Tensor,       # (B, A, T)
    boxes: torch.Tensor,        # (B, A, 4)
    query_mask: Optional[torch.Tensor],   # (T,), or (B, T) one per image
    score_threshold: float = 0.12,
    nms_iou: float = 0.7,
    max_dets: int = 50,
):
    """-> (scores (B, max_dets), class_ids, boxes_xyxy, keep mask): sigmoid
    scores, the score threshold, class-aware NMS, the first ``max_dets``."""
    if query_mask is not None:
        mask = query_mask[:, None, :] if query_mask.ndim == 2 else query_mask[None, None, :]
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.sigmoid(logits)
    scores = probs.amax(dim=-1)
    class_ids = torch.argmax(probs, dim=-1).to(torch.int32)
    s = torch.where(scores > score_threshold, scores, torch.zeros_like(scores))
    keep, valid = batched_class_nms(boxes, s, class_ids, nms_iou, max_dets)
    idx = keep.long()
    out_s = s.gather(1, idx) * valid
    out_c = class_ids.gather(1, idx)
    out_b = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    return out_s, out_c, out_b, valid & (out_s > score_threshold)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init with flax's initializer families: lecun_normal
    (truncated) for conv weights and Dense kernels, normal(0.02) for
    embeddings, zero biases, unit LayerNorm and BN scales, logit scales -1.
    Not bit-identical to flax's draws."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("token_embedding", "position_embedding"):
            vals = torch.empty(p.shape).normal_(0.0, 0.02, generator=gen)
        elif leaf in ("weight", "kernel", "qkv_kernel"):
            fan_in = math.prod(p.shape[1:]) if leaf == "weight" else p.shape[0]
            std = math.sqrt(1.0 / fan_in) / _LECUN_TRUNC
            vals = torch.empty(p.shape)
            nn.init.trunc_normal_(vals, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        elif leaf in ("scale", "bn_scale") or leaf.endswith("_bn_scale"):
            vals = torch.ones(p.shape)
        elif leaf.endswith("logit_scale"):
            vals = torch.full(p.shape, -1.0)
        elif leaf.endswith("bias"):
            vals = torch.zeros(p.shape)
        else:
            raise ValueError(f"no initializer for parameter {name}")
        p.copy_(vals)
    return model


@torch.no_grad()
def unit_variance_bn_(model: YoloWorldDetector, pixels: torch.Tensor, text: torch.Tensor):
    """Set each ConvBN's folded scale so that its conv output has unit
    variance on ``pixels`` (bias 0), in one forward: at its first use in
    the forward, each ConvBN's scale is set from its conv's output before
    the scale is applied, so every layer sees the ones before it already
    set.  Seeded random convs without trained BN statistics shrink the
    activations layer by layer, until every anchor's score is 0.5 to a few
    f32 ulps and every decision downstream (class, NMS order) is a tie.
    For numerical checks on random weights; a checkpoint's BN statistics do
    this."""
    done = set()

    def calibrate(m: ConvBN):
        def hook(mod, inputs, out):
            if m not in done:
                done.add(m)
                m.bn_scale.copy_(1.0 / out.float().std().clamp_min(1e-12))
                m.bn_bias.zero_()
        return hook

    hooks = [m.conv.register_forward_hook(calibrate(m))
             for m in model.modules() if isinstance(m, ConvBN)]
    try:
        with torch.no_grad():
            model(pixels, text)
    finally:
        for h in hooks:
            h.remove()
    return model


def params_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's flax detector variables (``{"params": ...}``, leaves as
    numpy or jax arrays) -> a state dict for ``YoloWorldDetector``: names map
    one to one, conv kernels (HWIO) become ``weight`` (OIHW)."""
    state: Dict[str, torch.Tensor] = {}
    for key, arr in _flatten(variables["params"]).items():
        if key.endswith(".kernel") and arr.ndim == 4:
            key = key[: -len("kernel")] + "weight"
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        state[key] = torch.from_numpy(arr)
    return state


def text_config_from_state(state: Mapping[str, torch.Tensor]) -> TextConfig:
    """The CLIP text config a ``YoloTextEncoder`` state dict was made for.
    Heads are not recoverable from fused projections; CLIP towers use
    64-wide heads (floored at 1 for tiny towers), as the reference infers."""
    vocab, hidden = state["text.token_embedding"].shape
    layers = {int(m.group(1)) for k in state
              for m in [re.match(r"text\.encoder\.layers\.(\d+)\.", k)] if m}
    return TextConfig(
        vocab_size=int(vocab), hidden_size=int(hidden), num_layers=len(layers),
        num_heads=max(1, int(hidden) // 64),
        intermediate_size=int(state["text.encoder.layers.0.mlp.fc1.kernel"].shape[1]),
        max_length=int(state["text.position_embedding"].shape[0]),
    )
