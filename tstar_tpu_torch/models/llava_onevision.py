"""LLaVA-OneVision (port of ``tstar_tpu/models/llava_onevision.py``): SigLIP
tower + projector + Qwen2 LM.  The video path is the one T*'s grounding and
QA take:

  * SigLIP per frame (``models/siglip.py``; its LayerNorms run K3);
  * a 2-layer GELU projector;
  * bilinear 2x token pooling per frame (27 -> 14 a side at 384 px, HF
    ``apply_pooling``; the reference's ``jax.image.resize`` without
    antialiasing, here the interpolation matrices of ``kernels/image.py``,
    which take the same half-pixel samples), the frames concatenated and one
    ``image_newline`` vector appended;
  * the Qwen2 decoder of ``models/qwen2vl.py`` under plain 1-D RoPE (M-RoPE
    with one full-width section).

The single-image anyres path (HF ``pack_image_features`` and
``get_image_patches``): ``preprocess_anyres_image`` picks the grid pinpoint
canvas (``select_best_resolution``), resizes the image into it (aspect
kept, centered on zero padding) and cuts it into vision-size tiles after a
squashed base tile, the bicubic resizes by ``qwen2vl_processor.resize_cubic``
(OpenCV's, as the reference's ``cv2.resize``); ``encode_anyres_image``
encodes the tiles in one batch, reassembles the tile grid, unpads it to the
image's aspect, downscales it above the token budget with the same
interpolation matrices as the video pooling, and appends an
``image_newline`` to every row.  No grounding or QA call reaches it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from tstar_tpu_torch.kernels.image import bilinear_resize
from tstar_tpu_torch.models.convert import Rule, convert_state_dict, rule
from tstar_tpu_torch.models.qwen2vl import Qwen2LM, Qwen2VLTextConfig, build_mrope_position_ids, lm_rules
from tstar_tpu_torch.models.qwen2vl import params_from_jax  # noqa: F401  (the reference's flax variables)
from tstar_tpu_torch.models.siglip import SiglipVisionConfig, SiglipVisionTower, siglip_rules
from tstar_tpu_torch.models.transformer import Dense


@dataclasses.dataclass(frozen=True)
class LlavaOnevisionConfig:
    vision: SiglipVisionConfig = dataclasses.field(default_factory=SiglipVisionConfig)
    text: Qwen2VLTextConfig = dataclasses.field(
        default_factory=lambda: Qwen2VLTextConfig(mrope_section=(64, 0, 0))
    )
    image_token_id: int = 151646
    video_token_id: int = 151647
    vision_feature_layer: int = -1
    vision_feature_select_strategy: str = "full"
    projector_bias: bool = True

    @property
    def tokens_per_frame(self) -> int:
        side = self.vision.image_size // self.vision.patch_size
        pooled = -(-side // 2)
        return pooled * pooled


class LlavaOnevisionModel(Qwen2LM):
    """The method surface of ``Qwen2VLModel``, so ``models/generate.py`` runs
    both; ``encode_images`` takes frame pixels and ignores ``grid_hw``."""

    def __init__(self, cfg: LlavaOnevisionConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        self.vision_tower = SiglipVisionTower(cfg.vision)
        self.projector_linear_1 = Dense(cfg.vision.hidden_size, t.hidden_size, cfg.projector_bias)
        self.projector_linear_2 = Dense(t.hidden_size, t.hidden_size, cfg.projector_bias)
        self.image_newline = nn.Parameter(torch.empty(t.hidden_size))
        self._init_lm(t)

    def _pool_tokens(self, feats: torch.Tensor) -> torch.Tensor:
        """Per-frame bilinear 2x pooling in f32, rounded back."""
        side = self.cfg.vision.image_size // self.cfg.vision.patch_size
        f, _, d = feats.shape
        out = -(-side // 2)
        pooled = bilinear_resize(feats.reshape(f, side, side, d), (out, out))
        return pooled.reshape(f, out * out, d).to(feats.dtype)

    def encode_images(self, frames: torch.Tensor, grid_hw=None) -> torch.Tensor:
        """(F, S, S, 3) normalized frames -> (1, F * pooled + 1, hidden): the
        video-token stream with its trailing ``image_newline``."""
        del grid_hw
        feats = self._project(frames)
        flat = self._pool_tokens(feats).reshape(-1, feats.shape[-1])
        return torch.cat([flat, self.image_newline.to(flat.dtype)[None]], dim=0)[None]

    def _project(self, pixels: torch.Tensor) -> torch.Tensor:
        feats = self.vision_tower(pixels, self.cfg.vision_feature_layer)
        if self.cfg.vision_feature_select_strategy == "default":
            feats = feats[:, 1:]
        return self.projector_linear_2(F.gelu(self.projector_linear_1(feats), approximate="none"))

    def encode_anyres_image(
        self,
        tiles: torch.Tensor,              # (1 + n_tiles, S, S, 3): the base tile FIRST
        image_size: Tuple[int, int],      # the image's (H, W)
        grid_shape: Tuple[int, int],      # (tiles down, tiles across)
        max_num_patches: int = 9,         # "anyres_max_9"
    ) -> torch.Tensor:
        """The anyres single-image path -> (tokens, hidden): the base tile's
        features, then the tile grid reassembled, unpadded to the image's
        aspect, downscaled (bilinear, in f32, rounded back) when above
        ``max_num_patches`` tiles' worth of tokens, with an ``image_newline``
        after every row."""
        feats = self._project(tiles)
        base = feats[0]
        side = self.cfg.vision.image_size // self.cfg.vision.patch_size
        nph, npw = grid_shape
        d = feats.shape[-1]
        grid = (feats[1:].reshape(nph, npw, side, side, d).permute(0, 2, 1, 3, 4)
                .reshape(nph * side, npw * side, d))
        # unpad to the image's aspect (HF unpad_image)
        oh, ow = image_size
        ch, cw = grid.shape[:2]
        if ow / oh > cw / ch:
            pad = (ch - int(oh * (cw / ow))) // 2
            grid = grid[pad:ch - pad]
        else:
            pad = (cw - int(ow * (ch / oh))) // 2
            grid = grid[:, pad:cw - pad]
        ch, cw = grid.shape[:2]
        ratio = math.sqrt(ch * cw / (max_num_patches * side ** 2))
        if ratio > 1.1:
            grid = bilinear_resize(grid, (int(ch // ratio), int(cw // ratio))).to(feats.dtype)
        newline = self.image_newline.to(grid.dtype).expand(grid.shape[0], 1, d)
        grid = torch.cat([grid, newline], dim=1)
        return torch.cat([base, grid.reshape(-1, d)], dim=0)

    def embed(self, input_ids: torch.Tensor, image_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        return self._scatter(input_ids, image_embeds, self.cfg.video_token_id)

    def forward(self, input_ids, position_ids, attention_mask=None, video_frames=None,
                grid_hw=None) -> torch.Tensor:
        embeds = None
        if video_frames is not None:
            enc = self.encode_images(video_frames)
            embeds = enc.reshape(-1, enc.shape[-1])
        return self._full_forward(input_ids, position_ids, attention_mask, embeds,
                                  self.cfg.video_token_id)


# ---------------------------------------------------------------------------
# Input preparation (processor + chat template)
# ---------------------------------------------------------------------------

SIGLIP_MEAN = 0.5
SIGLIP_STD = 0.5


def preprocess_frames_llava(frames: Sequence[np.ndarray], cfg: LlavaOnevisionConfig) -> np.ndarray:
    """Frames (HxWx3 uint8) -> (F, S, S, 3) SigLIP-normalized f32, each
    resized as ``cv2.resize(..., INTER_CUBIC)`` (``resize_cubic``)."""
    from tstar_tpu_torch.models.qwen2vl_processor import resize_cubic

    s = cfg.vision.image_size
    out = []
    for f in frames:
        r = resize_cubic(np.asarray(f), (s, s))
        out.append((r.astype(np.float32) / 255.0 - SIGLIP_MEAN) / SIGLIP_STD)
    return np.stack(out)


def select_best_resolution(original_hw, possible_resolutions) -> Tuple[int, int]:
    """The (h, w) pinpoint that keeps the most of the image's resolution,
    then wastes the least canvas (HF ``select_best_resolution``)."""
    oh, ow = original_hw
    best, best_eff, best_waste = None, 0, float("inf")
    for h, w in possible_resolutions:
        scale = min(w / ow, h / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (h, w), eff, waste
    return best


def preprocess_anyres_image(image: np.ndarray, cfg: LlavaOnevisionConfig, grid_pinpoints):
    """(H, W, 3) uint8 RGB -> (tiles (1 + n, S, S, 3) SigLIP-normalized f32,
    the image's (H, W), the grid (tiles down, across)) for
    ``encode_anyres_image`` (HF ``get_image_patches``): the best pinpoint
    canvas, the image resized into it with its aspect kept and centered on
    zero padding, cut into S x S tiles after the whole image squashed to
    S x S (the base tile)."""
    from tstar_tpu_torch.models.qwen2vl_processor import resize_cubic

    s = cfg.vision.image_size
    oh, ow = image.shape[:2]
    th, tw = select_best_resolution((oh, ow), grid_pinpoints)
    # HF get_patch_output_size: the tighter axis meets the canvas exactly
    if tw / ow < th / oh:
        nw, nh = tw, min(int(np.ceil(oh * (tw / ow))), th)
    else:
        nh, nw = th, min(int(np.ceil(ow * (th / oh))), tw)
    canvas = np.zeros((th, tw, 3), image.dtype)
    top, left = (th - nh) // 2, (tw - nw) // 2
    canvas[top:top + nh, left:left + nw] = resize_cubic(image, (nh, nw))

    def norm(img):
        return (img.astype(np.float32) / 255.0 - SIGLIP_MEAN) / SIGLIP_STD

    nph, npw = th // s, tw // s
    tiles = [norm(resize_cubic(image, (s, s)))]
    for r in range(nph):
        for c in range(npw):
            tiles.append(norm(canvas[r * s:(r + 1) * s, c * s:(c + 1) * s]))
    return np.stack(tiles), (oh, ow), (nph, npw)


def prepare_llava_inputs(tokenizer, query: str, frames, cfg: LlavaOnevisionConfig) -> Dict:
    """-> ``generate`` inputs (host numpy); the frames enter as ONE video
    block (the LLaVA-OV video path), wherever ``<image>`` tags sit."""
    n_frames = len(frames)
    text = query.replace("<image>", "").strip()
    if n_frames:
        n_tokens = n_frames * cfg.tokens_per_frame + 1   # + image_newline
        video_block = "<video>" + "\n"
    else:
        n_tokens = 0
        video_block = ""
    chat = (
        "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        f"<|im_start|>user\n{video_block}{text}<|im_end|>\n"
        "<|im_start|>assistant\n"
    )
    parts = chat.split("<video>")
    ids: List[int] = list(tokenizer.encode(parts[0]))
    if len(parts) > 1:
        ids.extend([cfg.video_token_id] * n_tokens)
        ids.extend(tokenizer.encode(parts[1]))
    ids_np = np.asarray(ids, np.int32)[None]
    pos = build_mrope_position_ids(ids_np[0], -1, [], 2)[:, None]   # plain rope
    pixels = preprocess_frames_llava(frames, cfg) if n_frames else None
    return {
        "input_ids": ids_np,
        "prompt_lens": np.asarray([ids_np.shape[1]], np.int32),
        "position_ids": pos,
        "image_patches": pixels,
        "image_grid_hw": None,
    }


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def llava_rules(cfg: LlavaOnevisionConfig) -> List[Rule]:
    def proj(port, hf):
        out = [rule(f"{port}.kernel", f"{hf}.weight", kind="T")]
        return out + ([rule(f"{port}.bias", f"{hf}.bias")] if cfg.projector_bias else [])

    return [
        *siglip_rules(cfg.vision, "model.vision_tower.vision_model.", port="vision_tower."),
        *proj("projector_linear_1", "model.multi_modal_projector.linear_1"),
        *proj("projector_linear_2", "model.multi_modal_projector.linear_2"),
        rule("image_newline", "model.image_newline"),
        *lm_rules(cfg.text),
    ]


def convert_hf_llava_onevision_state_dict(
    sd: Mapping[str, torch.Tensor], cfg: LlavaOnevisionConfig
) -> Dict[str, torch.Tensor]:
    """HF ``LlavaOnevisionForConditionalGeneration`` state dict -> a state
    dict for ``LlavaOnevisionModel``."""
    return convert_state_dict(sd, llava_rules(cfg))
