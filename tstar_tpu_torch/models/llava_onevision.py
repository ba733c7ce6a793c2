"""LLaVA-OneVision's video path (port of ``tstar_tpu/models/llava_onevision.py``):
SigLIP tower + projector + Qwen2 LM, the path T*'s grounding and QA take.

  * SigLIP per frame (``models/siglip.py``; its LayerNorms run K3);
  * a 2-layer GELU projector;
  * bilinear 2x token pooling per frame (27 -> 14 a side at 384 px, HF
    ``apply_pooling``; the reference's ``jax.image.resize`` without
    antialiasing, here the interpolation matrices of ``kernels/image.py``,
    which take the same half-pixel samples), the frames concatenated and one
    ``image_newline`` vector appended;
  * the Qwen2 decoder of ``models/qwen2vl.py`` under plain 1-D RoPE (M-RoPE
    with one full-width section).

The single-image anyres path (``encode_anyres_image``,
``preprocess_anyres_image``) is not ported (ROADMAP queue 1 item 8): no
grounding or QA call reaches it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

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
        feats = self.vision_tower(frames, self.cfg.vision_feature_layer)
        if self.cfg.vision_feature_select_strategy == "default":
            feats = feats[:, 1:]
        feats = self.projector_linear_2(F.gelu(self.projector_linear_1(feats), approximate="none"))
        flat = self._pool_tokens(feats).reshape(-1, feats.shape[-1])
        return torch.cat([flat, self.image_newline.to(flat.dtype)[None]], dim=0)[None]

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
