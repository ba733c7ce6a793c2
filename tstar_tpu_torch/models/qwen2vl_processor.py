"""Qwen2-VL input processing (port of ``tstar_tpu/models/qwen2vl_processor.py``):
images -> patches, chat prompt -> token ids, all on the host.

* ``smart_resize``: (h, w) snapped to multiples of patch * merge (28) within
  a pixel budget, aspect kept (HF image_processing_qwen2_vl.py);
* ``resize_cubic``: the reference's ``cv2.resize(..., INTER_CUBIC)`` on
  uint8 frames, without OpenCV;
* CLIP mean/std normalization and patch flattening in (grid_t, h-block,
  w-block, merge, merge) raster order, channel-temporal-major rows: the
  layout ``Qwen2VLVisionTower`` and its rotary table expect;
* the Qwen chat template with one
  ``<|vision_start|><|image_pad|>*N<|vision_end|>`` block per frame.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tstar_tpu_torch.kernels.image import CLIP_MEAN, CLIP_STD
from tstar_tpu_torch.models.qwen2vl import Qwen2VLVisionConfig, build_mrope_position_ids
from tstar_tpu_torch.models.qwen_tokenizer import SPECIAL_TOKENS, QwenTokenizer


def _cubic_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_out, 4) source indices (border replicated) and f32 weights of
    OpenCV's bicubic (a = -0.75, half-pixel centers)."""
    scale = 1.0 / (n_out / n_in)
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f)
    x = f - s
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None], 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], -1).astype(np.float32)


def resize_cubic(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8, as ``cv2.resize(image, (w, h),
    interpolation=cv2.INTER_CUBIC)`` computes it in OpenCV 5: separable
    4-tap passes (rows first) with float32 weights and sums, border
    replicated, rounded half to even and saturated.  Against cv2 5.0 it is
    equal on all but ~1e-5 of the values, which are 1 off
    (``tests/test_torch_vlm_preprocess.py``); OpenCV 4's 11-bit fixed-point
    weights were 1 off on ~4% of them."""
    h, w = out_hw
    src = np.asarray(image)
    if src.shape[:2] == (h, w):
        return src.copy()
    xi, xc = _cubic_taps(src.shape[1], w)
    yi, yc = _cubic_taps(src.shape[0], h)
    taps = src.astype(np.float32)[:, xi]                  # (H, w, 4, C)
    rows = taps[:, :, 0] * xc[None, :, 0, None]
    for k in range(1, 4):
        rows = rows + taps[:, :, k] * xc[None, :, k, None]
    taps = rows[yi]                                        # (h, 4, w, C)
    out = taps[:, 0] * yc[:, 0, None, None]
    for k in range(1, 4):
        out = out + taps[:, k] * yc[:, k, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = 56 * 56,
    max_pixels: int = 14 * 14 * 4 * 1280,
) -> Tuple[int, int]:
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess_image(
    image: np.ndarray,            # (H, W, 3) uint8 RGB
    cfg: Qwen2VLVisionConfig,
    target_hw: Optional[Tuple[int, int]] = None,
    max_pixels: Optional[int] = None,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """-> (flattened patches (P, patch_dim) f32, (grid_h, grid_w))."""
    factor = cfg.patch_size * cfg.spatial_merge_size
    if target_hw is None:
        kwargs = {} if max_pixels is None else {"max_pixels": max_pixels}
        target_hw = smart_resize(image.shape[0], image.shape[1], factor, **kwargs)
    h, w = target_hw
    resized = resize_cubic(image, (h, w))
    x = (resized.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    x = x.transpose(2, 0, 1)                      # (C, H, W)

    tp, p, m = cfg.temporal_patch_size, cfg.patch_size, cfg.spatial_merge_size
    frames = np.broadcast_to(x, (tp, *x.shape))   # still images repeat temporally
    grid_t = 1
    grid_h, grid_w = h // p, w // p
    patches = frames.reshape(grid_t, tp, 3, grid_h // m, m, p, grid_w // m, m, p)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * grid_h * grid_w, 3 * tp * p * p)
    return np.ascontiguousarray(flat), (grid_h, grid_w)


def preprocess_frames(
    frames: Sequence[np.ndarray],
    cfg: Qwen2VLVisionConfig,
    max_pixels: int = 448 * 448,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Equal-size frames -> (N, P, patch_dim) with one shared grid."""
    if not len(frames):
        raise ValueError("no frames")
    factor = cfg.patch_size * cfg.spatial_merge_size
    target = smart_resize(frames[0].shape[0], frames[0].shape[1], factor, max_pixels=max_pixels)
    outs = [preprocess_image(np.asarray(f), cfg, target_hw=target) for f in frames]
    return np.stack([o[0] for o in outs]), outs[0][1]


def build_chat_prompt(
    tokenizer: QwenTokenizer,
    query: str,
    num_images: int,
    merged_tokens_per_image: int,
    system_message: str = "You are a helpful assistant.",
) -> List[int]:
    """The Qwen chat template with the query's ``<image>`` tags expanded to
    vision-token blocks; images no tag refers to are appended."""
    img_block = "<|vision_start|>" + "<|image_pad|>" * merged_tokens_per_image + "<|vision_end|>"
    parts = query.split("<image>")
    content = ""
    for i, part in enumerate(parts):
        content += part
        if i < len(parts) - 1:
            content += img_block if i < num_images else ""
    used = min(len(parts) - 1, num_images)
    for _ in range(num_images - used):
        content += img_block
    text = (
        f"<|im_start|>system\n{system_message}<|im_end|>\n"
        f"<|im_start|>user\n{content}<|im_end|>\n"
        f"<|im_start|>assistant\n"
    )
    return tokenizer.encode(text)


def prepare_vlm_inputs(
    tokenizer: QwenTokenizer,
    query: str,
    frames: Sequence[np.ndarray],
    vision_cfg: Qwen2VLVisionConfig,
    max_pixels: int = 448 * 448,
    image_token_id: int = SPECIAL_TOKENS["<|image_pad|>"],
):
    """-> dict(input_ids (1, S), prompt_lens, position_ids (3, 1, S),
    image_patches (N, P, D) | None, image_grid_hw), host numpy."""
    if len(frames):
        patches, grid_hw = preprocess_frames(frames, vision_cfg, max_pixels)
        m = vision_cfg.spatial_merge_size
        merged = (grid_hw[0] // m) * (grid_hw[1] // m)
    else:
        patches, grid_hw, merged = None, None, 0
    ids = build_chat_prompt(tokenizer, query, len(frames), merged)
    ids_np = np.asarray(ids, np.int32)[None]
    grids = [(1, *grid_hw)] * len(frames) if grid_hw else []
    pos = build_mrope_position_ids(ids_np[0], image_token_id, grids, vision_cfg.spatial_merge_size)[:, None]
    return {
        "input_ids": ids_np,
        "prompt_lens": np.asarray([ids_np.shape[1]], np.int32),
        "position_ids": pos,
        "image_patches": patches,
        "image_grid_hw": grid_hw,
    }
