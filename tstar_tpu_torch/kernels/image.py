"""On-device image preprocessing for the detector path (port of
``tstar_tpu/kernels/image.py``).

    cache (N, ch, cw, 3) uint8  --gather-->  (K, ch, cw, 3)
      --resize+normalize+pack-->  (1, 768, 768, 3) detector input

Bilinear resampling is two small dense matmuls with precomputed
interpolation matrices (out = A_h @ img @ A_w^T) implementing
cv2.resize(INTER_LINEAR): half-pixel centers, edge clamp, no antialiasing.
The reference module is XLA code, not a Pallas kernel, so this port is plain
PyTorch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear resampling matrix, cv2 INTER_LINEAR semantics."""
    scale = n_in / n_out
    out = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        frac = src - i0
        lo = min(max(i0, 0), n_in - 1)
        hi = min(max(i0 + 1, 0), n_in - 1)
        out[o, lo] += 1.0 - frac
        out[o, hi] += frac
    return out


def bilinear_resize(images: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize (..., H, W, C) images (uint8 or float) -> float32 (..., h, w, C)."""
    h_in, w_in = images.shape[-3], images.shape[-2]
    h_out, w_out = out_hw
    ah = torch.from_numpy(_interp_matrix(h_in, h_out)).to(images.device)
    aw = torch.from_numpy(_interp_matrix(w_in, w_out)).to(images.device)
    x = images.to(torch.float32)
    x = torch.einsum("oh,...hwc->...owc", ah, x)
    return torch.einsum("pw,...owc->...opc", aw, x)


def normalize_clip(pixels: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[0, 255] -> CLIP-normalized floats in ``dtype``."""
    mean = torch.from_numpy(CLIP_MEAN).to(pixels.device)
    std = torch.from_numpy(CLIP_STD).to(pixels.device)
    x = pixels.to(torch.float32) / 255.0
    return ((x - mean) / std).to(dtype)


def pack_grid(cells: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(R*C, h, w, ch) cells -> (R*h, C*w, ch) grid image, row-major cells."""
    n, h, w, c = cells.shape
    if n != rows * cols:
        raise ValueError(f"{n} cells for a {rows}x{cols} grid")
    return (
        cells.reshape(rows, cols, h, w, c)
        .permute(0, 2, 1, 3, 4)
        .reshape(rows * h, cols * w, c)
    )


def build_detector_grid(
    cache: torch.Tensor,        # (N_pad, ch, cw, 3) uint8 frame cache
    secs: torch.Tensor,         # (R*C,) sampled seconds
    grid_shape: Tuple[int, int],
    detector_size: int = 768,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Gather frames and build one normalized detector input (1, S, S, 3);
    cell k (row-major) holds the frame of second ``secs[k]``."""
    return build_detector_grid_frames(cache[secs], grid_shape, detector_size, dtype)


def build_detector_grid_frames(
    frames: torch.Tensor,       # (K, ch, cw, 3) uint8 gathered frames
    grid_shape: Tuple[int, int],
    detector_size: int = 768,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """``build_detector_grid`` after the gather."""
    rows, cols = grid_shape
    cell_h, cell_w = detector_size // rows, detector_size // cols
    cells = bilinear_resize(frames, (cell_h, cell_w))
    # normalize (elementwise) before the packing copy: same values, fewer bytes
    cells = normalize_clip(cells, dtype)
    return pack_grid(cells, rows, cols)[None]


def build_verify_batch(
    cache: torch.Tensor,
    secs: torch.Tensor,
    detector_size: int = 768,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Gather frames for verification -> (K, S, S, 3) normalized."""
    imgs = bilinear_resize(cache[secs], (detector_size, detector_size))
    return normalize_clip(imgs, dtype)
