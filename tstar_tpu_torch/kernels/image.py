"""On-device image preprocessing for the detector path (port of
``tstar_tpu/kernels/image.py``).

    cache (N, ch, cw, 3) uint8  --gather-->  (K, ch, cw, 3)
      --resize+normalize+pack-->  (1, 768, 768, 3) detector input

Bilinear resampling is two small dense matmuls with precomputed
interpolation matrices (out = A_h @ img @ A_w^T) implementing
cv2.resize(INTER_LINEAR): half-pixel centers, edge clamp, no antialiasing.
The composed projection (``composed_patch_projection`` /
``grid_patch_embeddings``, opt-in through ``TSTAR_COMPOSED_PATCH=1`` in the
scorer) folds that chain and the patch embedding into one matmul.  The
reference module is XLA code, not a Pallas kernel, so this port is plain
PyTorch (numpy for the host-side weight folding).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

# Small per-geometry constants, copied to each device once: a copy from host
# memory in every call makes the host wait for the card (PyTorch synchronizes
# after a blocking copy to the device) and cannot be captured in a CUDA graph.
_ON_DEVICE: Dict[tuple, torch.Tensor] = {}


def device_constant(key: tuple, make: Callable[[], np.ndarray], device) -> torch.Tensor:
    """``make()`` as a tensor on ``device``, copied there once per (key, device)."""
    full = key + (str(device),)
    t = _ON_DEVICE.get(full)
    if t is None:
        t = _ON_DEVICE[full] = torch.from_numpy(np.ascontiguousarray(make())).to(device)
    return t


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
    ah = device_constant(("interp", h_in, h_out), lambda: _interp_matrix(h_in, h_out), images.device)
    aw = device_constant(("interp", w_in, w_out), lambda: _interp_matrix(w_in, w_out), images.device)
    x = images.to(torch.float32)
    x = torch.einsum("oh,...hwc->...owc", ah, x)
    return torch.einsum("pw,...owc->...opc", aw, x)


def normalize_clip(pixels: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[0, 255] -> CLIP-normalized floats in ``dtype``."""
    mean = device_constant(("clip_mean",), lambda: CLIP_MEAN, pixels.device)
    std = device_constant(("clip_std",), lambda: CLIP_STD, pixels.device)
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


def composed_patch_projection(
    patch_kernel: np.ndarray,   # (p, p, 3, D) HWIO patch-embedding weights
    cache_hw: Tuple[int, int],
    cell_hw: Tuple[int, int],
    patch_size: int,
):
    """Fold resize + CLIP normalize + grid pack + patch embed into ONE matmul.

    The pixel chain is linear in the uint8 frame.  When every detector
    patch's bilinear support falls inside a fixed, translation-invariant
    source block (the 192x384 cache -> 192x192 cell: identity rows, 2:1
    columns), it collapses to ``patchify(frames, (s_h, s_w)) @ W + b``.

    Returns ``(W (s_h*s_w*3, D) f32, b (D,) f32, (s_h, s_w))``, or None when
    the geometry is not block-aligned.
    """
    ch, cw = cache_hw
    cell_h, cell_w = cell_hw
    p = patch_size
    if cell_h % p or cell_w % p:
        return None
    if (ch * p) % cell_h or (cw * p) % cell_w:
        return None
    s_h, s_w = ch * p // cell_h, cw * p // cell_w

    def block_matrix(n_in: int, n_out: int, blk_out: int, blk_in: int):
        """(blk_out, blk_in) per-block resampling matrix, or None when the
        resample is not block-aligned and translation-invariant."""
        a = _interp_matrix(n_in, n_out)
        blocks = []
        for bi in range(n_out // blk_out):
            sub = a[bi * blk_out:(bi + 1) * blk_out]
            outside = np.concatenate(
                [sub[:, : bi * blk_in], sub[:, (bi + 1) * blk_in:]], axis=1
            )
            if outside.size and np.abs(outside).max() > 0:
                return None
            blocks.append(sub[:, bi * blk_in:(bi + 1) * blk_in])
        if any(not np.array_equal(blocks[0], other) for other in blocks[1:]):
            return None
        return blocks[0]

    ah = block_matrix(ch, cell_h, p, s_h)
    aw = block_matrix(cw, cell_w, p, s_w)
    if ah is None or aw is None:
        return None
    k = np.asarray(patch_kernel, np.float32)
    d = k.shape[-1]
    # W[u, v, c, :] = sum_{i,j} ah[i, u] aw[j, v] k[i, j, c, :] / (255 std_c)
    w = np.einsum("iu,jv,ijcd->uvcd", ah, aw, k, optimize=True)
    w = w / (255.0 * CLIP_STD.reshape(1, 1, 3, 1))
    # rows of ah / aw sum to 1, so the affine shift is a constant per column
    b = -np.einsum("ijcd,c->d", k, (CLIP_MEAN / CLIP_STD).astype(np.float32))
    return w.reshape(s_h * s_w * 3, d).astype(np.float32), b.astype(np.float32), (s_h, s_w)


def patchify_rect(frames: torch.Tensor, s_h: int, s_w: int) -> torch.Tensor:
    """(K, H, W, C) -> (K, (H//s_h)*(W//s_w), s_h*s_w*C), (sh, sw, c) minor
    order (an HWIO kernel flattened to (s_h*s_w*C, D))."""
    k, h, w, c = frames.shape
    x = frames.reshape(k, h // s_h, s_h, w // s_w, s_w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(k, (h // s_h) * (w // s_w), s_h * s_w * c)


def grid_patch_embeddings(
    cache: torch.Tensor,        # (N_pad, ch, cw, 3) uint8 frame cache
    secs: torch.Tensor,         # (R*C,) sampled seconds
    proj_w: torch.Tensor,       # (s_h*s_w*3, D) composed projection
    proj_b: torch.Tensor,       # (D,)
    grid_shape: Tuple[int, int],
    src_patch_hw: Tuple[int, int],
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Composed cache -> detector patch embeddings, (1, P, D), in the grid
    canvas's row-major patch order."""
    rows, cols = grid_shape
    s_h, s_w = src_patch_hw
    frames = cache[secs]                                   # (K, ch, cw, 3)
    patches = patchify_rect(frames.to(dtype), s_h, s_w)
    e = torch.matmul(patches, proj_w.to(dtype)) + proj_b.to(dtype)   # (K, pc, D)
    nph = frames.shape[1] // s_h
    npw = e.shape[1] // nph
    d = e.shape[-1]
    # cell (r, c), cell patch (i, j) -> canvas patch (r*nph + i, c*npw + j)
    e = e.reshape(rows, cols, nph, npw, d).permute(0, 2, 1, 3, 4)
    return e.reshape(1, rows * nph * cols * npw, d)


def build_verify_batch(
    cache: torch.Tensor,
    secs: torch.Tensor,
    detector_size: int = 768,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Gather frames for verification -> (K, S, S, 3) normalized."""
    imgs = bilinear_resize(cache[secs], (detector_size, detector_size))
    return normalize_clip(imgs, dtype)
