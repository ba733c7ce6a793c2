"""Detection->cell splatting and the windowed score update (port of
``tstar_tpu/ops/splat.py``).

* ``splat_detections_to_cells`` maps detector boxes onto the R x C grid by
  box center: per-cell max of weighted confidences, per-cell class presence.
* ``window_splat`` propagates each top-quartile frame's score to its +-W
  neighbours with 1/(|offset|+1) decay, max-merged.  The reference loop is
  order-dependent (a frame's splat reads its current score, which an earlier
  frame may have raised); the only values it reads back are the sampled
  frames' centers, so the order dependence is a K-step recurrence over those
  centers followed by one scatter-max.
"""

from __future__ import annotations

from typing import Tuple

import torch


def splat_detections_to_cells(
    boxes_xyxy: torch.Tensor,     # (..., Q, 4) image pixel coords
    scores: torch.Tensor,         # (..., Q) post-sigmoid confidences
    class_ids: torch.Tensor,      # (..., Q) int
    keep: torch.Tensor,           # (..., Q) bool
    class_weights: torch.Tensor,  # (..., C)
    grid_shape: Tuple[int, int],
    image_hw: Tuple[int, int],
    num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (conf_map (..., R, C), presence (..., R*C, num_classes) bool);
    leading axes (a batch of images) splat apart."""
    rows, cols = grid_shape
    img_h, img_w = image_hw
    cell_w = img_w / cols
    cell_h = img_h / rows
    lead = scores.shape[:-1]

    cx = (boxes_xyxy[..., 0] + boxes_xyxy[..., 2]) * 0.5
    cy = (boxes_xyxy[..., 1] + boxes_xyxy[..., 3]) * 0.5
    gx = torch.floor(cx / cell_w).to(torch.int64).clamp(0, cols - 1)
    gy = torch.floor(cy / cell_h).to(torch.int64).clamp(0, rows - 1)
    cell = gy * cols + gx

    class_ids = class_ids.to(torch.int64)
    adjusted = scores * class_weights.gather(-1, class_ids)
    # conf starts at 0 and adjusted >= 0, so dropped detections scatter 0.
    vals = torch.where(keep, adjusted, torch.zeros_like(adjusted)).to(scores.dtype)
    conf = torch.zeros(*lead, rows * cols, dtype=scores.dtype, device=scores.device)
    conf = conf.scatter_reduce(-1, cell, vals, reduce="amax", include_self=True)

    presence = torch.zeros(
        *lead, rows * cols * num_classes, dtype=torch.int32, device=scores.device
    )
    presence = presence.scatter_reduce(
        -1, cell * num_classes + class_ids, keep.to(torch.int32), reduce="amax",
        include_self=True,
    )
    return (
        conf.reshape(*lead, rows, cols),
        presence.reshape(*lead, rows * cols, num_classes) > 0,
    )


def window_splat(
    score_distribution: torch.Tensor,  # (N_pad,) or (B, N_pad)
    sampled_secs: torch.Tensor,        # (K,) or (B, K) int
    is_top: torch.Tensor,              # (K,) or (B, K) bool
    n_valid,                           # int, or (B,) tensor of lengths
    window_size: int = 5,
) -> torch.Tensor:
    """Windowed max-splat, equal to the reference's sequential loop; rows of
    a (B, N_pad) batch splat apart."""
    if score_distribution.ndim == 1:
        return window_splat(
            score_distribution[None], sampled_secs[None], is_top[None], n_valid, window_size
        )[0]
    dtype = score_distribution.dtype
    device = score_distribution.device
    k_total = sampled_secs.shape[-1]
    neg_inf = -float("inf")
    offsets = torch.arange(-window_size, window_size + 1, device=device)
    decay = 1.0 / (offsets.abs().to(dtype) + 1.0)

    centers = score_distribution.gather(-1, sampled_secs)                  # (B, K)
    dist = (sampled_secs[:, :, None] - sampled_secs[:, None, :]).abs()     # (B, K, K)
    cross_decay = 1.0 / (dist.to(dtype) + 1.0)
    in_window = dist <= window_size
    order = torch.arange(k_total, device=device)

    for k in range(k_total):
        earlier = (order < k) & is_top & in_window[:, k]
        raised = torch.where(earlier, centers * cross_decay[:, k], neg_inf).amax(dim=-1)
        centers[:, k] = torch.maximum(centers[:, k], raised)

    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid[:, None, None]
    idxs = sampled_secs[:, :, None] + offsets                               # (B, K, W)
    vals = centers[:, :, None] * decay
    ok = is_top[:, :, None] & (idxs >= 0) & (idxs < n_valid)
    vals = torch.where(ok, vals, neg_inf)
    idxs = idxs.clamp(0, score_distribution.shape[-1] - 1)  # masked rows scatter -inf
    b = score_distribution.shape[0]
    return score_distribution.scatter_reduce(
        -1, idxs.reshape(b, -1), vals.reshape(b, -1), reduce="amax", include_self=True
    )
