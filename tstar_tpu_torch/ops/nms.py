"""Fixed-shape non-maximum suppression (port of ``tstar_tpu/ops/nms.py``).

Greedy NMS with a fixed number of output slots, batched over a leading image
axis: a stable descending score sort, then the suppression loop, which on a
CUDA tensor is the hand-written kernel ``kernels/nms.greedy_nms`` (the
reference's is an XLA ``fori_loop``) and on a CPU tensor its plain version.
Class-aware NMS offsets each class's boxes by a multiple of the boxes' span
(torchvision's ``batched_nms`` trick), so boxes of different classes never
overlap.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tstar_tpu_torch.kernels.nms import box_iou, greedy_nms  # noqa: F401


def nms(
    boxes: torch.Tensor,     # (..., N, 4) xyxy f32
    scores: torch.Tensor,    # (..., N)
    iou_threshold: float = 0.7,
    max_outputs: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (keep (..., max_outputs) int32, valid (..., max_outputs) bool);
    invalid slots hold index 0.  Ties keep index order (the sort is stable,
    as ``jnp.argsort``)."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    order = torch.argsort(-scores.reshape(-1, n), dim=-1, stable=True)
    keep, valid = greedy_nms(boxes.reshape(-1, n, 4).float(), order, iou_threshold, max_outputs)
    return keep.reshape(*lead, max_outputs), valid.reshape(*lead, max_outputs)


def batched_class_nms(
    boxes: torch.Tensor,      # (..., N, 4)
    scores: torch.Tensor,     # (..., N)
    class_ids: torch.Tensor,  # (..., N)
    iou_threshold: float = 0.7,
    max_outputs: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS of each image: its boxes offset by class id times
    (max - min + 1) over all of its boxes."""
    span = boxes.amax(dim=(-2, -1), keepdim=True) - boxes.amin(dim=(-2, -1), keepdim=True) + 1.0
    offset = class_ids.to(boxes.dtype)[..., None] * span
    return nms(boxes + offset, scores, iou_threshold, max_outputs)
