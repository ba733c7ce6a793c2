"""Bounding-box annotation (port of ``tstar_tpu/viz/boxes.py``): box outlines
drawn into a copy of the image with numpy, labels with PIL where it is
installed (imported when labels are drawn)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_PALETTE = [
    (230, 60, 60), (60, 160, 230), (60, 200, 90), (230, 180, 50),
    (180, 80, 220), (60, 220, 220), (240, 130, 40), (150, 150, 150),
]


def draw_boxes(
    image: np.ndarray,                     # (H, W, 3) uint8; a modified copy is returned
    boxes_xyxy: Sequence[Sequence[float]],
    labels: Optional[Sequence[str]] = None,
    class_ids: Optional[Sequence[int]] = None,
    thickness: int = 2,
) -> np.ndarray:
    out = np.array(image, copy=True)
    h, w = out.shape[:2]
    for i, box in enumerate(boxes_xyxy):
        x0, y0, x1, y1 = [int(round(float(v))) for v in box]
        x0, x1 = max(0, min(x0, w - 1)), max(0, min(x1, w - 1))
        y0, y1 = max(0, min(y0, h - 1)), max(0, min(y1, h - 1))
        color = _PALETTE[(class_ids[i] if class_ids is not None else i) % len(_PALETTE)]
        t = thickness
        out[y0:y0 + t, x0:x1] = color
        out[max(0, y1 - t):y1, x0:x1] = color
        out[y0:y1, x0:x0 + t] = color
        out[y0:y1, max(0, x1 - t):x1] = color
    if labels:
        out = _draw_labels(out, boxes_xyxy, labels, class_ids)
    return out


def _draw_labels(image, boxes, labels, class_ids):
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        return image
    pil = Image.fromarray(image)
    d = ImageDraw.Draw(pil)
    for i, (box, label) in enumerate(zip(boxes, labels)):
        color = _PALETTE[(class_ids[i] if class_ids is not None else i) % len(_PALETTE)]
        d.text((float(box[0]) + 3, max(0.0, float(box[1]) - 12)), str(label), fill=color)
    return np.asarray(pil)
