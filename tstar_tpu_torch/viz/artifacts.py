"""Visualization sinks (port of ``tstar_tpu/viz/artifacts.py``): the score
distribution plot, the search-iteration GIF and the grid images it holds.

Host-side and outside the search loop.  matplotlib and PIL are imported by
the functions that draw with them, never with the module.  The grid images
are resized with the port's own bilinear code (``kernels/image.py``: the
interpolation of cv2's INTER_LINEAR, rounded to uint8), where the reference
calls ``cv2.resize``; cv2's fixed-point arithmetic puts a pixel at most one
level apart.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tstar_tpu_torch.kernels.image import bilinear_resize, pack_grid


def plot_score_distribution(
    scores: np.ndarray, duration: float, save_path: Optional[str] = None, show: bool = False
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.linspace(0, duration, len(scores))
    plt.figure(figsize=(12, 6))
    plt.plot(t, scores, label="Score Distribution")
    plt.xlabel("Time (seconds)")
    plt.ylabel("Score")
    plt.title("Score Distribution Over Time")
    plt.grid(True)
    plt.legend()
    if save_path:
        plt.savefig(save_path, format="png", dpi=150)
    if show:
        plt.show()
    plt.close()


def render_grid_image(
    cache,                           # (N_pad, ch, cw, 3) uint8, array or CPU tensor
    secs: Sequence[int],
    grid_shape: Tuple[int, int],
    cell_hw: Tuple[int, int] = (95, 200),
) -> np.ndarray:
    """Rebuild an iteration's grid image from the frame cache, (rows * h,
    cols * w, 3) uint8."""
    rows, cols = grid_shape
    cache = torch.as_tensor(cache)
    idx = torch.as_tensor([int(s) for s in secs], dtype=torch.int64)
    cells = bilinear_resize(cache[idx].cpu(), tuple(cell_hw))
    cells = cells.round().clamp(0, 255).to(torch.uint8)
    return pack_grid(cells, rows, cols).numpy()


def save_search_gif(grid_images: List[np.ndarray], output_gif_path: str):
    from tstar_tpu_torch.utils.images import save_as_gif

    if grid_images:
        save_as_gif(grid_images, output_gif_path)


def save_batched_search_artifacts(
    video_path: str,
    row: dict,
    grid_shape: Tuple[int, int],
    cell_hw: Tuple[int, int],
    class_names: Sequence[str],
    detection_image_size: int,
    output_gif_path: str,
    sampling_fps: float = 1.0,
    decoder=None,
) -> bool:
    """The annotated search GIF of one video from its batched-search result
    row (``search_videos(collect_history=True)``): the sampled seconds are
    decoded again at the cell size, from ``decoder`` or else the video file,
    since the search keeps no pixels.  Returns False when the row has no
    history."""
    from tstar_tpu_torch.video.decoder import opened
    from tstar_tpu_torch.viz.boxes import draw_boxes

    samp = row.get("sampled_history")
    if not samp:
        return False
    dets = row.get("detect_bbox_iters") or []
    rows, cols = grid_shape
    ch, cw = cell_hw
    wanted = sorted({int(s) for it in samp for s in it})
    with opened(video_path, decoder) as dec:
        raw_fps = dec.meta.fps
        frames = dec.decode_batch([int(s / sampling_fps * raw_fps) for s in wanted],
                                  out_hw=cell_hw)
    cache_like = np.zeros((max(wanted) + 1, ch, cw, 3), np.uint8)
    for j, s in enumerate(wanted):
        cache_like[s] = frames[j]
    sx = cols * cw / detection_image_size
    sy = rows * ch / detection_image_size
    out = []
    for j, secs in enumerate(samp):
        grid = render_grid_image(cache_like, secs, grid_shape, cell_hw=cell_hw)
        if j < len(dets) and len(dets[j].get("boxes", [])):
            d = dets[j]
            boxes = np.asarray(d["boxes"], np.float64) * [sx, sy, sx, sy]
            labels = [f"{class_names[c] if c < len(class_names) else c} {s:.2f}"
                      for c, s in zip(d["class_ids"], d["scores"])]
            grid = draw_boxes(grid, boxes, labels=labels, class_ids=list(d["class_ids"]))
        out.append(grid)
    save_search_gif(out, output_gif_path)
    return True
