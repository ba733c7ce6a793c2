"""Reference-architecture baseline for benchmarking (port of
``tstar_tpu/bench/reference_style.py``).

A re-creation of the original TStar searcher's runtime architecture, with
the same detector weights on the same card as the port's engine: every
iteration samples on the host (numpy), builds the grid on the host, runs one
detector forward on the card, brings the detections back to the host
(``.cpu()``: that round trip is the point of the baseline), splats them and
refits the scipy spline on the host.  A benchmark divides the engine's
frames/s by this one's.  Decode is excluded (the original re-decodes frames
every iteration, so the real-world gap is larger).

The grid: the card's machine has no cv2, so each cell is resized by the
port's host bilinear (``utils/images.resize_uint8``: cv2 INTER_LINEAR's
half-pixel centres, within one level of cv2's fixed point) and normalized
with CLIP's mean and std.  The caller builds ``detector_forward`` (the
tower, the heads and ``postprocess_detections``), as the reference's
benchmark does.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple, Union

import numpy as np
import torch

from tstar_tpu_torch.kernels.image import CLIP_MEAN, CLIP_STD
from tstar_tpu_torch.utils.images import resize_uint8

F32 = np.float32


def host_grid(cache: np.ndarray, secs: np.ndarray, rows: int, cols: int,
              detector_size: int) -> np.ndarray:
    """The host-built grid: ``cache[secs]`` resized to cells, row-major, as
    (S, S, 3) uint8."""
    cells = resize_uint8(cache[secs], (detector_size // rows, detector_size // cols))
    return np.vstack([np.hstack(list(cells[r * cols:(r + 1) * cols])) for r in range(rows)])


@torch.no_grad()
def reference_style_search(
    detector_forward: Callable,   # normalized (1, S, S, 3) f32 tensor -> (scores, cls, boxes)
    cache: np.ndarray,            # (N, ch, cw, 3) uint8 host-side 1-fps frames
    n_valid: int,
    class_weights: np.ndarray,
    n_targets: int,
    config,
    detector_size: int = 768,
    rng: np.random.Generator | None = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, float]:
    """Run the host-loop search to budget exhaustion on ``device``'s
    detector.  Returns (frames_scored, wall_seconds)."""
    from scipy.interpolate import UnivariateSpline

    rng = rng or np.random.default_rng(0)
    k = config.frames_per_iteration
    rows, cols = config.grid_rows, config.grid_cols

    scores = np.full(n_valid, config.score_init, F32)
    non_visiting = np.ones(n_valid, F32)
    p = np.full(n_valid, config.confidence_threshold * config.p_init_scale, F32)
    budget = config.budget_frames(n_valid)
    remaining = n_targets
    iteration = 0
    frames_scored = 0

    t0 = time.perf_counter()
    while remaining > 0 and budget > 0:
        # --- host sampling ---
        if iteration == 0:
            secs = np.arange(k) * (n_valid // k)
        else:
            w = (p + k / n_valid) * non_visiting
            thr = np.percentile(w, config.top_percentile)
            masked = w * (w >= thr)
            if masked.sum() == 0 or (masked > 0).sum() < k:
                masked = p + k / n_valid
            masked = masked / masked.sum()
            secs = rng.choice(n_valid, size=k, replace=False, p=masked)

        # --- host grid -> device forward -> host detections ---
        grid = host_grid(cache, secs, rows, cols, detector_size)
        pixels = (grid.astype(F32) / 255.0 - CLIP_MEAN) / CLIP_STD
        s, c, b = (t.cpu().numpy() for t in detector_forward(
            torch.from_numpy(pixels[None]).to(device)))
        budget -= k
        frames_scored += k

        # --- host splat (cell max of weighted confidences) ---
        keep = s[0] > config.detector_threshold
        cx = (b[0, :, 0] + b[0, :, 2]) / 2
        cy = (b[0, :, 1] + b[0, :, 3]) / 2
        gx = np.clip((cx / (detector_size / cols)).astype(int), 0, cols - 1)
        gy = np.clip((cy / (detector_size / rows)).astype(int), 0, rows - 1)
        cell = gy * cols + gx
        conf_map = np.zeros(k, F32)
        adj = np.where(keep, s[0] * class_weights[c[0]], 0.0)
        np.maximum.at(conf_map, cell, adj.astype(F32))

        # --- host state update + windowed splat + scipy spline refit ---
        scores[secs] = conf_map
        non_visiting[secs] = 0
        thr_c = np.percentile(conf_map, config.top_percentile)
        for kk in np.nonzero(conf_map >= thr_c)[0]:
            sec = int(secs[kk])
            center = scores[sec]
            for off in range(-config.window_size, config.window_size + 1):
                j = sec + off
                if 0 <= j < n_valid:
                    scores[j] = max(scores[j], center / (abs(off) + 1))
        visited_idx = np.nonzero(non_visiting == 0)[0]
        spline = UnivariateSpline(visited_idx, scores[visited_idx], s=config.spline_smoothing)
        vals = spline(np.arange(n_valid))
        adj2 = np.maximum(1.0 / n_valid, vals)
        p = (1.0 / (1.0 + np.exp(-adj2))).astype(F32)
        p /= p.sum()
        iteration += 1

    return frames_scored, time.perf_counter() - t0
