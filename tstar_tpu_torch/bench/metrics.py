"""Keyframe-search evaluation metrics (port of ``tstar_tpu/bench/metrics.py``,
after the reference's ``val_tstar_results.py``).

* **Temporal P/R/F1**: a predicted timestamp matches a ground-truth one when
  |dt| <= threshold (5 s); precision over predictions, recall over the
  ground truth, averaged per video.
* **SSIM P/R/F1**: pairwise SSIM between ground-truth and predicted frames;
  per video, precision is the mean over predictions of their best SSIM
  against any ground-truth frame, recall the mean over ground-truth frames of
  their best SSIM against any prediction.  The reference's ``ssim_torch``
  feeds (H, W, 3) frames to a convolution with ``channels = H``: the 11x11
  Gaussian window slides over the (width, colour) plane with the image
  HEIGHT as the channel axis.  ``axis_convention="reference"`` reproduces
  that so the numbers compare; ``"standard"`` is the usual per-channel SSIM.
* **ANND**: average nearest-neighbour distance, both sides.

SSIM runs as grouped ``torch.nn.functional.conv2d`` calls: each frame's
mean and variance once, and every (ground truth, prediction) pair's
covariance in one batched convolution over the pair grid.  The JAX package
computes it with ``lax.conv`` (no Pallas kernel), so the library
convolution is its counterpart here.  The statistics are computed in
float64: the variance E[x^2] - E[x]^2 cancels in flat regions, where it
sits beside the constant 9e-4, and float32 puts SSIM up to ~3e-4 off there
(the reference's float32 ``lax.conv`` ~5e-5; an identical pair then scores
0.9999924, not 1).
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

F64 = np.float64


def temporal_prf(
    gt_secs: Sequence[np.ndarray], pred_secs: Sequence[np.ndarray], threshold: float = 5.0,
) -> Tuple[float, float, float]:
    """Per-video P/R/F1 on |dt| <= threshold, averaged over videos."""
    ps, rs, fs = [], [], []
    for gt, pred in zip(gt_secs, pred_secs):
        gt = np.asarray(gt, F64)
        pred = np.asarray(pred, F64)
        if gt.size == 0 or pred.size == 0:
            continue
        d_gt = np.min(np.abs(gt[:, None] - pred[None, :]), axis=1)
        d_pred = np.min(np.abs(pred[:, None] - gt[None, :]), axis=1)
        p = float(np.sum(d_pred <= threshold)) / len(pred)
        r = float(np.sum(d_gt <= threshold)) / len(gt)
        f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        ps.append(p)
        rs.append(r)
        fs.append(f)
    if not ps:
        return 0.0, 0.0, 0.0
    return float(np.mean(ps)), float(np.mean(rs)), float(np.mean(fs))


def annd(gt_secs: Sequence[np.ndarray], pred_secs: Sequence[np.ndarray]) -> Tuple[float, float]:
    """Average nearest-neighbour distance (precision side, recall side)."""
    pres, recs = [], []
    for gt, pred in zip(gt_secs, pred_secs):
        gt = np.asarray(gt, F64)
        pred = np.asarray(pred, F64)
        if gt.size == 0 or pred.size == 0:
            continue
        pres.append(float(np.mean(np.min(np.abs(pred[:, None] - gt[None, :]), axis=1))))
        recs.append(float(np.mean(np.min(np.abs(gt[:, None] - pred[None, :]), axis=1))))
    if not pres:
        return 0.0, 0.0
    return float(np.mean(pres)), float(np.mean(recs))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def _conv_layout(frames: torch.Tensor, convention: str) -> torch.Tensor:
    """(N, h, w, c) -> (N, channels, *spatial) for the SSIM convolution."""
    if convention == "reference":
        return frames                                # channels = h, spatial = (w, c)
    if convention == "standard":
        return frames.permute(0, 3, 1, 2)           # channels = c, spatial = (h, w)
    raise ValueError(convention)


def pairwise_ssim(
    gt_frames: Sequence[np.ndarray],
    pred_frames: Sequence[np.ndarray],
    axis_convention: str = "reference",
    device="cuda",
) -> np.ndarray:
    """(num_gt, num_pred) SSIM matrix; frames are uint8 RGB of equal shape."""
    gt = np.stack([np.asarray(f) for f in gt_frames])
    pred = np.stack([np.asarray(f) for f in pred_frames])
    if gt.shape[1:] != pred.shape[1:]:
        raise ValueError(f"frame shapes differ: {gt.shape[1:]} vs {pred.shape[1:]}")
    x = _conv_layout(torch.from_numpy(gt).to(device, torch.float64) / 255.0, axis_convention)
    y = _conv_layout(torch.from_numpy(pred).to(device, torch.float64) / 255.0, axis_convention)
    channels = x.shape[1]
    window = torch.from_numpy(_gaussian_window()).to(x.device, torch.float64)
    kernel = window.expand(channels, 1, 11, 11).contiguous()

    def conv(t):
        return F.conv2d(t, kernel, padding=5, groups=channels)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = conv(x), conv(y)
    sxx = conv(x * x) - mu_x * mu_x
    syy = conv(y * y) - mu_y * mu_y
    g, p = x.shape[0], y.shape[0]
    # every (gt, pred) pair's product in one convolution: (G*P, channels, ...)
    sxy = conv((x[:, None] * y[None]).flatten(0, 1)).view(g, p, *x.shape[1:])
    mux, muy = mu_x[:, None], mu_y[None]
    sxy = sxy - mux * muy
    m = ((2 * mux * muy + c1) * (2 * sxy + c2)) / (
        (mux * mux + muy * muy + c1) * (sxx[:, None] + syy[None] + c2)
    )
    return m.flatten(2).mean(dim=-1).cpu().numpy().astype(np.float32)


def ssim_prf(
    gt_images: Sequence[Sequence[np.ndarray]],
    pred_images: Sequence[Sequence[np.ndarray]],
    axis_convention: str = "reference",
    device="cuda",
) -> Tuple[float, float, float]:
    """Averaged SSIM precision / recall, and the F1 of the averages."""
    ps, rs = [], []
    for gt, pred in zip(gt_images, pred_images):
        gt = [g for g in gt if np.asarray(g).size > 0]
        pred = [p for p in pred if np.asarray(p).size > 0]
        if not gt or not pred:
            continue
        m = pairwise_ssim(gt, pred, axis_convention, device)
        ps.append(float(np.mean(np.max(m, axis=0))))
        rs.append(float(np.mean(np.max(m, axis=1))))
    if not ps:
        return 0.0, 0.0, 0.0
    p, r = float(np.mean(ps)), float(np.mean(rs))
    f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return p, r, f


def match_answer(predicted: str, ground_truth: str) -> bool:
    """A leading option letter against the ground truth's, else the whole
    strings, case-insensitive."""
    m = re.match(r"^\s*([A-Fa-f])", predicted)
    if m:
        return m.group(1).lower() == ground_truth.strip().lower()
    return predicted.strip().lower() == ground_truth.strip().lower()
