"""Scorer backed by YOLO-World over the frame cache (port of
``tstar_tpu/search/yolo_scorer.py``).

The same role as ``OwlVitScorer`` with the YOLO pipeline: inputs in [0, 1]
at the detector's size (640), text conditioning computed once per video,
NMS'd detections (score threshold 0.12, at most 50) splatted onto the grid
cells.  The grid canvas and the verification frames are built with the
plain pixel chain (``kernels/image.py``'s ``bilinear_resize`` and
``pack_grid``), as the reference builds them with its XLA code.

A scorer stacked over B videos (``parallel/batched.stack_scorers``: caches,
text embeddings, masks and class weights on a leading video axis, the
detector shared) scores with the flat batch methods, one detector forward
over all the images with each image's own text: ``score_grid_batch``,
``score_verify_batch`` and ``score_verify_flat``.  Each image's detections
depend on its pixels and its video's text alone, so per video they are what
the reference's vmapped single-video step computes.  Every method has static
shapes and reads nothing back to the host, so the search steps replay as
CUDA graphs (``search/step_graphs.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from tstar_tpu_torch.kernels.image import bilinear_resize, pack_grid
from tstar_tpu_torch.models.yoloworld import YoloWorldDetector, postprocess_yolo
from tstar_tpu_torch.ops.splat import splat_detections_to_cells
from tstar_tpu_torch.utils.config import SearchConfig


@dataclasses.dataclass
class YoloWorldScorer:
    cache: torch.Tensor          # (N_pad, ch, cw, 3) uint8; (B, N_pad, ...) stacked
    model: YoloWorldDetector
    text_embeds: torch.Tensor    # (Q, text_dim) f32 CLIP text features; (B, Q, D) stacked
    query_mask: torch.Tensor     # (Q,) bool; (B, Q) stacked
    class_weights: torch.Tensor  # (Q,) f32; (B, Q) stacked
    config: SearchConfig

    @property
    def num_classes(self) -> int:
        return self.text_embeds.shape[-2]

    @property
    def detection_image_size(self) -> int:
        return self.model.cfg.image_size

    def _grid_pixels(self, cache: torch.Tensor, secs: torch.Tensor) -> torch.Tensor:
        """One video's (K,) seconds -> its grid canvas (1, S, S, 3) in [0, 1]."""
        cfg, size = self.config, self.detection_image_size
        rows, cols = cfg.grid_rows, cfg.grid_cols
        cells = bilinear_resize(cache[secs], (size // rows, size // cols))
        return (pack_grid(cells, rows, cols) / 255.0)[None]

    def _frame_pixels(self, frames: torch.Tensor) -> torch.Tensor:
        size = self.detection_image_size
        return bilinear_resize(frames, (size, size)) / 255.0

    @torch.no_grad()
    def _detect(self, pixels: torch.Tensor, text_embeds: torch.Tensor, query_mask: torch.Tensor):
        logits, boxes = self.model(pixels, text_embeds)
        c = self.model.cfg
        return postprocess_yolo(
            logits, boxes, query_mask, score_threshold=c.score_threshold,
            nms_iou=c.nms_iou, max_dets=c.max_dets,
        )

    def _splat(self, dets, class_weights: torch.Tensor, grid_shape):
        scores, class_ids, boxes, keep = dets
        size = self.detection_image_size
        if class_weights.ndim == 1:
            class_weights = class_weights.expand(scores.shape[0], -1)
        return splat_detections_to_cells(
            boxes, scores, class_ids, keep, class_weights, grid_shape=grid_shape,
            image_hw=(size, size), num_classes=self.num_classes,
        )

    def score_grid(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K,) seconds -> one grid image -> (conf (K,), presence (K, C))."""
        cfg = self.config
        dets = self._detect(self._grid_pixels(self.cache, secs), self.text_embeds, self.query_mask)
        conf, presence = self._splat(dets, self.class_weights, (cfg.grid_rows, cfg.grid_cols))
        return conf[0].reshape(-1), presence[0]

    def score_verify(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T,) seconds, each frame scored alone as a 1x1 grid."""
        dets = self._detect(self._frame_pixels(self.cache[secs]), self.text_embeds, self.query_mask)
        conf, presence = self._splat(dets, self.class_weights, (1, 1))
        return conf[:, 0, 0], presence[:, 0]

    # ---- flat multi-video batch (stacked scorer) ------------------------------

    def score_grid_batch(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, K) seconds -> one grid canvas per video -> ONE detector forward
        over the B canvases with each video's text -> (conf (B, K), presence
        (B, K, C))."""
        cfg = self.config
        pixels = torch.cat([self._grid_pixels(c, s) for c, s in zip(self.cache, secs)])
        dets = self._detect(pixels, self.text_embeds, self.query_mask)
        conf, presence = self._splat(dets, self.class_weights, (cfg.grid_rows, cfg.grid_cols))
        return conf.reshape(secs.shape[0], -1), presence

    def score_verify_batch(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) seconds -> ONE (B*T)-image verification forward -> (conf (B,
        T), presence (B, T, C))."""
        b, t = secs.shape
        video_idx = torch.arange(b, device=secs.device).repeat_interleave(t)
        conf, presence = self.score_verify_flat(video_idx, secs.reshape(-1))
        return conf.reshape(b, t), presence.reshape(b, t, -1)

    def score_verify_flat(
        self, video_idx: torch.Tensor, secs: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W,) video indices + (W,) seconds -> one W-image verification
        forward with each image's video's text -> (conf (W,), presence (W, C))."""
        pixels = self._frame_pixels(self.cache[video_idx, secs])
        dets = self._detect(pixels, self.text_embeds[video_idx], self.query_mask[video_idx])
        conf, presence = self._splat(dets, self.class_weights[video_idx], (1, 1))
        return conf[:, 0, 0], presence[:, 0]
