"""Scorer backed by the OWL-ViT detector over a device-resident frame cache
(port of ``tstar_tpu/search/detector_scorer.py``).

Sampled seconds are gathered from the uint8 1-fps cache, packed into one
grid image, scored by one detector forward, and the detections splatted back
to per-frame confidences and class-presence masks.  Text prompts are encoded
once when the scorer is built.

Ported: the detector in its compute dtype or quantized
(``SearchConfig.detector_quant``: 'int8' W8A8 through K4, 'w8a16'
weight-only; on one rank or sharded over a tensor-parallel mesh), at its
native size or with verification at a reduced size (``verify_image_size``:
a view of the detector with a resampled position embedding,
``models/owlvit.resize_detector``), over a resident cache; and
the grid forward's four input routes, in the reference's branch order: the
fused cache -> patch-embedding kernel K6 (``TSTAR_GRID_EMBED``), the
composed projection (``TSTAR_COMPOSED_PATCH=1``), the fused grid-pack kernel K7
(``use_pallas_preprocess=True``), and the default pixel chain.

A scorer stacked over B videos (``parallel/batched.stack_scorers``: caches,
query embeddings, masks and class weights on a leading video axis, weights
shared) scores with the flat batch methods: ``score_grid_batch`` (one grid
canvas per video, one detector forward over the B canvases with per-video
queries), ``score_verify_batch`` and ``score_verify_flat`` (any (video,
second) pairs in one forward).  ``score_grid_detailed`` and
``score_grid_batch_detailed`` also return the grid images' top detections,
for the search's history.

Streaming caches (``video/cache.StreamingFrameCache``): the scorer's
``cache`` is a (1, ch, cw, 3) placeholder, and ``step_frames`` /
``step_secs``, static device buffers that ``engine.run_search_streaming``
fills each step with the host-decoded frames of the sampled seconds, are
what the grid and the verification read.  The grid is then built by the
plain pixel chain (``build_detector_grid_frames``), never by K6, K7 or the
composed projection, which read a resident cache.  ``score_verify_raw``
rescores frames the caller decoded (``search/reference_verify.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tstar_tpu_torch.kernels.grid_embed import (
    _height_matrix,
    _width_affine,
    grid_cell_embed,
    use_grid_embed_kernel,
)
from tstar_tpu_torch.kernels.image import (
    bilinear_resize,
    build_detector_grid,
    build_detector_grid_frames,
    build_verify_batch,
    composed_patch_projection,
    grid_patch_embeddings,
    normalize_clip,
)
from tstar_tpu_torch.kernels.pallas_grid import build_detector_grid_pallas
from tstar_tpu_torch.models.owlvit import (
    OwlViTDetector,
    interpolate_position_embedding,
    postprocess_detections,
    resize_detector,
)
from tstar_tpu_torch.models.owlvit_quant import encode_image_int8, quantize_vision_tower
from tstar_tpu_torch.ops.splat import splat_detections_to_cells
from tstar_tpu_torch.utils.config import SearchConfig


def resolve_pallas_preprocess(config: SearchConfig, batched: bool = False) -> SearchConfig:
    """``use_pallas_preprocess=None`` (auto) resolves to False, and so does
    True in a batched search, as in the reference; an explicit value is kept
    otherwise."""
    if config.use_pallas_preprocess is None or (config.use_pallas_preprocess and batched):
        return dataclasses.replace(config, use_pallas_preprocess=False)
    return config


@dataclasses.dataclass
class OwlVitScorer:
    cache: torch.Tensor          # (N_pad, ch, cw, 3) uint8 1-fps frame cache
    model: OwlViTDetector
    query_embeds: torch.Tensor   # (Q, proj_dim) text embeddings
    query_mask: torch.Tensor     # (Q,) bool: real prompts
    class_weights: torch.Tensor  # (Q,) f32: target 1.0 / cue 0.5 / pad 0.5
    config: SearchConfig
    # Quantized vision tower (models/owlvit_quant.py), present iff
    # config.detector_quant is set.
    qvision: Optional[Dict[str, Any]] = None
    # Reduced-resolution verification view (config.verify_image_size): the
    # same weights with a resampled position embedding and, when quantized,
    # a matching quantized tower.  None = verify with the main model.
    verify_model: Optional[OwlViTDetector] = None
    qvision_verify: Optional[Dict[str, Any]] = None
    # Composed cache -> patch-embedding projection (``_grid_projection``,
    # opt-in through TSTAR_COMPOSED_PATCH=1): weight (s_h, s_w*3, D) in the
    # model dtype, bias (D,) f32, source patch (s_h, s_w).
    grid_proj_w: Optional[torch.Tensor] = None
    grid_proj_b: Optional[torch.Tensor] = None
    grid_src_patch: Optional[Tuple[int, int]] = None
    grid_proj_opt_in: bool = False
    # K6's folded resize + normalize matrices (``_grid_kernel_mats``, opt-in
    # through TSTAR_GRID_EMBED): width (cw*3, cell_w*3) bf16, its bias
    # (cell_w*3,) f32, height (cell_h, ch) bf16 or None at identity.
    gb_awk: Optional[torch.Tensor] = None
    gb_bias: Optional[torch.Tensor] = None
    gb_ah: Optional[torch.Tensor] = None
    # Streaming step buffer: this step's host-decoded frames (K, ch, cw, 3)
    # uint8 and their seconds (K,) int64, when the cache streams.
    step_frames: Optional[torch.Tensor] = None
    step_secs: Optional[torch.Tensor] = None

    @property
    def num_classes(self) -> int:
        return self.query_embeds.shape[-2]

    @property
    def detection_image_size(self) -> int:
        return self.model.cfg.vision.image_size

    @torch.no_grad()
    def _detect(self, pixels: torch.Tensor, model=None, qvision=None, queries=None):
        model = model or self.model
        qvision = qvision if qvision is not None else self.qvision
        if qvision is not None:
            feats = encode_image_int8(
                qvision, pixels, model.cfg, dtype=model.dtype,
                weight_only=self.config.detector_quant == "w8a16",
            )
        else:
            feats = model.encode_image(pixels)
        return self._heads(feats, model, queries)

    def _heads(self, feats: torch.Tensor, model: OwlViTDetector, queries=None):
        """Class and box heads; ``queries``: (embeds, mask) per image, else
        the scorer's own (shared, or stacked one set per video)."""
        query_embeds, query_mask = queries or (self.query_embeds, self.query_mask)
        logits, boxes = model.predict(feats, query_embeds, query_mask)
        size = model.cfg.vision.image_size
        return postprocess_detections(logits, boxes, (size, size))

    @torch.no_grad()
    def _detect_embeds(self, patch_embeds: torch.Tensor):
        """``_detect`` entered after the patch-embedding matmul (the composed
        projection and K6 compute the embeddings themselves)."""
        if self.qvision is not None:
            feats = encode_image_int8(
                self.qvision, None, self.model.cfg, dtype=self.model.dtype,
                weight_only=self.config.detector_quant == "w8a16", patch_embeds=patch_embeds,
            )
        else:
            feats = self.model.encode_patches(patch_embeds)
        return self._heads(feats, self.model)

    def _grid_embeds(self, cache: torch.Tensor, secs: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return grid_patch_embeddings(
            cache, secs, self.grid_proj_w.reshape(-1, self.grid_proj_w.shape[-1]),
            self.grid_proj_b, (cfg.grid_rows, cfg.grid_cols), self.grid_src_patch,
            dtype=self.model.dtype,
        )

    def _use_grid_embed_kernel(self, cache_shape) -> bool:
        if self.gb_awk is None or self.config.use_pallas_preprocess:
            return False
        c = self.model.cfg.vision
        return use_grid_embed_kernel(
            cache_shape, c.image_size, c.patch_size, c.hidden_size, self.config
        )

    def _grid_embeds_kernel(self, cache: torch.Tensor, secs: torch.Tensor) -> torch.Tensor:
        """K6: cache (B, N, ch, cw, 3), secs (B, K) -> (B, P, D) bf16."""
        cfg = self.config
        c = self.model.cfg.vision
        return grid_cell_embed(
            cache, secs, self.gb_awk, self.gb_bias, self.gb_ah,
            self.model.vision.patch_embedding.kernel,
            grid_shape=(cfg.grid_rows, cfg.grid_cols),
            cell_hw=(c.image_size // cfg.grid_rows, c.image_size // cfg.grid_cols),
            patch_size=c.patch_size,
        )

    @property
    def _verify_model(self) -> OwlViTDetector:
        return self.verify_model or self.model

    def _detect_verify(self, pixels: torch.Tensor, queries=None):
        """``_detect`` through the verification view (reduced-resolution model
        and matching quantized tower when configured; the main ones else)."""
        return self._detect(
            pixels, model=self._verify_model,
            qvision=self.qvision_verify if self.qvision_verify is not None else self.qvision,
            queries=queries,
        )

    def _gather_frames(self, secs: torch.Tensor) -> torch.Tensor:
        """(K,) seconds -> (K, ch, cw, 3) uint8 frames: rows of the resident
        cache, or of the streaming step buffer (each second a search asks
        for is one of the step's sampled seconds)."""
        if self.step_frames is None:
            return self.cache[secs]
        idx = torch.argmax((secs[:, None] == self.step_secs[None, :]).to(torch.int32), dim=1)
        return self.step_frames[idx]

    def _score_grid_full(self, secs: torch.Tensor):
        """(K,) seconds -> one grid image -> (conf (K,), presence (K, C), the
        grid image's raw (scores, class_ids, boxes))."""
        cfg = self.config
        grid_shape = (cfg.grid_rows, cfg.grid_cols)
        size = self.detection_image_size
        if self.step_frames is not None:
            dets = self._detect(build_detector_grid_frames(
                self._gather_frames(secs), grid_shape, size, dtype=self.model.dtype
            ))
        elif self._use_grid_embed_kernel((1,) + tuple(self.cache.shape)):
            # K6, the single video as a batch of one; reaches the batch gate
            # only under TSTAR_GRID_EMBED=force
            dets = self._detect_embeds(self._grid_embeds_kernel(self.cache[None], secs[None]))
        elif self.grid_proj_w is not None and self.grid_proj_opt_in and (
            not cfg.use_pallas_preprocess
        ):
            dets = self._detect_embeds(self._grid_embeds(self.cache, secs))
        elif cfg.use_pallas_preprocess:
            dets = self._detect(build_detector_grid_pallas(
                self.cache, secs, grid_shape, size, dtype=self.model.dtype
            ))
        else:
            dets = self._detect(build_detector_grid(
                self.cache, secs, grid_shape, size, dtype=self.model.dtype
            ))
        scores, class_ids, boxes = dets
        keep = scores[0] > cfg.detector_threshold
        conf_map, presence = splat_detections_to_cells(
            boxes[0], scores[0], class_ids[0], keep, self.class_weights,
            grid_shape=grid_shape, image_hw=(size, size),
            num_classes=self.num_classes,
        )
        return conf_map.reshape(-1), presence, (scores[0], class_ids[0], boxes[0])

    def score_grid(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K,) seconds -> one grid image -> (conf (K,), presence (K, C))."""
        conf, presence, _ = self._score_grid_full(secs)
        return conf, presence

    def score_grid_detailed(
        self, secs: torch.Tensor, max_boxes: int = 64
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """``score_grid`` + the grid image's top ``max_boxes`` raw detections
        (the reference's per-iteration detection history): {"scores",
        "class_ids", "boxes" (xyxy in detector-image pixels), "valid" (above
        the post-process threshold)}, highest score first, ties in box
        order."""
        conf, presence, raw = self._score_grid_full(secs)
        return conf, presence, _top_detections(*raw, max_boxes, self.config.detector_threshold)

    def score_verify(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T,) seconds, each rescored alone at the verification view's size."""
        if self.step_frames is not None:
            return self.score_verify_raw(self._gather_frames(secs))
        size = self._verify_model.cfg.vision.image_size
        pixels = build_verify_batch(self.cache, secs, size, dtype=self.model.dtype)
        return self._score_verify_pixels(pixels)

    def score_verify_raw(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The verification rescore of caller-decoded uint8 frames (K, h, w,
        3) at any size (``search/reference_verify.py``: raw frames at
        ``verify_hw``) -> (conf (K,), presence (K, C))."""
        size = self._verify_model.cfg.vision.image_size
        pixels = normalize_clip(bilinear_resize(frames, (size, size)), self.model.dtype)
        return self._score_verify_pixels(pixels)

    def _score_verify_pixels(
        self, pixels: torch.Tensor, queries=None, class_weights=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each image scored as a 1x1 grid: (conf (K,), presence (K, C)).

        ``splat_detections_to_cells`` with one cell, batched over the K
        images: every box lands in cell 0, so the cell max is the max over
        all kept weighted scores (floored at the map's initial 0).
        ``queries`` / ``class_weights``: per image, (K, Q, D) + (K, Q) and
        (K, Q), else the scorer's shared ones."""
        scores, class_ids, _ = self._detect_verify(pixels, queries)
        keep = scores > self.config.detector_threshold
        if class_weights is None:
            adjusted = scores * self.class_weights[class_ids]
        else:
            adjusted = scores * class_weights.gather(-1, class_ids)
        vals = torch.where(keep, adjusted, torch.zeros_like(adjusted))
        conf = vals.amax(dim=-1).clamp_min(0.0)
        presence = torch.zeros(
            scores.shape[0], self.num_classes, dtype=torch.int32, device=scores.device
        ).scatter_reduce(1, class_ids, keep.to(torch.int32), reduce="amax")
        return conf, presence > 0

    # ---- flat multi-video batch (stacked scorer) ------------------------------

    def _score_grid_batch_full(self, secs: torch.Tensor):
        """(B, K) seconds -> one grid canvas per video -> ONE detector forward
        over the B canvases with each video's queries -> (conf (B, K),
        presence (B, K, C), raw (scores, class_ids, boxes) with a leading B
        axis).  Routes as the reference's: K6 under its gate (which an image
        batch of 8 opens), the composed projection, else the pixel chain; K7
        is off in a batched search."""
        cfg = self.config
        grid_shape = (cfg.grid_rows, cfg.grid_cols)
        size = self.detection_image_size
        if self._use_grid_embed_kernel(tuple(self.cache.shape)):
            dets = self._detect_embeds(self._grid_embeds_kernel(self.cache, secs))
        elif self.grid_proj_w is not None and self.grid_proj_opt_in and (
            not cfg.use_pallas_preprocess
        ):
            dets = self._detect_embeds(
                torch.cat([self._grid_embeds(c, s) for c, s in zip(self.cache, secs)])
            )
        else:
            dets = self._detect(torch.cat([
                build_detector_grid(c, s, grid_shape, size, dtype=self.model.dtype)
                for c, s in zip(self.cache, secs)
            ]))
        scores, class_ids, boxes = dets
        keep = scores > cfg.detector_threshold
        conf_map, presence = splat_detections_to_cells(
            boxes, scores, class_ids, keep, self.class_weights,
            grid_shape=grid_shape, image_hw=(size, size), num_classes=self.num_classes,
        )
        return conf_map.reshape(secs.shape[0], -1), presence, (scores, class_ids, boxes)

    def score_grid_batch(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, K) seconds -> (conf (B, K), presence (B, K, C)): one detector
        forward over the B videos' grid canvases."""
        conf, presence, _ = self._score_grid_batch_full(secs)
        return conf, presence

    def score_grid_batch_detailed(
        self, secs: torch.Tensor, max_boxes: int = 64
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """``score_grid_batch`` + each video's top ``max_boxes`` raw
        detections, every field with a leading video axis (as
        ``score_grid_detailed``)."""
        conf, presence, raw = self._score_grid_batch_full(secs)
        return conf, presence, _top_detections(*raw, max_boxes, self.config.detector_threshold)

    def score_verify_batch(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) seconds -> ONE flat (B*T)-image verification forward ->
        (conf (B, T), presence (B, T, C))."""
        b, t = secs.shape
        video_idx = torch.arange(b, device=secs.device).repeat_interleave(t)
        conf, presence = self.score_verify_flat(video_idx, secs.reshape(-1))
        return conf.reshape(b, t), presence.reshape(b, t, -1)

    def score_verify_flat(
        self, video_idx: torch.Tensor, secs: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W,) video indices + (W,) seconds -> one W-image verification
        forward -> (conf (W,), presence (W, C)): any candidate (video, frame)
        pairs, W per forward."""
        size = self._verify_model.cfg.vision.image_size
        pixels = normalize_clip(
            bilinear_resize(self.cache[video_idx, secs], (size, size)), self.model.dtype
        )
        return self._score_verify_pixels(
            pixels, (self.query_embeds[video_idx], self.query_mask[video_idx]),
            self.class_weights[video_idx],
        )


def _top_detections(scores, class_ids, boxes, max_boxes: int, threshold: float):
    """The ``max_boxes`` highest-scoring detections along the box axis, as
    ``lax.top_k`` orders them (ties: the lower box index first; a stable
    descending sort, where ``torch.topk`` promises no order)."""
    m = min(max_boxes, scores.shape[-1])
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :m]
    top = scores.gather(-1, idx)
    return {
        "scores": top,
        "class_ids": class_ids.gather(-1, idx),
        "boxes": boxes.gather(-2, idx[..., None].expand(*idx.shape, boxes.shape[-1])),
        "valid": top > threshold,
    }


def build_prompt_batch(
    target_objects: Sequence[str],
    cue_objects: Sequence[str],
    tokenizer,
    config: SearchConfig,
):
    """Tokenize + pad the prompt set: targets first (weight 1.0), cues (0.5),
    the ' ' padding prompt (0.5), then masked zero rows up to
    ``config.max_objects``.  Target slot t of the engine's remaining mask is
    class slot t.

    Returns (ids (Q, S) int32, attention_mask (Q, S) int32, weights (Q,) f32).
    """
    n_targets = len(target_objects)
    if n_targets > config.max_targets:
        raise ValueError(
            f"{n_targets} targets > max_targets={config.max_targets}; "
            "raise SearchConfig.max_targets"
        )
    texts: List[str] = (
        [t.strip() for t in target_objects] + [c.strip() for c in cue_objects] + [" "]
    )
    if len(texts) > config.max_objects:
        raise ValueError(
            f"{len(texts)} prompts > max_objects={config.max_objects}; "
            "raise SearchConfig.max_objects"
        )
    ids, mask = tokenizer.encode_batch(texts)
    q = config.max_objects
    ids_pad = np.zeros((q, ids.shape[1]), np.int32)
    mask_pad = np.zeros((q, ids.shape[1]), np.int32)
    ids_pad[: len(texts)] = ids
    mask_pad[: len(texts)] = mask
    # padding rows attend to their first token so the text tower stays finite
    mask_pad[len(texts):, 0] = 1
    weights = np.full((q,), config.cue_weight, np.float32)
    weights[:n_targets] = config.target_weight
    return ids_pad, mask_pad, weights


def _weight_views(model: OwlViTDetector, config: SearchConfig):
    """-> (qvision, verify_model, qvision_verify) for ``config``'s
    ``detector_quant`` and ``verify_image_size``; Nones where not set.  On a
    tensor-parallel model the quantized towers are this rank's shards
    (``models/owlvit_quant``); the verification tower shares them and
    resamples only the replicated position embedding."""
    if config.detector_quant not in (None, "int8", "w8a16"):
        raise ValueError(
            f"unknown detector_quant={config.detector_quant!r}; "
            "supported: None (compute dtype), 'int8' (W8A8), 'w8a16' (weight-only)"
        )
    qvision = quantize_vision_tower(model) if config.detector_quant is not None else None
    verify_model = qvision_verify = None
    size = config.verify_image_size
    if size is not None and size != model.cfg.vision.image_size:
        verify_model = resize_detector(model, size)
        if qvision is not None:
            src = model.cfg.vision
            qvision_verify = {
                **qvision,
                "pos": interpolate_position_embedding(
                    qvision["pos"], src.num_patches_side, size // src.patch_size
                ),
            }
    return qvision, verify_model, qvision_verify


def _grid_projection(model: OwlViTDetector, cache_hw, config: SearchConfig):
    """-> (proj_w, proj_b, src_patch_hw, opt_in), or (None, None, None,
    False) when TSTAR_COMPOSED_PATCH is not "1", under
    ``use_pallas_preprocess``, or at a geometry that is not block-aligned.
    Folded on the host from the model's patch kernel (as f32)."""
    if os.environ.get("TSTAR_COMPOSED_PATCH", "0") != "1" or config.use_pallas_preprocess:
        return None, None, None, False
    c = model.cfg.vision
    if c.image_size % config.grid_rows or c.image_size % config.grid_cols:
        return None, None, None, False
    cell_hw = (c.image_size // config.grid_rows, c.image_size // config.grid_cols)
    kernel = model.vision.patch_embedding.kernel.detach().float().cpu().numpy()
    composed = composed_patch_projection(kernel, tuple(cache_hw), cell_hw, c.patch_size)
    if composed is None:
        return None, None, None, False
    w, bias, (s_h, s_w) = composed
    return (
        torch.from_numpy(w.reshape(s_h, s_w * 3, -1)).to(model.device, model.dtype),
        torch.from_numpy(bias).to(model.device),
        (s_h, s_w),
        True,
    )


def _grid_kernel_mats(model: OwlViTDetector, cache_hw, config: SearchConfig):
    """-> (gb_awk, gb_bias, gb_ah) on the model's device for K6, or (None,
    None, None) when TSTAR_GRID_EMBED is unset or "0", under
    ``use_pallas_preprocess``, or at a geometry the path does not take (the
    reference's conditions less its TPU backend check)."""
    if os.environ.get("TSTAR_GRID_EMBED", "0") == "0" or config.use_pallas_preprocess:
        return None, None, None
    c = model.cfg.vision
    if c.image_size % config.grid_rows or c.image_size % config.grid_cols:
        return None, None, None
    if 128 % c.patch_size or 3 > 128 // c.patch_size:
        return None, None, None
    ch, cw = cache_hw
    cell_h, cell_w = c.image_size // config.grid_rows, c.image_size // config.grid_cols
    awk, bias = _width_affine(cw, cell_w)
    ah = _height_matrix(ch, cell_h)
    dev = model.device
    return (
        torch.from_numpy(awk).to(dev, torch.bfloat16),
        torch.from_numpy(bias).to(dev),
        None if ah is None else torch.from_numpy(ah).to(dev, torch.bfloat16),
    )


@torch.no_grad()
def make_owlvit_scorer(
    model: OwlViTDetector,
    cache: torch.Tensor,
    target_objects: Sequence[str],
    cue_objects: Sequence[str],
    tokenizer,
    config: SearchConfig,
    weight_views=None,
) -> OwlVitScorer:
    """Tokenize the prompts, encode them once, bind the cache and weights.

    (The reference also takes a ``variables`` pytree; here the weights live
    in the module.)  The cache must be on the model's device.
    ``weight_views`` is a ``_weight_views(model, config)`` result to reuse
    (the heuristic keeps one per (detector_quant, verify_image_size)); None
    builds it here.  The grid-input views (composed projection, K6's
    matrices) depend on the cache geometry and on environment switches, so
    they are built here for every scorer.
    """
    if cache.device != model.device:
        raise ValueError(f"cache on {cache.device}, model on {model.device}")
    config = resolve_pallas_preprocess(config)
    qvision, verify_model, qvision_verify = (
        weight_views if weight_views is not None else _weight_views(model, config)
    )
    ids_pad, mask_pad, weights = build_prompt_batch(
        target_objects, cue_objects, tokenizer, config
    )
    device = model.device
    cache_hw = tuple(cache.shape[1:3])
    grid_proj_w, grid_proj_b, grid_src_patch, grid_proj_opt_in = _grid_projection(
        model, cache_hw, config
    )
    gb_awk, gb_bias, gb_ah = _grid_kernel_mats(model, cache_hw, config)
    query_embeds = model.encode_text(
        torch.from_numpy(ids_pad).to(device), torch.from_numpy(mask_pad).to(device)
    )
    return OwlVitScorer(
        cache=cache,
        model=model,
        query_embeds=query_embeds,
        query_mask=torch.from_numpy(ids_pad[:, 0] > 0).to(device),
        class_weights=torch.from_numpy(weights).to(device),
        config=config,
        qvision=qvision,
        verify_model=verify_model,
        qvision_verify=qvision_verify,
        grid_proj_w=grid_proj_w,
        grid_proj_b=grid_proj_b,
        grid_src_patch=grid_src_patch,
        grid_proj_opt_in=grid_proj_opt_in,
        gb_awk=gb_awk,
        gb_bias=gb_bias,
        gb_ah=gb_ah,
    )
