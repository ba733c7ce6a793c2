"""Detector backend registry (port of ``tstar_tpu/framework/heuristics.py``).

A backend, given a device frame cache and the grounded objects, builds a
``Scorer`` for the search engine (the reference's
``reparameterize_object_list`` + detector binding).  Backends:

  * ``owl-vit`` / ``owlv2`` — OWL-ViT (or OWLv2) from a local Hugging Face
    checkpoint directory (``models/loader.load_owlvit_checkpoint``, with
    the CLIP BPE tokenizer);
  * ``owl-vit-random`` — OWL-ViT B/32 at full width with seeded random
    weights and the ``HashTokenizer``;
  * ``owl-vit-calibrated`` — the same random detector with its query
    embeddings calibrated to the synthetic scenes' colored objects
    (``CalibratedOwlVitHeuristic``): a working detector on those scenes,
    the measurement backend of ``tools/ab_knob_recall.py``;
  * ``yolo-world`` / ``yolo-world-v2`` — YOLO-World v2 from a local
    checkpoint directory: an mmyolo ``.pth`` plus the CLIP tokenizer's
    files, or the reference's native ``.npz`` files
    (``models/yolo_loader.py``);
  * ``yolo-world-random`` — YOLO-World v2 at size ``xl`` (v2-XL, the
    reference's evaluation detector) or ``small``, seeded random weights;
  * ``color-probe`` / ``fake`` — the weight-free detector that scores each
    second by the coverage of its objects' colors, into a ``TableScorer``
    (the hermetic end-to-end backend for the synthetic videos).

``owl-vit`` and ``yolo-world`` without a ``checkpoint_dir`` raise
ValueError, as the reference's do: random weights are an explicit opt-in
through the ``-random`` names.  Checkpoints are read from local paths only.
Every backend runs on ``device`` ("cuda" unless the caller asks for the
CPU) in ``dtype`` (bf16 unless asked otherwise).

Both detector backends also carry the reference's detector surface
(``reparameterize_object_list``, ``inference_detector``, the path-based
``inference`` and ``bbox_visualization``); PIL is imported by ``inference``
only.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tstar_tpu_torch.kernels.image import build_detector_grid
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer
from tstar_tpu_torch.models.owlvit import (
    OwlViTDetector,
    init_params,
    owlvit_base_patch32,
    postprocess_detections,
)
from tstar_tpu_torch.search.detector_scorer import (
    _weight_views,
    build_prompt_batch,
    make_owlvit_scorer,
)
from tstar_tpu_torch.search.scorers import TableScorer
from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.video.synthetic import PlantedObject, render_frame

logger = logging.getLogger(__name__)


class _DetectorCompatMixin:
    """The reference's detector surface over arrays (interface_heuristic.py):
    ``reparameterize_object_list`` sets the prompts, ``inference_detector``
    detects on HWC uint8 images."""

    texts: list = []

    def reparameterize_object_list(self, target_objects, cue_objects):
        combined = list(target_objects) + list(cue_objects)
        self.texts = [[obj.strip()] for obj in combined] + [[" "]]
        self._compat_targets = list(target_objects)
        self._compat_cues = list(cue_objects)

    def _prompt_ids(self):
        if not getattr(self, "texts", None):
            raise RuntimeError("call reparameterize_object_list first")
        ids, mask = self.tokenizer.encode_batch([t[0] for t in self.texts])
        return torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)

    @staticmethod
    def _numpy(*tensors):
        return [t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
                for t in tensors]

    def inference(self, image_path: str, score_threshold: float = 0.3, **kw):
        """Detect on one image file (the reference's defaults: threshold
        0.3; YOLO-World also ``max_dets`` 100)."""
        from PIL import Image

        with Image.open(image_path) as im:
            image = np.array(im.convert("RGB"))
        return self.inference_detector([image], score_threshold=score_threshold, **kw)[0]

    def bbox_visualization(self, images, detections_inbatch):
        """Annotated copies of the images, one label a box."""
        from tstar_tpu_torch.viz.boxes import draw_boxes

        out = []
        for image, det in zip(images, detections_inbatch):
            labels = [f"{self.texts[c][0]} {s:.2f}"
                      for c, s in zip(det["class_id"], det["confidence"]) if c < len(self.texts)]
            out.append(draw_boxes(image, det["xyxy"], labels=labels, class_ids=det["class_id"]))
        return out


class OwlVitHeuristic(_DetectorCompatMixin):
    """OWL-ViT backend: from a checkpoint (``owl-vit``) or with seeded random
    weights (``owl-vit-random``)."""

    def __init__(
        self,
        checkpoint_dir: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        model_config=None,
        device="cuda",
    ):
        self.device = torch.device(device)
        dtype = dtype or torch.bfloat16
        if checkpoint_dir:
            from tstar_tpu_torch.models.loader import load_owlvit_checkpoint

            self.name = "owl-vit"
            self.model, self.tokenizer = load_owlvit_checkpoint(checkpoint_dir, self.device, dtype)
        else:
            self.name = "owl-vit-random"
            cfg = model_config or owlvit_base_patch32()
            model = init_params(OwlViTDetector(cfg), seed)
            self.model = model.to(device=self.device, dtype=dtype)
            self.model.requires_grad_(False).eval()
            self.tokenizer = HashTokenizer(
                vocab_size=cfg.text.vocab_size, context=cfg.text.max_length
            )
        # Quantized towers and reduced-resolution views, built once per
        # (detector_quant, verify_image_size), all they depend on, and reused
        # by later searches.  The grid-input views (composed projection, K6's
        # matrices) also depend on the cache geometry and on environment
        # switches: make_owlvit_scorer builds those for every scorer.
        self._weight_views = {}

    def build_scorer(self, cache, target_objects, cue_objects, config):
        key = (config.detector_quant, config.verify_image_size)
        if key not in self._weight_views:
            self._weight_views[key] = _weight_views(self.model, config)
        return make_owlvit_scorer(
            self.model, cache, target_objects, cue_objects, self.tokenizer, config,
            weight_views=self._weight_views[key],
        )

    @torch.no_grad()
    def inference_detector(self, images, score_threshold: float = 0.005, **kw):
        """Detect on HWC uint8 images -> one {"xyxy", "confidence",
        "class_id"} dict of numpy arrays an image."""
        from tstar_tpu_torch.kernels.image import bilinear_resize, normalize_clip
        from tstar_tpu_torch.models.owlvit import postprocess_detections

        queries = self.model.encode_text(*self._prompt_ids())
        size = self.model.cfg.vision.image_size
        out = []
        for image in images:
            image = np.asarray(image)
            px = normalize_clip(bilinear_resize(torch.from_numpy(image).to(self.device),
                                                (size, size)), self.model.dtype)[None]
            logits, boxes = self.model.predict(self.model.encode_image(px), queries, None)
            scores, cls, xyxy = self._numpy(*postprocess_detections(logits, boxes, image.shape[:2]))
            keep = scores[0] > score_threshold
            out.append({"xyxy": xyxy[0][keep], "confidence": scores[0][keep],
                        "class_id": cls[0][keep]})
        self.detections_inbatch = out
        return out


class CalibratedOwlVitHeuristic(OwlVitHeuristic):
    """OWL-ViT with random frozen weights and CALIBRATED query embeddings:
    the measurement backend for the knobs that change detections
    (``detector_quant``, ``verify_image_size``), where no checkpoint can be
    loaded and ``color-probe`` bypasses the detector.

      1. calibration canvases are rendered through the search's own grid
         preprocessing (``build_detector_grid``) with the object's color
         square planted in known grid cells over background frames;
      2. the class head's logit is ``(img_hat . q_hat + s_p) c_p`` with a
         positive per-patch scale, so probing ``predict`` with the +/- basis
         queries recovers each patch's logit as an exact affine map of the
         normalized query, ``A_p . q_hat + b_p`` (``_probe_affine``);
      3. the query for an object is the unit vector that best separates
         object patches from background ones under that map: a weighted
         ridge solved on the unit sphere (trust region, its multiplier
         bisected), with two rounds of hard-negative reweighting;
      4. the ' ' padding prompt is masked;
      5. the object and background scores measured with the final query at
         grid and verification scale give ``calibration`` and the suggested
         thresholds (their midpoints).

    The host solve is numpy float64, the reference's; the probes and the
    measurement run the detector on its device in its dtype.  A random ViT
    is a deterministic, color-sensitive feature extractor, so this is a real
    detector in every architectural sense; only the features are arbitrary.
    """

    def __init__(
        self,
        color_map: Optional[Dict[str, Tuple[int, int, int]]] = None,
        dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        object_position: Tuple[float, float] = (0.5, 0.45),
        object_size: float = 0.4,
        # canvas -> object cells: global attention makes every patch's logit
        # depend on its context, so the object's cells and the surrounding
        # cells' contents vary across the calibration canvases
        cal_cells_per_canvas: Sequence[Sequence[int]] = ((5, 10), (0, 15), (3, 12), (6, 9)),
        model_config=None,
        device="cuda",
    ):
        super().__init__(checkpoint_dir=None, dtype=dtype, seed=seed,
                         model_config=model_config, device=device)
        self.name = "owl-vit-calibrated"
        self.color_map = dict(DEFAULT_COLOR_MAP if color_map is None else color_map)
        self.object_position = object_position
        self.object_size = object_size
        self.cal_cells_per_canvas = tuple(tuple(c) for c in cal_cells_per_canvas)
        self.calibration: Dict[str, Dict[str, float]] = {}
        self._dir_cache: Dict[Tuple, Dict[str, np.ndarray]] = {}

    # -- calibration -------------------------------------------------------
    def _render_cal_frame(self, hw, color=None, t: float = 0.0) -> np.ndarray:
        objs = []
        if color is not None:
            objs = [PlantedObject("cal", (0.0, 1e9), color, self.object_position,
                                  self.object_size)]
        return render_frame(t, hw, objs)

    def _patch_index(self, cell: int, config: SearchConfig) -> int:
        """Row-major patch index of the object's center within grid cell."""
        c = self.model.cfg.vision
        rows, cols = config.grid_rows, config.grid_cols
        cell_h, cell_w = c.image_size // rows, c.image_size // cols
        r, col = divmod(cell, cols)
        y = int((r + self.object_position[0]) * cell_h)
        x = int((col + self.object_position[1]) * cell_w)
        n = c.num_patches_side
        return (y // c.patch_size) * n + (x // c.patch_size)

    def _object_patch_span(self, cell, rows, cols, cache_hw):
        """-> (fully covered patch indices, touched patch indices) of the
        object square rendered in grid cell ``cell``."""
        c = self.model.cfg.vision
        ch, cw = cache_hw
        cell_h, cell_w = c.image_size // rows, c.image_size // cols
        half = max(2, int(self.object_size * min(ch, cw) / 2))
        hy, hx = half * cell_h / ch, half * cell_w / cw
        r, col = divmod(cell, cols)
        cy = (r + self.object_position[0]) * cell_h
        cx = (col + self.object_position[1]) * cell_w
        ps, n = c.patch_size, c.num_patches_side

        def span(lo, hi):
            return (range(math.ceil(lo / ps), math.floor(hi / ps)),
                    range(math.floor(lo / ps), math.ceil(hi / ps)))

        (fy, ty), (fx, tx) = span(cy - hy, cy + hy), span(cx - hx, cx + hx)
        full = [py * n + px for py in fy for px in fx]
        touched = [py * n + px for py in ty for px in tx]
        if not full:
            # an object smaller than a patch: its center patch, the one it
            # covers most
            full = [int(cy // ps) * n + int(cx // ps)]
        return full, touched

    def _cell_patches(self, cell, rows, cols):
        c = self.model.cfg.vision
        ps, n = c.patch_size, c.num_patches_side
        ph, pw = (c.image_size // rows) // ps, (c.image_size // cols) // ps
        r, col = divmod(cell, cols)
        return [(r * ph + py) * n + (col * pw + px) for py in range(ph) for px in range(pw)]

    @torch.no_grad()
    def _probe_affine(self, pixels: torch.Tensor):
        """(1, S, S, 3) canvas -> the per-patch affine logit map (A, b),
        float64 numpy.  With the +/- basis queries e_i, logit(+e_i) +
        logit(-e_i) = 2 s_p c_p and logit(+e_i) - logit(-e_i) = 2 img_i c_p,
        so the patch's logit for any normalized query is exactly
        ``A_p . q_hat + b_p`` with A_p = img_hat_p c_p and b_p = s_p c_p."""
        dq = self.model.cfg.text.hidden_size
        feats = self.model.encode_image(pixels)
        eye = torch.eye(dq, dtype=torch.float32, device=pixels.device)
        logits, _ = self.model.predict(feats, torch.cat([eye, -eye]), None)
        lp = logits[0].double().cpu().numpy()
        a = (lp[:, :dq] - lp[:, dq:]) / 2
        b = (lp[:, :dq] + lp[:, dq:]).mean(-1) / 2
        return a, b

    def _canvas(self, cal_cache: torch.Tensor, secs: np.ndarray, grid) -> torch.Tensor:
        return build_detector_grid(
            cal_cache, torch.from_numpy(secs).to(cal_cache.device), grid,
            self.model.cfg.vision.image_size, dtype=self.model.dtype,
        )

    @torch.no_grad()
    def _calibrate(self, cache_hw, names, config) -> Dict[str, np.ndarray]:
        key = (cache_hw, config.grid_rows, config.grid_cols, tuple(sorted(names)))
        if key in self._dir_cache:
            return self._dir_cache[key]

        rows, cols = config.grid_rows, config.grid_cols
        k = rows * cols
        size = self.model.cfg.vision.image_size
        dirs_by_name: Dict[str, np.ndarray] = {}
        for name in names:
            color = self.color_map.get(name)
            if color is None:
                logger.warning("owl-vit-calibrated: no color for %r", name)
                continue
            # one full cycle of background codes (second_intensity's period
            # is ceil(200 / 7) = 29 s), then the object over each of them
            npool = 29
            frames = [self._render_cal_frame(cache_hw, None, t) for t in range(npool)]
            frames += [self._render_cal_frame(cache_hw, color, t) for t in range(npool)]
            cal_cache = torch.from_numpy(np.stack(frames)).to(self.device)

            # training canvases as diverse as a search's grids (16 other
            # backgrounds a canvas, the object's cells rotating), and at
            # verification scale one frame filling the canvas (grid 1x1)
            rng_cal = np.random.default_rng(11)
            canvases = []      # (secs, cells with the object, grid rows, grid cols)
            for cells in self.cal_cells_per_canvas:
                secs_bg = rng_cal.choice(npool, size=k, replace=k > npool).astype(np.int64)
                secs_obj = secs_bg.copy()
                for cell in cells:
                    secs_obj[cell] = npool + secs_bg[cell]   # the object, same background
                canvases.append((secs_bg, (), rows, cols))
                canvases.append((secs_obj, tuple(cells), rows, cols))
            for t in (0, 10, 20):
                canvases.append((np.asarray([t]), (), 1, 1))
                canvases.append((np.asarray([npool + t]), (0,), 1, 1))

            rows_x, rows_y, rows_b = [], [], []
            for secs, obj_cells, gr, gc in canvases:
                a, b = self._probe_affine(self._canvas(cal_cache, secs, (gr, gc)))
                label = np.full(a.shape[0], -1.0)
                drop = np.zeros(a.shape[0], bool)
                for cell in obj_cells:
                    full, touched = self._object_patch_span(cell, gr, gc, cache_hw)
                    drop[touched] = True
                    label[full] = 1.0
                    drop[full] = False
                keep = ~drop
                rows_x.append(a[keep])
                rows_y.append(label[keep])
                rows_b.append(b[keep])
            a, y, b = np.concatenate(rows_x), np.concatenate(rows_y), np.concatenate(rows_b)
            q = _separating_query(a, y, b)
            dirs_by_name[name] = q.astype(np.float32)

            # the margins with the final query, scored as the splat sees them
            # (the max over a cell's patches)
            qt = torch.from_numpy(dirs_by_name[name])[None].to(self.device)
            stats = {"grid": {"obj": [], "bg": []}, "verify": {"obj": [], "bg": []}}
            for secs, obj_cells, gr, gc in canvases:
                feats = self.model.encode_image(self._canvas(cal_cache, secs, (gr, gc)))
                logits, boxes = self.model.predict(feats, qt, None)
                scores, _, _ = postprocess_detections(logits, boxes, (size, size))
                sc = scores[0].float().cpu().numpy()
                scale = "grid" if gr > 1 else "verify"
                for cell in range(gr * gc):
                    cell_max = float(sc[self._cell_patches(cell, gr, gc)].max())
                    stats[scale]["obj" if cell in obj_cells else "bg"].append(cell_max)
            cal = {
                "grid_obj_min": min(stats["grid"]["obj"]),
                "grid_bg_max": max(stats["grid"]["bg"]),
                "verify_obj_min": min(stats["verify"]["obj"]),
                "verify_bg_max": max(stats["verify"]["bg"]),
            }
            cal["grid_margin"] = cal["grid_obj_min"] - cal["grid_bg_max"]
            cal["verify_margin"] = cal["verify_obj_min"] - cal["verify_bg_max"]
            self.calibration[name] = cal
        self._dir_cache[key] = dirs_by_name
        return dirs_by_name

    def calibrate(self, cache_hw, target_objects, cue_objects, config):
        """Calibrate before the searcher is built, so that the suggested
        thresholds can seed its ``SearchConfig`` (``build_scorer`` reuses the
        result).  Returns the measured per-object statistics."""
        names = list(target_objects) + list(cue_objects)
        self._calibrate(tuple(int(d) for d in cache_hw), names, config)
        return self.calibration

    def _suggest(self, scale: str) -> float:
        stats = list(self.calibration.values())
        if not stats:
            raise RuntimeError("calibrate first (build_scorer)")
        lo = min(s[f"{scale}_obj_min"] for s in stats)
        hi = max(s[f"{scale}_bg_max"] for s in stats)
        return float((lo + hi) / 2)

    @property
    def suggested_confidence_threshold(self) -> float:
        """Midpoint of the measured verification-scale score gap (it gates
        ``verify_and_remove_target``)."""
        return self._suggest("verify")

    @property
    def suggested_detector_threshold(self) -> float:
        """Midpoint of the measured grid-scale score gap (it gates which
        detections splat and trigger verification)."""
        return self._suggest("grid")

    def build_scorer(self, cache, target_objects, cue_objects, config):
        base = super().build_scorer(cache, target_objects, cue_objects, config)
        names = list(target_objects) + list(cue_objects)
        dirs = self._calibrate(tuple(int(d) for d in cache.shape[1:3]), names, config)
        q = np.zeros(tuple(base.query_embeds.shape), np.float32)
        mask = np.zeros(tuple(base.query_mask.shape), bool)
        for i, n in enumerate(names):
            if n in dirs:
                q[i] = dirs[n]
                mask[i] = True
        return dataclasses.replace(
            base,
            query_embeds=torch.from_numpy(q).to(base.query_embeds.device, base.query_embeds.dtype),
            query_mask=torch.from_numpy(mask).to(base.query_mask.device),
        )


def _separating_query(a: np.ndarray, y: np.ndarray, b: np.ndarray,
                      gamma: float = 1.5, rounds: int = 2) -> np.ndarray:
    """The unit query that separates object rows (y = 1) from background
    rows (y = -1) of the affine logit map ``a . q + b`` (float64).

    A ridge in logit space aims each row at ``median(b) - b + gamma y``: the
    object's own shift of b adds to the margin instead of being cancelled,
    and rare hot background patches are compensated.  Object rows are
    weighted up to balance the classes.  The class head normalizes the
    query, so the weighted least squares is solved on |q| = 1 (a trust
    region: |q(lam)| falls with the ridge multiplier lam, bisected in 60
    steps on a log scale).  The splat and the verification take the max over
    a cell's patches, so a misordered row costs a whole cell: ``rounds``
    times the misordered rows' weights grow 8x and the solve repeats."""
    b_med = float(np.median(b))
    w = np.where(y > 0, (y <= 0).sum() / max((y > 0).sum(), 1), 1.0)

    def solve(w):
        aw = a * w[:, None]
        m = aw.T @ a
        r = aw.T @ (b_med - b + gamma * y)
        evals, vecs = np.linalg.eigh(m)
        rv = vecs.T @ r

        def qnorm(lam):
            return float(np.sqrt(((rv / (evals + lam)) ** 2).sum()))

        lo = 1e-9 * max(float(evals.max()), 1.0)
        if qnorm(lo) <= 1.0:
            lam = lo
        else:
            hi = 1e6 * max(float(evals.max()), 1.0)
            for _ in range(60):
                mid = np.sqrt(lo * hi)
                if qnorm(mid) > 1.0:
                    lo = mid
                else:
                    hi = mid
            lam = np.sqrt(lo * hi)
        q = vecs @ (rv / (evals + lam))
        return q / (np.linalg.norm(q) + 1e-9)

    q = solve(w)
    for _ in range(rounds):
        logit = a @ q + b
        tau = (logit[y > 0].min() + logit[y < 0].max()) / 2
        viol = ((y < 0) & (logit > tau)) | ((y > 0) & (logit < tau))
        if not viol.any():
            break
        w = np.where(viol, w * 8.0, w)
        q = solve(w)
    return q


class YoloWorldHeuristic(_DetectorCompatMixin):
    """YOLO-World v2 backend: from a checkpoint directory (``yolo-world``;
    an mmyolo ``.pth`` + CLIP tokenizer files, or native ``.npz`` files) or
    with seeded random weights (``yolo-world-random``) at ``size`` xl or
    small."""

    def __init__(self, checkpoint_dir: Optional[str] = None, size: str = "xl", seed: int = 0,
                 device="cuda", dtype: Optional[torch.dtype] = None):
        from tstar_tpu_torch.models import yoloworld as yw

        if size not in ("xl", "small"):
            raise ValueError(f"unknown yolo-world size {size!r}; choose xl | small")
        self.name = "yolo-world"
        self.device = torch.device(device)
        dtype = dtype or torch.bfloat16
        if checkpoint_dir:
            from tstar_tpu_torch.models.yolo_loader import load_yolo_world_checkpoint

            self.model, self.text_model, self.tokenizer = load_yolo_world_checkpoint(
                checkpoint_dir, size=size, device=self.device, dtype=dtype)
        else:
            cfg = yw.yoloworld_small() if size == "small" else yw.yoloworld_xl()
            text_cfg = yw.text_config(cfg, size)
            self.model = yw.init_params(yw.YoloWorldDetector(cfg), seed).to(self.device).cast(dtype)
            self.text_model = yw.init_params(
                yw.YoloTextEncoder(text_cfg, projection_dim=cfg.text_dim), seed + 1
            ).to(device=self.device, dtype=dtype)
            self.tokenizer = HashTokenizer(vocab_size=text_cfg.vocab_size,
                                           context=text_cfg.max_length)
        self.model = self.model.to(memory_format=torch.channels_last)
        self.model.requires_grad_(False).eval()
        self.text_model.requires_grad_(False).eval()

    @torch.no_grad()
    def build_scorer(self, cache, target_objects, cue_objects, config):
        from tstar_tpu_torch.search.yolo_scorer import YoloWorldScorer

        if cache.device != self.model.device:
            raise ValueError(f"cache on {cache.device}, model on {self.model.device}")
        ids, mask, weights = build_prompt_batch(target_objects, cue_objects, self.tokenizer, config)
        dev = self.device
        text_embeds = self.text_model(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
        return YoloWorldScorer(
            cache=cache, model=self.model, text_embeds=text_embeds.float(),
            query_mask=torch.from_numpy(ids[:, 0] > 0).to(dev),
            class_weights=torch.from_numpy(weights).to(dev), config=config,
        )

    @torch.no_grad()
    def inference_detector(self, images, score_threshold: float = 0.12, max_dets: int = 50, **kw):
        """Detect on HWC uint8 images -> one {"xyxy", "confidence",
        "class_id"} dict of numpy arrays an image, boxes mapped back to the
        image and clipped to it (reference search-path defaults: threshold
        0.12, at most 50)."""
        from tstar_tpu_torch.kernels.image import bilinear_resize
        from tstar_tpu_torch.models.yoloworld import postprocess_yolo

        text_embeds = self.text_model(*self._prompt_ids())
        size = self.model.cfg.image_size
        out = []
        for image in images:
            image = np.asarray(image)
            px = (bilinear_resize(torch.from_numpy(image).to(self.device), (size, size)) / 255.0)[None]
            logits, boxes = self.model(px.to(self.model.dtype), text_embeds)
            scores, cls, xyxy, keep = self._numpy(*postprocess_yolo(
                logits, boxes, None, score_threshold=score_threshold,
                nms_iou=self.model.cfg.nms_iou, max_dets=max_dets))
            k = keep[0]
            h, w = image.shape[:2]
            scale = np.asarray([w / size, h / size, w / size, h / size])
            boxes_img = np.clip(xyxy[0][k] * scale, 0.0, np.asarray([w, h, w, h], np.float64))
            out.append({"xyxy": boxes_img, "confidence": scores[0][k], "class_id": cls[0][k]})
        self.detections_inbatch = out
        return out

    def inference(self, image_path: str, score_threshold: float = 0.3, max_dets: int = 100,
                  **kw):
        return super().inference(image_path, score_threshold=score_threshold,
                                 max_dets=max_dets, **kw)


# Colors of the synthetic scenes' objects (video/synthetic.py default_scene).
DEFAULT_COLOR_MAP: Dict[str, Tuple[int, int, int]] = {
    "couch": (200, 40, 40),
    "tv": (40, 40, 200),
    "chair": (40, 200, 40),
    "table": (200, 200, 40),
    "person": (200, 40, 200),
    "lamp": (40, 200, 200),
}


class ColorProbeHeuristic:
    """Weight-free detector: a frame's confidence for an object is the share
    of its pixels within ``tolerance`` of the object's color, times
    ``gain``, clipped to 1.  It builds per-second tables for a
    ``TableScorer`` on the cache's device, so the search runs as with a
    detector."""

    def __init__(
        self,
        color_map: Optional[Dict[str, Tuple[int, int, int]]] = None,
        tolerance: float = 40.0,
        gain: float = 30.0,
        presence_threshold: float = 0.05,
        device="cuda",
    ):
        self.name = "color-probe"
        self.device = torch.device(device)
        self.color_map = dict(DEFAULT_COLOR_MAP if color_map is None else color_map)
        self.tolerance = tolerance
        self.gain = gain
        self.presence_threshold = presence_threshold

    @torch.no_grad()
    def build_scorer(self, cache, target_objects, cue_objects, config):
        names = list(target_objects) + list(cue_objects)
        q = config.max_objects
        colors = np.zeros((q, 3), np.float32)
        active = np.zeros((q,), bool)
        for i, n in enumerate(names):
            if n in self.color_map:
                colors[i] = self.color_map[n]
                active[i] = True
            else:
                logger.warning("color-probe: no color registered for %r", n)
        weights = np.full((q,), config.cue_weight, np.float32)
        weights[: len(target_objects)] = config.target_weight
        dev = cache.device
        colors_t = torch.from_numpy(colors).to(dev)
        # 32 frames at a time: (32, h, w, Q) distances, not (N, h, w, Q)
        coverage = torch.cat([
            (torch.linalg.vector_norm(chunk.float()[:, :, :, None, :] - colors_t, dim=-1)
             < self.tolerance).float().mean(dim=(1, 2))
            for chunk in cache.split(32)
        ])                                                              # (N, Q)
        raw_conf = (coverage * self.gain).clamp(0.0, 1.0) * torch.from_numpy(active).to(dev)
        presence = raw_conf > self.presence_threshold
        weighted = raw_conf * torch.from_numpy(weights).to(dev)
        # the cell max of the weighted confidences, as the splat takes it
        conf = torch.where(presence, weighted, torch.zeros_like(weighted)).amax(dim=-1)
        return TableScorer(grid_conf=conf, grid_presence=presence,
                           verify_conf=conf, verify_presence=presence)


def initialize_heuristic(heuristic_type: str = "owl-vit", **kwargs):
    """String dispatch (the reference's ``initialize_heuristic``).  Every
    backend takes ``device`` (default "cuda"), the detectors ``dtype``
    (default bf16); the checkpoint ones ``checkpoint_dir``, the random ones
    ``seed``; ``owl-vit-random`` also ``model_config``, the YOLO ones
    ``size``, ``color-probe`` and ``owl-vit-calibrated`` ``color_map``."""
    name = heuristic_type.lower()
    common = {"device": kwargs.get("device", "cuda"), "dtype": kwargs.get("dtype")}
    if name in ("owl-vit", "owlv2", "owl-v2"):
        ckpt = kwargs.get("checkpoint_dir")
        if not ckpt:
            raise ValueError(
                "initialize_heuristic('owl-vit') requires checkpoint_dir= (a local HF "
                "OWL-ViT checkpoint directory). For runs that don't need real weights, "
                "ask explicitly for initialize_heuristic('owl-vit-random')."
            )
        return OwlVitHeuristic(checkpoint_dir=ckpt, **common)
    if name == "owl-vit-random":
        return OwlVitHeuristic(checkpoint_dir=None, seed=kwargs.get("seed", 0),
                               model_config=kwargs.get("model_config"), **common)
    if name in ("yolo-world", "yolo-world-v2"):
        ckpt = kwargs.get("checkpoint_dir")
        if not ckpt:
            raise ValueError(
                "initialize_heuristic('yolo-world') requires checkpoint_dir= (an "
                "mmdet/mmyolo YOLO-World .pth or a native checkpoint directory). For "
                "random-weight runs ask explicitly for initialize_heuristic('yolo-world-random')."
            )
        return YoloWorldHeuristic(checkpoint_dir=ckpt, size=kwargs.get("size", "xl"), **common)
    if name == "yolo-world-random":
        return YoloWorldHeuristic(checkpoint_dir=None, size=kwargs.get("size", "xl"),
                                  seed=kwargs.get("seed", 0), **common)
    if name in ("color-probe", "fake"):
        return ColorProbeHeuristic(color_map=kwargs.get("color_map"), device=common["device"])
    if name == "owl-vit-calibrated":
        # the working random-weight detector of tools/ab_knob_recall.py
        return CalibratedOwlVitHeuristic(color_map=kwargs.get("color_map"),
                                         seed=kwargs.get("seed", 0), **common)
    raise NotImplementedError(f"Heuristic type '{heuristic_type}' is not implemented.")
