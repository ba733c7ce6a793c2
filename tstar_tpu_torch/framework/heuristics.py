"""Detector backend registry (port of ``tstar_tpu/framework/heuristics.py``).

A backend, given a device frame cache and the grounded objects, builds a
``Scorer`` for the search engine (the reference's
``reparameterize_object_list`` + detector binding).  Backends:

  * ``owl-vit`` / ``owlv2`` — OWL-ViT (or OWLv2) from a local Hugging Face
    checkpoint directory (``models/loader.load_owlvit_checkpoint``, with
    the CLIP BPE tokenizer);
  * ``owl-vit-random`` — OWL-ViT B/32 at full width with seeded random
    weights and the ``HashTokenizer``;
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
only.  ``owl-vit-calibrated`` is ROADMAP queue 1 item 3 and raises.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer
from tstar_tpu_torch.models.owlvit import OwlViTDetector, init_params, owlvit_base_patch32
from tstar_tpu_torch.search.detector_scorer import (
    _weight_views,
    build_prompt_batch,
    make_owlvit_scorer,
)
from tstar_tpu_torch.search.scorers import TableScorer

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
    ``size``, ``color-probe`` ``color_map``."""
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
        raise NotImplementedError(
            "initialize_heuristic('owl-vit-calibrated') is not ported yet (ROADMAP queue 1 item 3)"
        )
    raise NotImplementedError(f"Heuristic type '{heuristic_type}' is not implemented.")
