"""Detector backend registry (port of ``tstar_tpu/framework/heuristics.py``).

A backend, given a device frame cache and the grounded objects, builds a
``Scorer`` for the search engine.  This slice ports ``owl-vit-random``: the
OWL-ViT B/32 architecture at full width with seeded random weights and the
``HashTokenizer`` (real checkpoints and the CLIP vocabulary are not in the
repository).  ``owl-vit`` needs a checkpoint and raises, as the reference
does without one.
"""

from __future__ import annotations

from typing import Optional

import torch

from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer
from tstar_tpu_torch.models.owlvit import OwlViTDetector, init_params, owlvit_base_patch32
from tstar_tpu_torch.search.detector_scorer import _weight_views, make_owlvit_scorer


class OwlVitHeuristic:
    """OWL-ViT backend with random weights (``owl-vit-random``)."""

    def __init__(
        self,
        checkpoint_dir: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        model_config=None,
        device="cuda",
    ):
        if checkpoint_dir:
            raise NotImplementedError(
                "loading an OWL-ViT checkpoint is not ported yet; use owl-vit-random"
            )
        self.name = "owl-vit-random"
        self.device = torch.device(device)
        cfg = model_config or owlvit_base_patch32()
        model = init_params(OwlViTDetector(cfg), seed)
        self.model = model.to(device=self.device, dtype=dtype or torch.bfloat16)
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


def initialize_heuristic(heuristic_type: str = "owl-vit", **kwargs):
    """String dispatch (the reference's ``initialize_heuristic``).

    ``owl-vit-random`` takes ``seed``, ``device`` (default "cuda"), ``dtype``
    (default bf16) and ``model_config``.
    """
    name = heuristic_type.lower()
    if name in ("owl-vit", "owlv2", "owl-v2"):
        raise ValueError(
            "initialize_heuristic('owl-vit') requires a checkpoint, which this "
            "port cannot load yet; ask explicitly for 'owl-vit-random'"
        )
    if name == "owl-vit-random":
        return OwlVitHeuristic(
            checkpoint_dir=None,
            seed=kwargs.get("seed", 0),
            device=kwargs.get("device", "cuda"),
            dtype=kwargs.get("dtype"),
            model_config=kwargs.get("model_config"),
        )
    raise NotImplementedError(f"Heuristic type '{heuristic_type}' is not ported.")
