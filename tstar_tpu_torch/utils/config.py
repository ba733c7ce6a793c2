"""Typed configuration of the T* search (port of ``SearchConfig`` in
``tstar_tpu/utils/config.py``).

A copy of the reference's dataclass with the same fields, defaults and
helper methods, so the port imports nothing of the JAX package.  The
reference's default values follow its source (reference ``TStar/
interface_searcher.py``, ``run_TStarDemo.py``, ``run_TStar_onDataset.py``);
the comments below are the reference's.  ``FrameworkConfig``,
``demo_config`` and ``dataset_config`` configure the whole pipeline
(``framework/framework.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Static configuration of the T* search engine."""

    # --- core search knobs (reference defaults) ---
    search_nframes: int = 8
    grid_rows: int = 4
    grid_cols: int = 4
    confidence_threshold: float = 0.6
    search_budget: float = 0.5        # fraction of 1-fps frames; see budget_frames()
    budget_cap: int = 1000            # hard cap on scored frames (interface_searcher.py:70)
    sampling_fps: float = 1.0         # score-grid rate (interface_searcher.py:57)

    # --- distribution update (reference constants) ---
    window_size: int = 5              # neighborhood half-width for score splat
    spline_smoothing: float = 0.5     # residual target of the smoother
    score_init: float = 1e-6          # initial per-second score
    p_init_scale: float = 0.3         # P init = confidence_threshold * p_init_scale
    top_percentile: float = 75.0      # quartile used for window splat + sampling mask

    # --- detector-facing constants ---
    target_weight: float = 1.0
    cue_weight: float = 0.5
    detector_threshold: float = 0.005  # OWL-ViT post-process score threshold

    # Detector weight quantization.  None = the detector in its compute
    # dtype; "int8" runs the vision encoder's dense layers as W8A8
    # (models/owlvit_quant.py, kernel K4); "w8a16" keeps activations in the
    # compute dtype and only the weights in int8.
    detector_quant: Optional[str] = None

    # Verification image size.  None = the detector's native size (768 for
    # OWL-ViT B/32).  A smaller side (e.g. 512) runs the verification rescore
    # with a resampled position embedding (models/owlvit.resize_detector);
    # it shifts verification confidences slightly.
    verify_image_size: Optional[int] = None

    # Batched search: None/True rescores candidates of all videos as one
    # flat list; False uses per-video buckets (batched search is a later
    # slice of the port).
    verify_flat: Optional[bool] = None

    # Verification rescore batch.  None = rescore all K sampled frames in one
    # forward whenever any frame triggers; an int T rescores only the
    # candidate frames, T at a time.
    verify_batch: Optional[int] = 8

    # Adaptive verification width: take the one-forward path when more than
    # K/2 frames are candidates (trajectory-identical either way).
    verify_adaptive: bool = True

    # --- fixed-shape padding ---
    max_objects: int = 16             # targets + cues + padding prompt, padded
    max_targets: int = 8              # remaining-target mask length, padded
    frame_pad_multiple: int = 128     # pad N (video seconds) to this multiple

    # --- pixel pipeline geometry (reference sizes) ---
    cell_hw: Tuple[int, int] = (95, 200)      # grid cell size (interface_searcher.py:186)
    frame_hw: Tuple[int, int] = (380, 800)    # sampled-frame resize (interface_searcher.py:362)
    verify_hw: Tuple[int, int] = (285, 600)   # verification resize (interface_searcher.py:403)
    # Device frame-cache resolution (>= the 192 px detector cell both ways).
    cache_hw: Tuple[int, int] = (192, 384)
    # Frame-cache residency policy: "auto", "resident", "streaming" or
    # "downscale" (the port has the resident cache, and "downscale").
    cache_mode: str = "auto"

    # --- engine behaviour (ours) ---
    deterministic_pop: bool = False   # True: top-k keyframes instead of sampled
    max_iterations: Optional[int] = None  # override; default derived from budget
    # Fused gather + resize + normalize + pack kernel (K7).  None resolves to off.
    use_pallas_preprocess: Optional[bool] = None

    @property
    def frames_per_iteration(self) -> int:
        return self.grid_rows * self.grid_cols

    def budget_frames(self, total_frame_num: int) -> int:
        """Scored-frame budget: min(cap, N * fraction) (interface_searcher.py:70)."""
        return int(min(self.budget_cap, total_frame_num * self.search_budget))

    def iteration_cap(self, total_frame_num: int) -> int:
        """Max search iterations implied by the budget (ceil division)."""
        if self.max_iterations is not None:
            return self.max_iterations
        per = self.frames_per_iteration
        return max(1, -(-self.budget_frames(total_frame_num) // per))

    def padded_frames(self, total_frame_num: int) -> int:
        m = self.frame_pad_multiple
        return max(m, ((total_frame_num + m - 1) // m) * m)


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """End-to-end framework configuration (grounder + searcher + QA)."""

    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)

    grounder: str = "gpt-4o"           # backend name, substring-dispatched
    heuristic: str = "owl-vit"         # detector backend name
    grounding_num_frames: int = 8      # frames shown to the grounder VLM
    qa_temperature: float = 0.2        # QA sampling temperature
    qa_max_tokens: int = 30            # QA generation cap (interface_grounding.py:443)
    output_dir: str = "./output"
    save_artifacts: bool = True        # keyframe JPEGs / GIF / score plot
    seed: int = 0                      # PRNG seed for the search (ours; reference unseeded)


def demo_config(**overrides) -> FrameworkConfig:
    """Defaults matching the demo CLI (run_TStarDemo.py:14-31)."""
    search = SearchConfig(confidence_threshold=0.6, search_budget=0.5)
    return dataclasses.replace(FrameworkConfig(search=search), **overrides)


def dataset_config(**overrides) -> FrameworkConfig:
    """Defaults matching the dataset runner (run_TStar_onDataset.py:154-178)."""
    search = SearchConfig(confidence_threshold=0.7, search_budget=1.0)
    return dataclasses.replace(FrameworkConfig(search=search), **overrides)
