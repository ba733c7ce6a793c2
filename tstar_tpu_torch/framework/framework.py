"""TStarFramework: the end-to-end pipeline and its public API (port of
``tstar_tpu/framework/framework.py``).

    grounder VLM -> target and cue objects
      -> decode-once frame cache -> T* keyframe search -> keyframe timestamps
      -> QA VLM on the keyframes -> answer

``TStarFramework(video_path, heuristic, grounder, question, options, ...)``
keeps the reference's signature, method set (``get_grounded_objects``,
``initialize_videoSearcher``, ``perform_search``, ``perform_qa``, ``run``)
and ``run()``'s result (``{"Grounding Objects", "Frame Timestamps",
"Answer"}``), and adds:

  * ``decoder=``: an object the grounder's frames, the frame cache and the
    keyframes are decoded from in place of the file at ``video_path``
    (``video/synthetic.SyntheticDecoder``, say); without one the file is
    read (``video/decoder.open_video``);
  * ``device=`` ("cuda" unless the caller asks for the CPU): the device the
    heuristic must run on, whose work each stage's time includes.

``run_tstar`` builds the grounder and the heuristic by name, both on
``device``; there is no CPU fallback.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tstar_tpu_torch.framework.heuristics import initialize_heuristic
from tstar_tpu_torch.grounding.universal import UniversalGrounder
from tstar_tpu_torch.search.searcher import KeyframeSearcher
from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.utils.profiling import StageTimer

logger = logging.getLogger(__name__)


def _safe_dirname(text: str) -> str:
    """A filesystem-safe run directory name from a question."""
    text = text.strip().rstrip("?")
    return re.sub(r"[^\w\s-]", "", text)[:120].strip() or "question"


def _require_device(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA device is available; pass device='cpu' "
            "to run on the CPU"
        )


class TStarFramework:
    def __init__(
        self,
        video_path: str,
        heuristic,
        grounder,
        question: str,
        options: str,
        search_nframes: int = 8,
        grid_rows: int = 4,
        grid_cols: int = 4,
        output_dir: str = "./output",
        confidence_threshold: float = 0.6,
        search_budget: float = 1000,
        config: Optional[SearchConfig] = None,
        seed: int = 0,
        save_artifacts: bool = True,
        decoder=None,
        device="cuda",
    ):
        self.device = torch.device(device)
        _require_device(self.device)
        heuristic_device = getattr(heuristic, "device", None)
        if heuristic_device is not None and torch.device(heuristic_device).type != self.device.type:
            raise ValueError(f"the heuristic runs on {heuristic_device}, the framework on {device}")
        self.video_path = video_path
        self.heuristic = heuristic
        self.grounder = grounder
        self.question = question
        self.options = options
        self.search_nframes = search_nframes
        self.grid_rows = grid_rows
        self.grid_cols = grid_cols
        self.confidence_threshold = confidence_threshold
        self.search_budget = search_budget
        self.config = config
        self.seed = seed
        self.save_artifacts = save_artifacts
        self.decoder = decoder
        video_name = os.path.basename(video_path).split(".")[0]
        self.output_dir = os.path.join(output_dir, video_name, _safe_dirname(question))
        os.makedirs(self.output_dir, exist_ok=True)
        self.results: dict = {}
        self.video_searcher: Optional[KeyframeSearcher] = None

    # -- steps (the reference's method names) ---------------------------------
    def get_grounded_objects(self) -> Tuple[List[str], List[str]]:
        targets, cues = self.grounder.inference_query_grounding(
            video_path=self.video_path, question=self.question, options=self.options,
            decoder=self.decoder,
        )
        self.results["Grounding Objects"] = {"target_objects": targets, "cue_objects": cues}
        logger.info("Target objects: %s", targets)
        logger.info("Cue objects: %s", cues)
        return targets, cues

    def initialize_videoSearcher(
        self, target_objects: Sequence[str], cue_objects: Sequence[str]
    ) -> KeyframeSearcher:
        # The budget goes through verbatim: the searcher computes min(1000,
        # N * search_budget) for a fraction (0.5) and for the framework's int
        # default (1000, the full 1000-frame cap for any N >= 1) alike.
        budget = float(self.search_budget)
        cfg = dataclasses.replace(self.config or SearchConfig(), search_budget=budget)
        self.video_searcher = KeyframeSearcher(
            video_path=self.video_path,
            heuristic=self.heuristic,
            target_objects=list(target_objects),
            cue_objects=list(cue_objects),
            search_nframes=self.search_nframes,
            image_grid_shape=(self.grid_rows, self.grid_cols),
            search_budget=budget,
            confidence_threshold=self.confidence_threshold,
            output_dir=self.output_dir,
            config=cfg,
            seed=self.seed,
            decoder=self.decoder,
        )
        return self.video_searcher

    def perform_search(
        self, video_searcher: KeyframeSearcher, visualization: bool = False
    ) -> Tuple[List[np.ndarray], List[float]]:
        if visualization:
            frames, timestamps = video_searcher.search_with_visualization()
            if self.save_artifacts:
                self._save_frames(frames, timestamps)
                self._save_searching_iterations(video_searcher)
                self._plot_and_save_scores(video_searcher)
        else:
            frames, timestamps = video_searcher.search()
        logger.info("Found %d frames, timestamps: %s", len(frames), timestamps)
        return frames, timestamps

    def perform_qa(self, frames: List[np.ndarray]) -> str:
        return self.grounder.inference_qa(
            frames=frames, question=self.question, options=self.options
        )

    # -- artifact sinks ---------------------------------------------------------
    def _save_frames(self, frames, timestamps):
        from tstar_tpu_torch.utils.images import save_frames_as_jpegs

        for p in save_frames_as_jpegs(frames, timestamps, os.path.join(self.output_dir, "frames")):
            logger.info("Saved frame to %s", p)

    def _save_searching_iterations(self, video_searcher: KeyframeSearcher):
        from tstar_tpu_torch.viz.artifacts import save_search_gif

        grids = video_searcher.grid_images()
        if grids:
            path = os.path.join(self.output_dir, "search_iterations.gif")
            save_search_gif(grids, path)
            logger.info("Saved search iterations GIF to %s", path)

    def _plot_and_save_scores(self, video_searcher: KeyframeSearcher):
        path = os.path.join(self.output_dir, "score_distribution.png")
        video_searcher.plot_score_distribution(save_path=path)
        logger.info("Score distribution plot saved to %s", path)

    # -- entry ------------------------------------------------------------------
    def run(self) -> dict:
        timer = StageTimer(self.device)
        with timer.stage("grounding"):
            targets, cues = self.get_grounded_objects()
        with timer.stage("decode_and_setup"):
            searcher = self.initialize_videoSearcher(targets, cues)
        with timer.stage("search"):
            frames, timestamps = self.perform_search(searcher, visualization=True)
        with timer.stage("qa"):
            answer = self.perform_qa(frames)
        logger.info("Answer: %s", answer)
        self.results["Timings"] = timer.report()
        logger.info("Stage timings: %s", self.results["Timings"])
        return {
            "Grounding Objects": {"target_objects": targets, "cue_objects": cues},
            "Frame Timestamps": timestamps,
            "Answer": answer,
        }


def run_tstar(
    video_path: str,
    question: str,
    options: str,
    grounder: str = "gpt-4o",
    heuristic: str = "owl-vit",
    search_nframes: int = 8,
    grid_rows: int = 4,
    grid_cols: int = 4,
    confidence_threshold: float = 0.6,
    search_budget: float = 0.5,
    output_dir: str = "./output",
    seed: int = 0,
    config: Optional[SearchConfig] = None,
    decoder=None,
    device="cuda",
    **heuristic_kwargs,
) -> dict:
    """One-shot API: the grounder and the heuristic built by name on
    ``device``, then ``TStarFramework.run()``."""
    _require_device(torch.device(device))
    grounder_obj = UniversalGrounder(model_name=grounder, device=device)
    heuristic_obj = initialize_heuristic(heuristic, device=device, **heuristic_kwargs)
    fw = TStarFramework(
        video_path=video_path,
        grounder=grounder_obj,
        heuristic=heuristic_obj,
        question=question,
        options=options,
        search_nframes=search_nframes,
        grid_rows=grid_rows,
        grid_cols=grid_cols,
        output_dir=output_dir,
        confidence_threshold=confidence_threshold,
        search_budget=search_budget,
        seed=seed,
        config=config,
        decoder=decoder,
        device=device,
    )
    return fw.run()
