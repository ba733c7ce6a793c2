"""High-level searcher: the reference ``TStarSearcher`` API over the engine
(port of ``tstar_tpu/search/searcher.py``).

The constructor keeps the reference's signature and adds ``decoder=``: an
object the frame cache and the final keyframes are decoded from in place of
the video file (``video/synthetic.SyntheticDecoder``, say); without one the
file at ``video_path`` is read (``video/decoder.open_video``).  A video
whose full-resolution cache exceeds the memory budget (or any video under
``cache_mode='streaming'``) streams: ``search()`` then decodes each step's
sampled seconds on the host (``engine.run_search_streaming``), and
``search_with_visualization()`` raises, as the reference's does, since its
grid images are rebuilt from a resident cache.  The search runs on the
heuristic's device; its noise comes from a ``torch.Generator`` on that device seeded
with ``seed``.  On a CUDA device its steps replay CUDA graphs
(``search/step_graphs.py``); ``step_stats`` says what the last search's
steps did.

``search()`` and ``search_with_visualization()`` run the same steps and
return the same keyframes; the second also fills the reference's
per-iteration histories (``P_history``, ``Score_history``,
``non_visiting_history``, ``sampled_history`` and, for detector scorers,
``detect_bbox_iters``), which ``grid_images`` renders.  Snapshots
(``save_snapshot`` / ``restore_snapshot``) are ``search/snapshot.py``'s.
The plotting and rendering sinks import matplotlib and PIL when called.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.search.engine import (
    run_search,
    run_search_streaming,
    run_search_with_history,
)
from tstar_tpu_torch.search.state import init_state
from tstar_tpu_torch.search.step_graphs import StepStats, history_lists
from tstar_tpu_torch.utils.profiling import trace
from tstar_tpu_torch.video.cache import FrameCache, StreamingFrameCache, build_frame_cache
from tstar_tpu_torch.video.decoder import opened


class KeyframeSearcher:
    def __init__(
        self,
        video_path: str,
        heuristic,
        target_objects: Sequence[str],
        cue_objects: Sequence[str],
        search_nframes: int = 8,
        image_grid_shape: Tuple[int, int] = (4, 4),
        search_budget: float = 0.5,
        confidence_threshold: float = 0.6,
        output_dir: Optional[str] = None,
        config: Optional[SearchConfig] = None,
        seed: int = 0,
        cache: Optional[FrameCache] = None,
        decoder=None,
    ):
        self.config = dataclasses.replace(
            config or SearchConfig(),
            search_nframes=search_nframes,
            grid_rows=image_grid_shape[0],
            grid_cols=image_grid_shape[1],
            search_budget=search_budget,
            confidence_threshold=confidence_threshold,
        )
        self.video_path = video_path
        self.target_objects = list(target_objects)
        self.cue_objects = list(cue_objects)
        self.output_dir = output_dir
        self.seed = seed
        self.decoder = decoder
        self.device = heuristic.device

        self.cache = cache or build_frame_cache(
            video_path, self.config, device=self.device, decoder=decoder
        )
        self.total_frame_num = self.cache.n_valid
        self.raw_fps = self.cache.raw_fps
        self.duration = self.cache.duration
        self.fps = self.config.sampling_fps

        self.scorer = heuristic.build_scorer(
            self.cache.frames, self.target_objects, self.cue_objects, self.config
        )
        rng = torch.Generator(device=self.device).manual_seed(seed)
        self._state0 = init_state(
            self.cache.n_valid, len(self.target_objects), self.config, rng,
            n_pad=self.cache.n_pad, device=self.device,
        )
        self._final_state = None
        self.step_stats: Optional[StepStats] = None
        self.P_history: List[List[float]] = []
        self.Score_history: List[List[float]] = []
        self.non_visiting_history: List[List[float]] = []
        self.sampled_history: List[List[int]] = []
        # the grid image's detections each iteration (the reference's
        # detect_bbox_iters): {"boxes" (D, 4) xyxy in detector-image pixels,
        # "scores", "class_ids"}
        self.detect_bbox_iters: List[Dict[str, np.ndarray]] = []

    # -- introspection (reference attribute parity) -----------------------
    @property
    def _state(self):
        return self._final_state if self._final_state is not None else self._state0

    def _np(self, t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()[: self.total_frame_num]

    @property
    def P(self) -> np.ndarray:
        return self._np(self._state.P)

    @property
    def score_distribution(self) -> np.ndarray:
        return self._np(self._state.scores)

    @property
    def non_visiting_frames(self) -> np.ndarray:
        return 1.0 - self._np(self._state.visited).astype(np.float32)

    @property
    def remaining_targets(self) -> List[str]:
        mask = self._state.remaining.cpu().numpy()
        return [t for i, t in enumerate(self.target_objects) if mask[i]]

    # -- search -----------------------------------------------------------
    def search(self, graphs: Optional[bool] = None) -> Tuple[List[np.ndarray], List[float]]:
        """Full search -> (keyframes at native resolution, timestamps in s).
        ``graphs``: as ``engine.run_search`` (None: CUDA graphs on a CUDA
        device).  A streaming cache runs ``engine.run_search_streaming``."""
        self.step_stats = StepStats()
        with torch.no_grad():
            if isinstance(self.cache, StreamingFrameCache):
                try:
                    final, secs = run_search_streaming(
                        self._state0, self.scorer, self.cache, self.config, graphs,
                        self.step_stats,
                    )
                finally:
                    self.cache.close()
            else:
                final, secs = run_search(
                    self._state0, self.scorer, self.config, graphs, self.step_stats
                )
        self._final_state = final
        self._record_final_history()
        return self._materialize(secs.cpu().numpy())

    def search_with_visualization(
        self, graphs: Optional[bool] = None
    ) -> Tuple[List[np.ndarray], List[float]]:
        """``search()`` with each iteration's history kept (the same steps
        and keyframes; ``engine.run_search_with_history``)."""
        if isinstance(self.cache, StreamingFrameCache):
            raise ValueError(
                "search_with_visualization requires a device-resident frame cache (history "
                "grids re-render from cached frames); this video streams because its "
                "full-resolution cache exceeds the memory budget. Use search(), or "
                "cache_mode='downscale' to trade cache resolution for visualization."
            )
        self.step_stats = StepStats()
        with torch.no_grad():
            final, secs, history = run_search_with_history(
                self._state0, self.scorer, self.config, graphs, self.step_stats
            )
        self._final_state = final
        with trace("search.history"):
            lists = history_lists(history, self.total_frame_num)
            for dest, items in zip((self.P_history, self.Score_history,
                                    self.non_visiting_history, self.sampled_history,
                                    self.detect_bbox_iters), lists):
                dest.extend(items)
        return self._materialize(secs.cpu().numpy())

    def _record_final_history(self):
        if not self.P_history:
            self.P_history.append(self.P.tolist())
            self.Score_history.append(self.score_distribution.tolist())
            self.non_visiting_history.append(self.non_visiting_frames.tolist())

    def _materialize(self, secs: np.ndarray) -> Tuple[List[np.ndarray], List[float]]:
        """Decode the final keyframes at native resolution (from ``decoder``,
        else the video file); timestamps in s."""
        timestamps = [float(s) / self.fps for s in secs]
        frame_indices = [int(t * self.raw_fps) for t in timestamps]
        with opened(self.video_path, self.decoder) as dec:
            return list(dec.decode_batch(frame_indices)), timestamps

    # -- snapshot / resume ----------------------------------------------------
    def save_snapshot(self, path: str) -> str:
        """Save the current search state (``search/snapshot.py``)."""
        from tstar_tpu_torch.search.snapshot import save_state

        return save_state(self._state, path)

    def restore_snapshot(self, path: str) -> None:
        """Resume from a snapshot: the next search continues its trajectory
        (the generator's state is part of the snapshot)."""
        from tstar_tpu_torch.search.snapshot import load_state

        self._state0 = load_state(path, self.device)
        self._final_state = None

    # -- artifacts ------------------------------------------------------------
    def plot_score_distribution(self, save_path: Optional[str] = None):
        from tstar_tpu_torch.viz.artifacts import plot_score_distribution

        plot_score_distribution(self.score_distribution, self.duration, save_path=save_path)

    def grid_images(self, annotate: bool = True) -> List[np.ndarray]:
        """Each iteration's grid image rebuilt from the frame cache; with
        ``annotate`` and a detection history, each carries its iteration's
        boxes and labels (the reference's annotated search GIF)."""
        from tstar_tpu_torch.viz.artifacts import render_grid_image
        from tstar_tpu_torch.viz.boxes import draw_boxes

        cache = self.cache.frames.cpu()
        rows, cols = self.config.grid_rows, self.config.grid_cols
        grids = [render_grid_image(cache, secs, (rows, cols), cell_hw=self.config.cell_hw)
                 for secs in self.sampled_history]
        det_size = getattr(self.scorer, "detection_image_size", None)
        if not annotate or not self.detect_bbox_iters or det_size is None:
            return grids
        names = self.target_objects + self.cue_objects + [" "]
        ch, cw = self.config.cell_hw
        sx, sy = cols * cw / det_size, rows * ch / det_size
        out = []
        for grid, dets in zip(grids, self.detect_bbox_iters):
            boxes = np.asarray(dets["boxes"], np.float64) * [sx, sy, sx, sy]
            labels = [f"{names[c] if c < len(names) else c} {s:.2f}"
                      for c, s in zip(dets["class_ids"], dets["scores"])]
            out.append(draw_boxes(grid, boxes, labels=labels, class_ids=list(dets["class_ids"])))
        out.extend(grids[len(out):])
        return out

    @property
    def detect_annotot_iters(self) -> List[np.ndarray]:
        """Annotated grid per iteration (the reference's attribute name,
        sic)."""
        return self.grid_images(annotate=True)


TStarSearcher = KeyframeSearcher
