"""High-level searcher: the reference ``TStarSearcher`` API over the engine
(port of ``tstar_tpu/search/searcher.py``, ``search()`` path).

The constructor keeps the reference's signature and adds ``decoder=``: the
object ``video/cache.py`` decodes the frame cache from and that
``_materialize`` decodes the final keyframes from (this slice has no file
decoder).  The search runs on the heuristic's device; its noise comes from a
``torch.Generator`` on that device seeded with ``seed``.  On a CUDA device
its steps replay CUDA graphs (``search/step_graphs.py``); ``step_stats``
says what the last search's steps did.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.search.engine import run_search
from tstar_tpu_torch.search.state import init_state
from tstar_tpu_torch.search.step_graphs import StepStats
from tstar_tpu_torch.video.cache import FrameCache, build_frame_cache


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
        device)."""
        self.step_stats = StepStats()
        with torch.no_grad():
            final, secs = run_search(
                self._state0, self.scorer, self.config, graphs, self.step_stats
            )
        self._final_state = final
        return self._materialize(secs.cpu().numpy())

    def _materialize(self, secs: np.ndarray) -> Tuple[List[np.ndarray], List[float]]:
        """Decode the final keyframes at native resolution; timestamps in s."""
        if self.decoder is None:
            raise NotImplementedError(
                "no file decoder in this port yet: pass decoder= to KeyframeSearcher"
            )
        timestamps = [float(s) / self.fps for s in secs]
        frame_indices = [int(t * self.raw_fps) for t in timestamps]
        return list(self.decoder.decode_batch(frame_indices)), timestamps


TStarSearcher = KeyframeSearcher
