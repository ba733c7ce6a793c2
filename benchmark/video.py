"""A video made from a seed, served through the decoder interface the
program reads (``meta``, ``decode_batch``, ``decode_sweep``, ``close``).

Each second shows its scene's coarse random colour field (a scene lasts
``scene_seconds``) with a small change of its own, drawn at set-up; a frame
is that 6 x 12 field of uint8 blocks at the size asked for (a nearest
sample, one gather on the host), so that the decoder's own time stays a
small part of a question.  The reference reads the same frames from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Meta:
    fps: float
    total_frames: int
    width: int
    height: int

    @property
    def duration(self) -> float:
        return self.total_frames / self.fps


class SeededVideo:
    def __init__(self, seed: int, seconds: int, fps: float, hw: Tuple[int, int],
                 scene_seconds: int):
        rng = np.random.default_rng(seed)
        n_scenes = -(-seconds // scene_seconds)
        scenes = rng.random((n_scenes, 6, 12, 3), np.float32) * 255.0
        wiggle = rng.normal(0.0, 24.0, (seconds, 6, 12, 3)).astype(np.float32)
        coarse = scenes[np.arange(seconds) // scene_seconds] + wiggle
        self.coarse = np.clip(np.rint(coarse), 0, 255).astype(np.uint8)
        self.meta = Meta(fps=fps, total_frames=int(seconds * fps), width=hw[1], height=hw[0])

    def decode_batch(self, indices: Sequence[int], out_hw: Optional[tuple] = None) -> np.ndarray:
        """(K, h, w, 3) uint8 frames at ``indices``."""
        h, w = out_hw or (self.meta.height, self.meta.width)
        secs = [min(int(i / self.meta.fps), self.coarse.shape[0] - 1) for i in indices]
        rows = (np.arange(h) * self.coarse.shape[1]) // h
        cols = (np.arange(w) * self.coarse.shape[2]) // w
        return np.take(np.take(self.coarse[secs], rows, axis=1), cols, axis=2)

    def decode_sweep(self, period: float, count: int, out_hw: Optional[tuple] = None) -> np.ndarray:
        """Frames at seconds 0, period, 2 * period, ... (``count`` of them)."""
        fps = self.meta.fps
        idx = [min(int(k * period * fps), self.meta.total_frames - 1) for k in range(count)]
        return self.decode_batch(idx, out_hw)

    def close(self) -> None:
        pass
