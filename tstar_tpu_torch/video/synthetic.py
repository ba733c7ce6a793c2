"""Synthetic videos with planted objects, served from memory (the frame
renderer of ``tstar_tpu/video/synthetic.py``, plus a decoder over it).

``render_frame`` draws a per-second background code and colored squares
visible during known intervals.  ``SyntheticDecoder`` serves such a video
through the decoder interface ``video/cache.py`` reads
(``meta``/``decode_sweep``/``decode_batch``/``close``, like
``video/decoder.NativeDecoder``), rendering each requested frame at the
requested size: no file, no codec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from tstar_tpu_torch.video.decoder import VideoMeta


@dataclasses.dataclass(frozen=True)
class PlantedObject:
    name: str
    interval: Tuple[float, float]   # [start_sec, end_sec)
    color: Tuple[int, int, int]     # RGB
    position: Tuple[float, float]   # center, fraction of (h, w)
    size: float = 0.25              # fraction of min(h, w)


def second_intensity(sec: int) -> int:
    """Deterministic per-second background code."""
    return (sec * 7) % 200 + 20


def render_frame(
    t: float, hw: Tuple[int, int], objects: Sequence[PlantedObject]
) -> np.ndarray:
    h, w = hw
    frame = np.full((h, w, 3), second_intensity(int(t)), np.uint8)
    for obj in objects:
        if obj.interval[0] <= t < obj.interval[1]:
            cy, cx = int(obj.position[0] * h), int(obj.position[1] * w)
            half = max(2, int(obj.size * min(h, w) / 2))
            y0, y1 = max(0, cy - half), min(h, cy + half)
            x0, x1 = max(0, cx - half), min(w, cx + half)
            frame[y0:y1, x0:x1] = np.asarray(obj.color, np.uint8)
    return frame


class SyntheticDecoder:
    """In-memory video: ``duration_sec`` at ``fps``, native size ``hw``."""

    def __init__(
        self,
        duration_sec: float,
        fps: float = 10.0,
        hw: Tuple[int, int] = (360, 640),
        objects: Sequence[PlantedObject] = (),
    ):
        self.objects = list(objects)
        self.meta = VideoMeta(
            fps=fps, total_frames=int(round(duration_sec * fps)), width=hw[1], height=hw[0]
        )
        self.closed = False

    def _render(self, index: int, out_hw: Optional[tuple]) -> np.ndarray:
        if self.closed:
            raise ValueError("decoder is closed")
        hw = tuple(out_hw) if out_hw else (self.meta.height, self.meta.width)
        return render_frame(index / self.meta.fps, hw, self.objects)

    def decode_batch(self, indices: Sequence[int], out_hw: Optional[tuple] = None) -> np.ndarray:
        return np.stack([self._render(int(i), out_hw) for i in indices])

    def decode_sweep(self, period: float, count: int, out_hw: Optional[tuple] = None) -> np.ndarray:
        """Frames at seconds 0, period, 2*period, ... (count of them)."""
        fps = self.meta.fps
        idx = [min(int(k * period * fps), self.meta.total_frames - 1) for k in range(count)]
        return self.decode_batch(idx, out_hw)

    def close(self) -> None:
        self.closed = True


def default_scene(duration_sec: float = 600.0, **kw) -> SyntheticDecoder:
    """'couch' 70-80 s, 'lamp' 400-412 s, 'tv' 30-90 s and 380-430 s."""
    objects = [
        PlantedObject("couch", (70.0, 80.0), (200, 40, 40), (0.55, 0.4), 0.45),
        PlantedObject("lamp", (400.0, 412.0), (230, 220, 60), (0.4, 0.2), 0.3),
        PlantedObject("tv", (30.0, 90.0), (40, 40, 200), (0.3, 0.75), 0.25),
        PlantedObject("tv", (380.0, 430.0), (40, 40, 200), (0.3, 0.75), 0.25),
    ]
    return SyntheticDecoder(duration_sec, objects=objects, **kw)


def scene_variant(i: int, duration_sec: float = 600.0, **kw) -> SyntheticDecoder:
    """The i-th of a set of distinct videos: ``default_scene``'s objects
    moved ``53 * i`` seconds later (wrapping at the end) and, for odd i,
    mirrored left to right.  ``scene_variant(0)`` is ``default_scene``."""
    shift = 53.0 * i
    objects = []
    for o in default_scene(duration_sec).objects:
        start = (o.interval[0] + shift) % duration_sec
        end = min(start + o.interval[1] - o.interval[0], duration_sec)
        y, x = o.position
        objects.append(dataclasses.replace(
            o, interval=(start, end), position=(y, 1.0 - x if i % 2 else x)
        ))
    return SyntheticDecoder(duration_sec, objects=objects, **kw)
