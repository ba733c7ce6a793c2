"""Host-side image utilities (port of ``tstar_tpu/utils/images.py``).

Frames are read from the video file (``video/decoder.open_video``), or from
``decoder=`` when given (any object with ``meta`` (fps, total_frames),
``decode_batch`` and ``decode_sweep``, as ``KeyframeSearcher`` and
``VideoTask`` take), which stays open for its owner.  PIL is imported by the
functions that need it, never with the module.  ``resize_uint8`` is the
port's host bilinear resize (cv2's INTER_LINEAR, which the card's machine
does not have).
"""

from __future__ import annotations

import base64
import io
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tstar_tpu_torch.kernels.image import bilinear_resize
from tstar_tpu_torch.video.decoder import opened


def resize_uint8(frames: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(K, H, W, 3) uint8 -> (K, h, w, 3) uint8 on the host, bilinear
    (half-pixel centres, as cv2's INTER_LINEAR), rounded to the nearest
    level: within one level of cv2's fixed-point result."""
    x = bilinear_resize(torch.from_numpy(np.ascontiguousarray(frames)), tuple(out_hw))
    return x.round().clamp(0, 255).to(torch.uint8).numpy()


def encode_image_to_base64(image) -> str:
    """PIL.Image or (H, W, 3) uint8 array -> base64 JPEG string."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    if not hasattr(image, "save"):
        raise ValueError("Input must be a PIL.Image or numpy.ndarray")
    buf = io.BytesIO()
    image.convert("RGB").save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def load_video_frames(video_path: str, num_frames: int = 8, decoder=None) -> List[np.ndarray]:
    """``num_frames`` RGB frames sampled uniformly: frame i at index
    floor(i * total / n), the reference's rule."""
    with opened(video_path, decoder) as dec:
        total = dec.meta.total_frames
        if total <= 0:
            raise ValueError("Video has zero frames or could not retrieve frame count.")
        n = min(num_frames, total)
        step = total / n
        indices = [int(np.floor(i * step)) for i in range(n)]
        return list(dec.decode_batch(indices))


def save_as_gif(images: Sequence[np.ndarray], output_gif_path: str, fps: float = 1.0):
    """Animated GIF at ``fps`` frames a second, looping."""
    from PIL import Image

    pil = [Image.fromarray(np.asarray(img).astype(np.uint8)) for img in images]
    if not pil:
        raise ValueError("no images to save")
    pil[0].save(output_gif_path, save_all=True, append_images=pil[1:],
                duration=int(1000 / fps), loop=0)


def save_frames_as_jpegs(
    frames: Sequence[np.ndarray], timestamps: Sequence[float], out_dir: str
) -> List[str]:
    """Keyframe JPEGs named ``frame_{i}_at_{t:.2f}s.jpg``."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for idx, (frame, ts) in enumerate(zip(frames, timestamps)):
        p = os.path.join(out_dir, f"frame_{idx}_at_{ts:.2f}s.jpg")
        Image.fromarray(np.asarray(frame).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def extract_frames_from_gif(input_gif_path: str, output_dir: str) -> int:
    """A GIF's frames as PNGs under ``output_dir/<gif name>/``; returns the
    count."""
    from PIL import Image, ImageSequence

    base = os.path.basename(input_gif_path).split(".")[0]
    subdir = os.path.join(output_dir, base)
    os.makedirs(subdir, exist_ok=True)
    count = 0
    with Image.open(input_gif_path) as gif:
        for i, frame in enumerate(ImageSequence.Iterator(gif)):
            frame.convert("RGB").save(os.path.join(subdir, f"frame_{i + 1}.png"))
            count += 1
    return count


def extract_frames_at_fps(video_path: str, output_dir: str, fps: float = 1.0,
                          decoder=None) -> int:
    """A video's frames at ``fps`` a second as JPEGs ``frame_{i:04d}.jpg``;
    returns the count."""
    from PIL import Image

    with opened(video_path, decoder) as dec:
        count = int(dec.meta.total_frames / dec.meta.fps * fps)
        frames = dec.decode_sweep(1.0 / fps, count)
    os.makedirs(output_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(os.path.join(output_dir, f"frame_{i:04d}.jpg"))
    return len(frames)
