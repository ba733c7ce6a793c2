"""Decode-once frame cache: host video -> device memory (port of the resident
path of ``tstar_tpu/video/cache.py``).

The search only reads the 1-fps sampling grid, so the whole grid is decoded
once, in one forward sweep, into a ``(N_pad, cache_h, cache_w, 3)`` uint8
tensor on the search's device.  At the default 192x384 a 600 s video
(640 padded seconds) is ~142 MB.

A decoder is any object with ``meta`` (fps, total_frames), ``decode_sweep``,
``decode_batch`` and ``close``; ``video/synthetic.SyntheticDecoder`` is one.
This slice has no file decoder, so callers pass one with ``decoder=``.  The
streaming (host-paged) cache is a later slice: a video over the memory
budget raises unless ``cache_mode='downscale'``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from tstar_tpu_torch.utils.config import SearchConfig

logger = logging.getLogger(__name__)

# Budget for a cache on a CPU device (tests); on a CUDA device the budget is
# the free device memory less ``DEVICE_RESERVE_BYTES``.
DEFAULT_BUDGET_BYTES = 6 * 1024 ** 3
# Left free for detector weights (~0.3 GB bf16 at B/32) and activations.
DEVICE_RESERVE_BYTES = 4 * 1024 ** 3
# Step workspace of one more video in a batched search (its grid canvas and
# activations in the flat forward, and its share of the step graphs' pool).
PER_VIDEO_WORKSPACE_BYTES = 128 * 1024 ** 2
# Copies of a bucket's caches alive at once: the stacked cache beside the
# per-video ones while it is assembled, or beside the next bucket's
# prefetched caches while it searches.
BUCKET_CACHE_COPIES = 2


def device_budget_bytes(device) -> int:
    """Bytes a frame cache may take on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return max(0, int(free) - DEVICE_RESERVE_BYTES)
    return DEFAULT_BUDGET_BYTES


def per_video_hbm_budget(
    bucket_size: int, device=None, total_bytes: Optional[int] = None
) -> int:
    """Frame-cache bytes each video of a ``bucket_size``-video batched search
    may take on ``device``: the device's free memory
    (``torch.cuda.mem_get_info``, or ``total_bytes``) less a reserve for the
    weights and each video's step workspace, divided by ``bucket_size *
    BUCKET_CACHE_COPIES``, at most ``DEFAULT_BUDGET_BYTES`` (also the budget
    on a CPU device without ``total_bytes``).
    """
    if total_bytes is None:
        if device is None or torch.device(device).type != "cuda":
            return DEFAULT_BUDGET_BYTES
        total_bytes = int(torch.cuda.mem_get_info(device)[0])
    reserve = DEVICE_RESERVE_BYTES + bucket_size * PER_VIDEO_WORKSPACE_BYTES
    usable = max(total_bytes - reserve, total_bytes // 4)
    return int(min(DEFAULT_BUDGET_BYTES, usable // (bucket_size * BUCKET_CACHE_COPIES)))


@dataclasses.dataclass(frozen=True)
class FrameCache:
    frames: torch.Tensor     # (N_pad, ch, cw, 3) uint8 on the search's device
    n_valid: int             # true number of sampled seconds
    raw_fps: float           # container frame rate
    duration: float          # seconds

    @property
    def n_pad(self) -> int:
        return self.frames.shape[0]


@dataclasses.dataclass(frozen=True)
class HostFrameCache:
    """The decoded, padded cache in host memory, before the upload."""

    frames: np.ndarray
    n_valid: int
    raw_fps: float
    duration: float

    @property
    def n_pad(self) -> int:
        return self.frames.shape[0]

    def to_device(self, device) -> FrameCache:
        return FrameCache(
            frames=torch.from_numpy(self.frames).to(device),
            n_valid=self.n_valid, raw_fps=self.raw_fps, duration=self.duration,
        )


def fit_cache_hw(cache_hw: tuple, n_pad: int, budget_bytes: int) -> tuple:
    """Shrink the cache resolution (h in steps of 32, then w in steps of 128)
    until the cache fits the budget."""
    h, w = cache_hw
    while n_pad * h * w * 3 > budget_bytes and (h > 32 or w > 128):
        if h >= 64:
            h -= 32
        elif w > 128:
            w -= 128
        else:
            break
    return (h, w)


def probe_video_length(decoder, config: SearchConfig) -> tuple:
    """(n_valid, n_pad) from the decoder's header: N = int(duration * fps_s)."""
    meta = decoder.meta
    if meta.fps <= 0 or meta.total_frames <= 0:
        raise ValueError("cannot probe video: no frames or no frame rate")
    n_valid = int(meta.total_frames / meta.fps * config.sampling_fps)
    return n_valid, config.padded_frames(n_valid)


def _decoder_for(video_path: str, decoder):
    if decoder is None:
        raise NotImplementedError(
            f"no file decoder in this port yet: pass decoder= to read {video_path!r}"
        )
    return decoder


def build_frame_cache_host(
    video_path: str,
    config: SearchConfig,
    decoder=None,
    budget_bytes: int = DEFAULT_BUDGET_BYTES,
) -> HostFrameCache:
    """Probe + sweep-decode a video into a padded host cache."""
    dec = _decoder_for(video_path, decoder)
    meta = dec.meta
    n_valid, n_pad = probe_video_length(dec, config)
    k = config.frames_per_iteration
    if n_valid < k:
        raise ValueError(
            f"video too short: {n_valid}s sampled < grid size {k} (use a smaller grid)"
        )
    cache_hw = fit_cache_hw(config.cache_hw, n_pad, budget_bytes)
    if cache_hw != tuple(config.cache_hw):
        logger.warning(
            "frame cache downscaled %s -> %s to fit %.2f GB (%d seconds of video)",
            tuple(config.cache_hw), cache_hw, budget_bytes / 1024 ** 3, n_valid,
        )
    frames = dec.decode_sweep(1.0 / config.sampling_fps, n_valid, out_hw=cache_hw)
    padded = np.zeros((n_pad, *cache_hw, 3), np.uint8)
    padded[:n_valid] = frames
    return HostFrameCache(
        frames=padded, n_valid=n_valid, raw_fps=meta.fps,
        duration=meta.total_frames / meta.fps,
    )


def build_frame_cache(
    video_path: str,
    config: SearchConfig,
    device=None,
    decoder=None,
    budget_bytes: Optional[int] = None,
) -> FrameCache:
    """Decode once into a ``FrameCache`` on ``device``.

    ``cache_mode`` 'auto' and 'resident' keep the full ``cache_hw`` and raise
    when it does not fit the budget (the streaming cache is not ported yet);
    'downscale' shrinks the resolution until it fits.  The length probe
    reads ``decoder``; it does not reopen the path.
    """
    if device is None:
        raise ValueError("build_frame_cache needs an explicit device")
    mode = config.cache_mode
    if mode not in ("auto", "resident", "downscale"):
        raise ValueError(f"cache_mode={mode!r} is not supported by this port")
    dec = _decoder_for(video_path, decoder)
    if budget_bytes is None:
        budget_bytes = device_budget_bytes(device)
    n_valid, n_pad = probe_video_length(dec, config)
    h, w = config.cache_hw
    resident_bytes = n_pad * h * w * 3
    if mode != "downscale":
        if resident_bytes > budget_bytes:
            raise ValueError(
                f"frame cache for {video_path!r} needs {resident_bytes / 1024 ** 3:.2f} GB "
                f"> budget {budget_bytes / 1024 ** 3:.2f} GB; the streaming cache is "
                "not ported yet (cache_mode='downscale' shrinks the resolution)"
            )
        budget_bytes = max(budget_bytes, resident_bytes)
    return build_frame_cache_host(video_path, config, dec, budget_bytes).to_device(device)
