"""Decode-once frame cache: host video -> device memory (port of
``tstar_tpu/video/cache.py``).

The search only reads the 1-fps sampling grid, so the whole grid is decoded
once, in one forward sweep, into a ``(N_pad, cache_h, cache_w, 3)`` uint8
tensor on the search's device.  At the default 192x384 a 600 s video
(640 padded seconds) is ~142 MB.

A video whose full-resolution cache exceeds the memory budget streams
instead (``StreamingFrameCache``): each step's sampled seconds are
seek-decoded on the host at the FULL cache resolution and copied into a
step buffer on the device (``engine.run_search_streaming``), so memory does
not grow with the video's length.  Shrinking the resolution to fit is the
explicit ``cache_mode='downscale'``.

Videos are read from their path with the file decoder
(``video/decoder.open_video``), or from ``decoder=``: any object with
``meta`` (fps, total_frames), ``decode_sweep``, ``decode_batch`` and
``close``, such as ``video/synthetic.SyntheticDecoder``.  A decoder passed
in stays open for its owner.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.utils.profiling import trace
from tstar_tpu_torch.video.decoder import open_video, opened

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


def probe_video_length(video, config: SearchConfig) -> tuple:
    """(n_valid, n_pad) from the header alone, N = int(duration * fps_s):
    ``video`` is a path (opened and closed here) or a decoder."""
    if isinstance(video, (str, os.PathLike)):
        with opened(os.fspath(video)) as dec:
            return probe_video_length(dec, config)
    meta = video.meta
    if meta.fps <= 0 or meta.total_frames <= 0:
        raise ValueError("cannot probe video: no frames or no frame rate")
    n_valid = int(meta.total_frames / meta.fps * config.sampling_fps)
    return n_valid, config.padded_frames(n_valid)


CACHE_MODES = ("auto", "resident", "streaming", "downscale")


def full_cache_bytes(n_pad: int, config: SearchConfig) -> int:
    """Bytes of a video's cache at the full ``config.cache_hw``."""
    h, w = config.cache_hw
    return n_pad * h * w * 3


def cache_route(n_pad: int, config: SearchConfig, budget_bytes: int, what: str = "the video") -> str:
    """'streaming' or 'resident': where ``config.cache_mode`` puts a video of
    ``n_pad`` padded seconds whose cache may take ``budget_bytes``.

    'auto' streams when the full-resolution cache is over the budget,
    'streaming' always streams, 'downscale' stays resident (shrunk to fit),
    and 'resident' raises ``ValueError`` over the budget, as does an
    unknown mode.  ``what`` names the video in that error."""
    mode = config.cache_mode
    if mode not in CACHE_MODES:
        raise ValueError(f"unknown cache_mode={mode!r}")
    if mode == "downscale":
        return "resident"
    need = full_cache_bytes(n_pad, config)
    if mode == "streaming" or (mode == "auto" and need > budget_bytes):
        return "streaming"
    if need > budget_bytes:
        raise ValueError(
            f"cache_mode='resident' but {what} needs {need / 1024 ** 3:.2f} GB > "
            f"budget {budget_bytes / 1024 ** 3:.2f} GB"
        )
    return "resident"


@dataclasses.dataclass
class StreamingFrameCache:
    """Host-paged cache for a video whose full-resolution cache exceeds the
    memory budget: memory does not grow with the video's length, and the
    resolution stays the full ``cache_hw``.  ``engine.run_search_streaming``
    asks ``gather_host`` for each step's sampled seconds and copies them
    into the scorer's step buffer; only ``frames``, a (1, ch, cw, 3)
    placeholder that gives the scorer its cache shape, lives on the device.

    Reads ``decoder`` when given (its owner closes it), else opens
    ``video_path`` at the first gather and closes it in ``close``.  Not
    thread-safe: one instance per video.
    """

    video_path: str
    n_valid: int
    n_pad: int
    raw_fps: float
    duration: float
    cache_hw: tuple
    sampling_fps: float
    device: Any = "cpu"
    decoder: Any = None

    def __post_init__(self):
        self._own = None
        self._frames = torch.zeros((1, *self.cache_hw, 3), dtype=torch.uint8, device=self.device)

    @property
    def frames(self) -> torch.Tensor:
        return self._frames

    def gather_host(self, secs: Sequence[int]) -> np.ndarray:
        """(K,) sampled seconds -> (K, ch, cw, 3) uint8 host frames, the
        resident cache's rows: the same second -> frame mapping as its sweep
        (clamped to the last frame) at the same ``cache_hw``."""
        dec = self.decoder
        if dec is None:
            if self._own is None:
                self._own = open_video(self.video_path)
            dec = self._own
        meta = dec.meta
        period = 1.0 / self.sampling_fps
        idx = [min(int(int(s) * period * meta.fps), meta.total_frames - 1) for s in secs]
        return dec.decode_batch(idx, out_hw=tuple(self.cache_hw))

    def close(self) -> None:
        if self._own is not None:
            self._own.close()
            self._own = None


def build_frame_cache_host(
    video_path: str,
    config: SearchConfig,
    decoder=None,
    budget_bytes: int = DEFAULT_BUDGET_BYTES,
) -> HostFrameCache:
    """Probe + sweep-decode a video into a padded host cache (reads
    ``decoder``, else opens ``video_path``; runs off the device, so it may
    overlap a search)."""
    with opened(video_path, decoder) as dec:
        return _sweep(dec, config, budget_bytes)


def _sweep(dec, config: SearchConfig, budget_bytes: int) -> HostFrameCache:
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
):
    """Probe + decode by ``config.cache_mode``: a ``FrameCache`` on
    ``device``, or a ``StreamingFrameCache``.

    'auto' keeps a video whose full-resolution cache fits ``budget_bytes``
    (default: ``device_budget_bytes(device)``) resident and streams a longer
    one; 'resident' raises ``ValueError`` where 'auto' would stream;
    'streaming' always streams; 'downscale' shrinks the resolution until the
    cache fits.  Reads ``decoder``, else opens ``video_path``.
    """
    if device is None:
        raise ValueError("build_frame_cache needs an explicit device")
    if budget_bytes is None:
        budget_bytes = device_budget_bytes(device)
    with trace("video.cache"), opened(video_path, decoder) as dec:
        n_valid, n_pad = probe_video_length(dec, config)
        if cache_route(n_pad, config, budget_bytes, repr(video_path)) == "streaming":
            if config.cache_mode == "auto":
                logger.warning(
                    "frame cache for %s (%d s, %.2f GB at full %s) exceeds the %.2f GB "
                    "budget: streaming it at full resolution (cache_mode='downscale' "
                    "shrinks the resolution instead)", video_path, n_valid,
                    full_cache_bytes(n_pad, config) / 1024 ** 3, tuple(config.cache_hw),
                    budget_bytes / 1024 ** 3,
                )
            k = config.frames_per_iteration
            if n_valid < k:
                raise ValueError(f"video too short: {n_valid}s sampled < grid size {k}")
            meta = dec.meta
            return StreamingFrameCache(
                video_path=video_path, n_valid=n_valid, n_pad=n_pad, raw_fps=meta.fps,
                duration=meta.total_frames / meta.fps, cache_hw=tuple(config.cache_hw),
                sampling_fps=config.sampling_fps, device=device, decoder=decoder,
            )
        return _sweep(dec, config, budget_bytes).to_device(device)
