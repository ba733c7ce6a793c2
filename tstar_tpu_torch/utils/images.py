"""Frame loading for the grounder (port of ``load_video_frames`` in
``tstar_tpu/utils/images.py``).

The port has no file decoder yet (ROADMAP queue 1 item 4): the caller
passes ``decoder=`` (any object with ``meta.total_frames`` and
``decode_batch``, as ``KeyframeSearcher`` and ``VideoTask`` take), which
stays open for its owner.
"""

from __future__ import annotations

from typing import List

import numpy as np

from tstar_tpu_torch.video.cache import _decoder_for


def load_video_frames(video_path: str, num_frames: int = 8, decoder=None) -> List[np.ndarray]:
    """``num_frames`` RGB frames sampled uniformly: frame i at index
    floor(i * total / n), the reference's rule."""
    dec = _decoder_for(video_path, decoder)
    total = dec.meta.total_frames
    if total <= 0:
        raise ValueError("Video has zero frames or could not retrieve frame count.")
    n = min(num_frames, total)
    step = total / n
    indices = [int(np.floor(i * step)) for i in range(n)]
    return list(dec.decode_batch(indices))
