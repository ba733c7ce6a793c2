"""The detector's prompt batch, worked out again from the words.

The seeded OWL-ViT has no vocabulary file, so its tokenizer hashes words:
each word to ``1 + crc32(word) mod (vocab - 3)``, between a begin id
(vocab - 2) and an end id (vocab - 1), the highest id so that end-of-text
pooling finds it.  The batch is the search's: targets (weight 1.0), cues
(0.5), the padding prompt " " (0.5), then empty rows up to ``max_objects``
that attend only to their first position and are masked out of the heads.
"""

from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np


def prompt_batch(targets: Sequence[str], cues: Sequence[str], vocab: int, context: int,
                 max_objects: int, target_weight: float, cue_weight: float):
    """-> (ids (Q, S) int64, attention mask (Q, S), query mask (Q,) bool,
    class weights (Q,) float32)."""
    texts = [t.strip() for t in targets] + [c.strip() for c in cues] + [" "]
    ids = np.zeros((max_objects, context), np.int64)
    mask = np.zeros((max_objects, context), np.int64)
    for i, text in enumerate(texts):
        words = text.lower().split() or [" "]
        row = [vocab - 2] + [1 + zlib.crc32(w.encode()) % (vocab - 3)
                             for w in words[:context - 2]] + [vocab - 1]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    mask[len(texts):, 0] = 1
    weights = np.full(max_objects, cue_weight, np.float32)
    weights[:len(targets)] = target_weight
    return ids, mask, ids[:, 0] > 0, weights
