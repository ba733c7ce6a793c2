"""Tokenizer for OWL-ViT prompts (port of ``tstar_tpu/models/clip_tokenizer.py``).

Only ``HashTokenizer`` is ported: the stand-in the ``owl-vit-random``
configuration uses, since the CLIP BPE vocabulary is not in the repository.
It maps each word to a stable id in [1, vocab); BOS/EOS are the two highest
ids so OWL-ViT's argmax EOT pooling works.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np


class HashTokenizer:
    def __init__(self, vocab_size: int = 100, context: int = 16):
        self.vocab_size = vocab_size
        self.context = context
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1
        self.pad_id = 0

    def encode_batch(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """-> (input_ids (Q, context) int32, attention_mask (Q, context) int32)."""
        out = np.full((len(texts), self.context), self.pad_id, np.int32)
        mask = np.zeros((len(texts), self.context), np.int32)
        for i, t in enumerate(texts):
            words = t.lower().split() or [" "]
            ids = [self.bos_id]
            for w in words[: self.context - 2]:
                ids.append(1 + (zlib.crc32(w.encode()) % (self.vocab_size - 3)))
            ids.append(self.eos_id)
            out[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return out, mask
