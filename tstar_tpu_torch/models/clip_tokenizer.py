"""Tokenizers for the detectors' prompts (port of
``tstar_tpu/models/clip_tokenizer.py``).

``ClipTokenizer`` is CLIP's byte-level BPE, read from a checkpoint's
``vocab.json`` + ``merges.txt`` (OWL-ViT's and YOLO-World's text towers):
text NFC-normalized, lowercased and whitespace-collapsed; word tokens carry
a ``</w>`` suffix; ``encode`` gives [BOS] + ids + [EOS] cut to the context
window, ``encode_batch`` pads with id 0.

The reference pre-tokenizes with the ``regex`` package:

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]
    |[^\\s\\p{L}\\p{N}]+        (IGNORECASE)

which this port does without: ``pretokenize`` walks the text and takes, at
each position, the first alternative that matches, as the regex engine
does, and skips a character no alternative matches.  Classes are those of
``models/qwen_tokenizer.py`` (Unicode categories from ``unicodedata``;
white space as ``regex``'s ``\\s``), with IGNORECASE's one effect on them:
U+0345 COMBINING GREEK YPOGEGRAMMENI (a mark whose case partner is a
letter) matches neither ``[\\p{L}]`` nor ``[^\\s\\p{L}\\p{N}]``.  The two
special tokens match case-insensitively, by simple case folding.

``HashTokenizer`` is the stand-in of the random-weight detectors, whose
vocabulary is not in the repository.
"""

from __future__ import annotations

import functools
import html
import json
import os
import unicodedata
import zlib
from typing import Dict, List, Tuple

import numpy as np

from tstar_tpu_torch.models.qwen_tokenizer import _bytes_to_unicode, _contraction, _kind

_SPECIAL = ("<|startoftext|>", "<|endoftext|>")
_NO_CLASS = frozenset("\u0345")


@functools.lru_cache(maxsize=None)
def _folds_to(ch: str, lower: str) -> bool:
    """``ch`` equals the lowercase ASCII ``lower`` under simple case folding."""
    return ch == lower or (len(ch.casefold()) == 1 and ch.casefold() == lower)


def _clip_kind(ch: str) -> str:
    return "X" if ch in _NO_CLASS else _kind(ch)


def _special(text: str, i: int) -> int:
    for tok in _SPECIAL:
        end = i + len(tok)
        if end <= len(text) and all(_folds_to(text[i + j], c) for j, c in enumerate(tok)):
            return len(tok)
    return 0


def pretokenize(text: str) -> List[str]:
    """The reference's ``_TOKEN_PATTERN.findall(text)``."""
    out, i, n = [], 0, len(text)
    while i < n:
        m = _special(text, i) or _contraction(text, i)
        k = _clip_kind(text[i])
        if m:
            j = i + m
        elif k == "L":
            j = i + 1
            while j < n and _clip_kind(text[j]) == "L":
                j += 1
        elif k == "N":
            j = i + 1
        elif k == "O":
            j = i + 1
            while j < n and _clip_kind(text[j]) == "O":
                j += 1
        else:           # white space, or a character no alternative matches
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = unicodedata.normalize("NFC", text).strip()
    out, prev_space = [], False
    for ch in text:         # regex's \s+ -> " "
        space = _kind(ch) == "S"
        if not (space and prev_space):
            out.append(" " if space else ch)
        prev_space = space
    return "".join(out).lower()


class ClipTokenizer:
    def __init__(self, vocab_file: str, merges_file: str, context: int = 16):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # skip the version header; drop empty trailing lines
        merges = [tuple(l.split()) for l in lines[1:] if l.strip()]
        self.bpe_ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.context = context
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        self.pad_id = 0  # OWL-ViT convention: query_mask = ids[..., 0] > 0
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_dir(cls, path: str, context: int = 16) -> "ClipTokenizer":
        return cls(os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"),
                   context=context)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def tokenize(self, text: str) -> List[int]:
        """Raw BPE ids (no special tokens, no padding)."""
        ids: List[int] = []
        for tok in pretokenize(_clean_text(text)):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(mapped))
        return ids

    def encode(self, text: str) -> List[int]:
        """[BOS] + ids + [EOS], cut to the context window (no padding)."""
        ids = [self.bos_id] + self.tokenize(text) + [self.eos_id]
        if len(ids) > self.context:
            ids = ids[: self.context - 1] + [self.eos_id]
        return ids

    def encode_batch(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """-> (input_ids (Q, context) int32, attention_mask (Q, context) int32)."""
        out = np.full((len(texts), self.context), self.pad_id, np.int32)
        mask = np.zeros((len(texts), self.context), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return out, mask


class HashTokenizer:
    """Deterministic ids with CLIP's conventions: each word to a stable id in
    [1, vocab); BOS/EOS are the two highest ids so OWL-ViT's argmax EOT
    pooling works."""

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
