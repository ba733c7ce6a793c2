"""Qwen2 tokenizer (port of ``tstar_tpu/models/qwen_tokenizer.py``): GPT-2-style
byte-level BPE from a checkpoint's ``vocab.json`` + ``merges.txt``.

Special tokens (``<|im_start|>`` ...) are split out before BPE.  The
reference pre-tokenizes with the ``regex`` package:

    (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}
    | ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+

which this port does without: ``pretokenize`` walks the text and takes, at
each position, the first alternative that matches, as the regex engine
does.  Classes: a letter is a character of Unicode category L*, a number one
of N* (``unicodedata``, the Unicode version of the running Python), white
space is ``str.isspace`` less U+001C-U+001F (which ``regex``'s ``\\s`` does
not match), and the contractions match case-insensitively as ``regex`` does
('S, and U+017F LATIN SMALL LETTER LONG S, for 's).
"""

from __future__ import annotations

import functools
import json
import os
import re
import unicodedata
from typing import Dict, Iterable, List, Optional

# Default special-token ids for Qwen2-VL checkpoints.
SPECIAL_TOKENS = {
    "<|endoftext|>": 151643,
    "<|im_start|>": 151644,
    "<|im_end|>": 151645,
    "<|vision_start|>": 151652,
    "<|vision_end|>": 151653,
    "<|vision_pad|>": 151654,
    "<|image_pad|>": 151655,
    "<|video_pad|>": 151656,
}

# each contraction's letters after the apostrophe, as case-insensitive sets
_CONTRACTIONS = [[{"s", "S", "ſ"}], [{"t", "T"}], [{"r", "R"}, {"e", "E"}],
                 [{"v", "V"}, {"e", "E"}], [{"m", "M"}], [{"l", "L"}, {"l", "L"}],
                 [{"d", "D"}]]
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")


@functools.lru_cache(maxsize=None)
def _kind(ch: str) -> str:
    """'L' letter, 'N' number, 'S' white space, 'O' anything else."""
    cat = unicodedata.category(ch)[0]
    if cat in "LN":
        return cat
    return "S" if ch.isspace() and ch not in _NOT_SPACE else "O"


def _contraction(text: str, i: int) -> int:
    """Length of the contraction at ``i`` (0 if none)."""
    if text[i] != "'":
        return 0
    for letters in _CONTRACTIONS:
        end = i + 1 + len(letters)
        if end <= len(text) and all(text[i + 1 + j] in s for j, s in enumerate(letters)):
            return end - i
    return 0


def _run(text: str, i: int, kind: str) -> int:
    """End of the run of ``kind`` characters starting at ``i``."""
    n = len(text)
    while i < n and _kind(text[i]) == kind:
        i += 1
    return i


def _match(text: str, i: int) -> int:
    """End of the pre-token starting at ``i``."""
    n = len(text)
    c = text[i]
    k = _kind(c)
    m = _contraction(text, i)
    if m:
        return i + m
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if k == "L":
        return _run(text, i, "L")
    if k in "SO" and c not in "\r\n" and i + 1 < n and _kind(text[i + 1]) == "L":
        return _run(text, i + 1, "L")
    # \p{N}
    if k == "N":
        return i + 1
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    j = i + 1 if c == " " and i + 1 < n and _kind(text[i + 1]) == "O" else i
    if _kind(text[j]) == "O":
        j = _run(text, j, "O")
        while j < n and text[j] in "\r\n":
            j += 1
        return j
    # white space (k == "S" here): \s*[\r\n]+, then \s+(?!\S), then \s+
    end = _run(text, i, "S")
    last_newline = max(text.rfind("\r", i, end), text.rfind("\n", i, end))
    if last_newline >= 0:
        return last_newline + 1
    if end == n or end - i == 1:
        return end
    return end - 1


def pretokenize(text: str) -> List[str]:
    """The reference's ``_PRETOKENIZE.findall(text)``."""
    out, i = [], 0
    while i < len(text):
        j = _match(text, i)
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def write_byte_vocab(directory: str, special: Optional[Dict[str, int]] = None) -> None:
    """Write a byte-level ``vocab.json`` and an empty ``merges.txt`` into
    ``directory``: a tokenizer for seeded random models, which have no
    vocabulary of their own.  With ``special`` None, ids 0-255 are the 256
    bytes and the special tokens keep the Qwen2 ids; with ``special``, a
    ``tokenizer_config.json`` puts them at its ids, ids 0-127 are the ASCII
    bytes and 128-255 two-letter tokens, so that a tiny model's output
    decodes to distinct text rather than U+FFFD for every byte above 127."""
    b2u = _bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256 if special is None else 128)}
    if special is not None:
        vocab.update({chr(97 + i % 26) + chr(97 + i // 26): 128 + i for i in range(128)})
        added = {str(i): {"content": t} for t, i in special.items()}
        with open(os.path.join(directory, "tokenizer_config.json"), "w", encoding="utf-8") as f:
            json.dump({"added_tokens_decoder": added}, f)
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")


class QwenTokenizer:
    def __init__(
        self,
        vocab_file: str,
        merges_file: str,
        special_tokens: Optional[Dict[str, int]] = None,
    ):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        start = 1 if lines and lines[0].startswith("#") else 0
        merges = [tuple(line.split()) for line in lines[start:] if line.strip()]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.special = dict(special_tokens or SPECIAL_TOKENS)
        for tok, idx in self.special.items():
            self.encoder.setdefault(tok, idx)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self._special_ids = set(self.special.values())
        self._special_re = re.compile(
            "(" + "|".join(re.escape(t) for t in sorted(self.special, key=len, reverse=True)) + ")"
        )
        self._cache: Dict[str, List[str]] = {}
        self.eos_id = self.special.get("<|im_end|>", self.special["<|endoftext|>"])
        self.pad_id = self.special["<|endoftext|>"]

    @classmethod
    def from_dir(cls, path: str) -> "QwenTokenizer":
        special = None
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            added = cfg.get("added_tokens_decoder", {})
            if added:
                special = {v["content"]: int(k) for k, v in added.items()}
        return cls(
            os.path.join(path, "vocab.json"),
            os.path.join(path, "merges.txt"),
            special_tokens=special,
        )

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        """Text -> ids; special-token strings map to their reserved ids."""
        ids: List[int] = []
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self.special:
                ids.append(self.special[part])
                continue
            for tok in pretokenize(part):
                mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        parts: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                text = "".join(buf)
                parts.append(
                    bytes(self.byte_decoder[ch] for ch in text).decode("utf-8", errors="replace")
                )
                buf.clear()

        for i in ids:
            tok = self.decoder.get(int(i), "")
            if int(i) in self._special_ids or tok in self.special:
                flush()
                if not skip_special:
                    parts.append(tok)
                continue
            buf.append(tok)
        flush()
        return "".join(parts)
