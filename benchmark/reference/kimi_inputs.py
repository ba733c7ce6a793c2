"""A Kimi-VL request worked out again from its words and frames: the T*
prompts (``vlm_inputs.grounding_prompt`` / ``qa_prompt``), Kimi-VL's chat
template with one media block a frame, the byte-level tokenizer stand-in,
and the frames' preprocessing.

Template (the published ``chat_template``): the default system turn, the
user turn, then the assistant's header.  Each frame is a block
``<|media_start|>image<|media_content|>``, its placeholders (one a merged
2 x 2 patch cell), ``<|media_end|>``, where the query's k-th ``<image>``
tag stands.  The seeded model has no vocabulary file, so text maps to its
ASCII bytes (ids 0-127) and the special tokens to their ids in the
configuration.  A frame keeps its resolution (under ``in_token_limit``
patches) and is padded below and to the right with zero pixels to whole
28-pixel merge cells, then normalised to [-1, 1].
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def encode(text: str, special: Dict[str, int]) -> List[int]:
    ids: List[int] = []
    for part in re.split("(" + "|".join(re.escape(s) for s in special) + ")", text):
        if part in special:
            ids.append(special[part])
        else:
            raw = part.encode("ascii")
            ids.extend(raw)
    return ids


def padded_hw(h: int, w: int, cfg: Dict) -> Tuple[int, int]:
    v = cfg["vision_config"]
    p = v["patch_size"]
    mh, mw = v["merge_kernel_size"]
    if (h // p) * (w // p) > v["in_token_limit"]:
        raise ValueError("the benchmark's frames stay under the token limit")
    return -(-h // (p * mh)) * p * mh, -(-w // (p * mw)) * p * mw


def tokens_per_frame(h: int, w: int, cfg: Dict) -> int:
    v = cfg["vision_config"]
    ph, pw = padded_hw(h, w, cfg)
    mh, mw = v["merge_kernel_size"]
    return (ph // (v["patch_size"] * mh)) * (pw // (v["patch_size"] * mw))


def request_ids(query: str, frames: Sequence[np.ndarray], cfg: Dict) -> List[int]:
    """The token ids of one request."""
    special = cfg["special_tokens"]
    n = tokens_per_frame(*np.asarray(frames[0]).shape[:2], cfg) if len(frames) else 0
    parts = query.split("<image>")
    extra = max(0, len(frames) - (len(parts) - 1))
    pieces = [("media", None)] * extra + [("text", parts[0])]
    for i, part in enumerate(parts[1:]):
        if extra + i < len(frames):
            pieces.append(("media", None))
        pieces.append(("text", part))
    # the user turn's text is stripped at both ends, as a whole
    kept = [i for i, (k, t) in enumerate(pieces) if k == "media" or t.strip()]
    body = pieces[kept[0]:kept[-1] + 1]
    if body[0][0] == "text":
        body[0] = ("text", body[0][1].lstrip())
    if body[-1][0] == "text":
        body[-1] = ("text", body[-1][1].rstrip())
    ids = encode("<|im_system|>system<|im_middle|>You are a helpful assistant<|im_end|>"
                 "<|im_user|>user<|im_middle|>", special)
    for kind, text in body:
        if kind == "media":
            ids += encode("<|media_start|>image<|media_content|>", special)
            ids += [cfg["media_placeholder_token_id"]] * n
            ids += encode("<|media_end|>", special)
        else:
            ids += encode(text, special)
    return ids + encode("<|im_end|><|im_assistant|>assistant<|im_middle|>", special)


def frame_pixels(frames: Sequence[np.ndarray], cfg: Dict) -> torch.Tensor:
    """(F, H, W, 3) float32 in [-1, 1], padded to whole merge cells."""
    x = np.stack([np.asarray(f) for f in frames]).astype(np.float32)
    ph, pw = padded_hw(x.shape[1], x.shape[2], cfg)
    out = np.zeros((x.shape[0], ph, pw, 3), np.float32)
    out[:, :x.shape[1], :x.shape[2]] = x
    return torch.as_tensor((out / 255.0 - 0.5) / 0.5)


def served(tokens: Sequence[int], cfg: Dict) -> List[int]:
    """The tokens a request served: up to and with its first stop token
    (``<|im_end|>`` or [EOS])."""
    special = cfg["special_tokens"]
    stops = (special["<|im_end|>"], special["<|endoftext|>"])
    out: List[int] = []
    for t in tokens:
        out.append(int(t))
        if t in stops:
            break
    return out
