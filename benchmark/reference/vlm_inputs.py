"""A VLM request worked out again from its words and frames: the T* prompts,
LLaVA-OneVision's chat template with the video block, a byte-level
tokenizer, and the frames' preprocessing.

The prompts are the T* reference grounder's (``interface_grounding.py``:
the grounding prompt asking for key and cue objects, the multiple-choice QA
prompt).  The seeded language model has no vocabulary file, so its
tokenizer maps text to its UTF-8 bytes (ids 0-255) and Qwen2's special
tokens to their ids.  The frames go in as one video block at the start of
the user turn: ``frames x pooled tokens + 1`` video tokens.  Each frame is
resized to the tower's side with OpenCV's bicubic (a = -0.75, half-pixel
centres, border replicated, rounded to uint8) and normalised to [-1, 1].
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

SPECIAL = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645}
VIDEO_TOKEN = 151647
STOP_TOKENS = (151645, 151643)


def grounding_prompt(question: str, options: Optional[str], num_frames: int) -> str:
    prompt = ("Here is a video:\n" + "\n".join(["<image>"] * num_frames)
              + "\nHere is a question about the video:\n" + f"Question: {question}\n")
    if options and len(options) > 1:
        prompt += f"Options: {options}\n"
    return prompt + (
        "\nWhen answering this question about the video:\n"
        "1. Identify key objects that can locate the answer (list key objects, separated by "
        "commas).\n"
        "2. Identify cue objects that might be near the key objects and appear in the scenes "
        "(list cue objects, separated by commas).\n\n"
        "Provide your answer in two lines, listing the key objects and cue objects separated "
        "by commas.")


def qa_prompt(question: str, options: str, num_frames: int) -> str:
    return ("Select the best answer to the following multiple-choice question based on the "
            "video.\n" + "\n".join(["<image>"] * num_frames)
            + f"\nQuestion: {question}\n" + f"Options: {options}\n\n"
            + "Answer with the option's letter from the given choices directly.")


def encode(text: str) -> List[int]:
    ids: List[int] = []
    for part in re.split("(" + "|".join(re.escape(s) for s in SPECIAL) + ")", text):
        ids.extend([SPECIAL[part]] if part in SPECIAL else list(part.encode("utf-8")))
    return ids


def request_ids(query: str, n_frames: int, tokens_per_frame: int) -> List[int]:
    """The token ids of one request: the chat template around the query,
    the video block first in the user turn."""
    text = query.replace("<image>", "").strip()
    head = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n"
    tail = f"\n{text}<|im_end|>\n<|im_start|>assistant\n"
    if not n_frames:
        return encode(head + text + "<|im_end|>\n<|im_start|>assistant\n")
    return encode(head) + [VIDEO_TOKEN] * (n_frames * tokens_per_frame + 1) + encode(tail)


def frame_pixels(frames: Sequence[np.ndarray], side: int) -> torch.Tensor:
    """(F, side, side, 3) float32 in [-1, 1]."""
    x = torch.as_tensor(np.stack([np.asarray(f) for f in frames])).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(side, side), mode="bicubic", align_corners=False)
    x = torch.round(x).clamp(0, 255)
    return (x / 255.0 - 0.5).div(0.5).permute(0, 2, 3, 1).contiguous()


def served(tokens: Sequence[int]) -> List[int]:
    """The tokens a request served: up to and with its first stop token."""
    out: List[int] = []
    for t in tokens:
        out.append(int(t))
        if t in STOP_TOKENS:
            break
    return out


def tokens_per_frame(cfg: Dict) -> int:
    v = cfg["vision_config"]
    side = -(-(v["image_size"] // v["patch_size"]) // 2)
    return side * side
