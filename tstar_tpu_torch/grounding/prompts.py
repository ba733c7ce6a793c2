"""Prompt construction + response parsing for grounding and QA (a copy of
``tstar_tpu/grounding/prompts.py``: the same strings and parse rules).

Prompt shapes and the object-name normalizer mirror the reference grounder
(reference ``TStar/interface_grounding.py:374-386`` grounding prompt,
``:432-437`` QA prompt, ``:457-461`` open-ended prompt, ``:401-419``
``check_objects_str`` normalization, ``:393-399`` 2-line parse contract).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple


class GroundingParseError(ValueError):
    """The VLM response did not contain the expected two lines."""


def build_grounding_prompt(question: str, options: Optional[str], num_frames: int) -> str:
    prompt = (
        "Here is a video:\n" + "\n".join(["<image>"] * num_frames) +
        "\nHere is a question about the video:\n" +
        f"Question: {question}\n"
    )
    if options and len(options) > 1:
        prompt += f"Options: {options}\n"
    prompt += (
        "\nWhen answering this question about the video:\n"
        "1. Identify key objects that can locate the answer (list key objects, separated by commas).\n"
        "2. Identify cue objects that might be near the key objects and appear in the scenes (list cue objects, separated by commas).\n\n"
        "Provide your answer in two lines, listing the key objects and cue objects separated by commas."
    )
    return prompt


def build_qa_prompt(question: str, options: str, num_frames: int) -> str:
    return (
        "Select the best answer to the following multiple-choice question based on the video.\n"
        + "\n".join(["<image>"] * num_frames)
        + f"\nQuestion: {question}\n"
        + f"Options: {options}\n\n"
        + "Answer with the option's letter from the given choices directly."
    )


def build_open_qa_prompt(question: str, num_frames: int) -> str:
    return (
        "Answer the following question briefly based on the video.\n"
        + "\n".join(["<image>"] * num_frames)
        + f"\nQuestion: {question}\n"
    )


def normalize_object_name(obj: str) -> str:
    """Lowercase, strip list prefixes/labels/punctuation (keep hyphens)."""
    obj = obj.strip().lower()
    obj = re.sub(r"^(key objects|cue objects)?[:\-]?\s*", "", obj)
    obj = obj.replace("key objects: ", "").replace("cue objects: ", "").replace(": ", "")
    obj = re.sub(r"^[0-9]+\.\s*", "", obj)
    obj = re.sub(r"[^\w\s-]", "", obj)
    return obj.strip()


# Appended to the grounding prompt on a bounded re-prompt after a parse
# failure (SURVEY §5.3 "bounded retries for API/VLM calls"; the reference
# crashes the item on the first malformed response,
# interface_grounding.py:393-395).
REPROMPT_SUFFIX = (
    "\n\nAnswer in exactly two lines: the key objects on the first line and "
    "the cue objects on the second line, each separated by commas. Do not "
    "include any other text."
)


def parse_grounding_response(response: str) -> Tuple[List[str], List[str]]:
    """Strict 2-line parse: line 1 targets, line 2 cues (:393-399)."""
    lines = [line.strip() for line in response.split("\n") if line.strip()]
    if len(lines) != 2:
        raise GroundingParseError(f"Unexpected response format --> {response}")
    targets = [normalize_object_name(o) for o in lines[0].split(",") if o.strip()]
    cues = [normalize_object_name(o) for o in lines[1].split(",") if o.strip()]
    targets = [t for t in targets if t]
    cues = [c for c in cues if c]
    if not targets:
        raise GroundingParseError(f"No target objects parsed from --> {response}")
    return targets, cues
