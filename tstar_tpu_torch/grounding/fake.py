"""Deterministic fake VLM backend for hermetic runs (a copy of
``tstar_tpu/grounding/fake.py``).

Generalizes the reference's only mock (the ``LlavaInterface`` stub that
returns a canned string, ``TStar/interface_grounding.py:41-44``) into a
configurable test double: canned grounding objects + a canned QA answer, with
call recording for assertions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class FakeVLM:
    """Backend-level double implementing ``inference_with_frames``."""

    def __init__(
        self,
        grounding_lines: Sequence[str] = ("couch", "tv, chair"),
        qa_answer: str = "A",
    ):
        self.grounding_lines = list(grounding_lines)
        self.qa_answer = qa_answer
        self.calls: List[dict] = []

    def inference_with_frames(
        self, query: str, frames=None, temperature: float = 0.0,
        max_tokens: int = 512, **kw,
    ) -> str:
        self.calls.append(
            {"query": query, "num_frames": len(frames) if frames is not None else 0}
        )
        if "key objects" in query:
            return "\n".join(self.grounding_lines)
        return self.qa_answer


class FakeGrounder:
    """Grounder-level double with the full facade API."""

    def __init__(
        self,
        target_objects: Sequence[str] = ("couch",),
        cue_objects: Sequence[str] = ("tv", "chair"),
        qa_answer: str = "A",
        open_answer: str = "a synthetic scene",
    ):
        self.target_objects = list(target_objects)
        self.cue_objects = list(cue_objects)
        self.qa_answer = qa_answer
        self.open_answer = open_answer
        self.calls: List[dict] = []

    def inference_query_grounding(
        self, video_path: str, question: str, options: Optional[str] = None, **kw
    ):
        self.calls.append({"kind": "grounding", "question": question})
        return list(self.target_objects), list(self.cue_objects)

    def inference_query_grounding_batch(self, requests, **kw):
        self.calls.append(
            {"kind": "grounding_batch", "batch": len(requests)}
        )
        return [
            (list(self.target_objects), list(self.cue_objects))
            for _ in requests
        ]

    def inference_qa(self, frames, question: str, options: str, **kw) -> str:
        self.calls.append(
            {"kind": "qa", "question": question, "num_frames": len(frames)}
        )
        return self.qa_answer

    def inference_qa_batch(self, items, **kw) -> List[str]:
        self.calls.append(
            {"kind": "qa_batch", "batch": len(items),
             "questions": [it["question"] for it in items]}
        )
        return [self.qa_answer] * len(items)

    def inference_openend_qa(self, frames, question: str, **kw) -> str:
        self.calls.append({"kind": "open_qa", "question": question})
        return self.open_answer
