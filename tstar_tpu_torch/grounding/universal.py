"""Universal grounder facade (port of ``tstar_tpu/grounding/universal.py``):
backend dispatch and the three inference APIs.

The reference's ``TStarUniversalGrounder`` (``TStar/interface_grounding.py
:327-468``): substring dispatch on the model name ("gpt" / "qwen" / "llava"
/ "fake"), 8-frame uniform video sampling for grounding, the strict 2-line grounding parse with
object-name normalization and a bounded re-prompt, multiple-choice QA capped
at 30 generated tokens, and open-ended QA.

Frames for grounding are read from the video file, or from ``decoder=``
when given (``utils/images.py``).  Where the JAX facade retries a failed batched
grounding forward item by item, this one lets the failure raise: only a
frame-decode error or a parse error (after the re-prompts) stays an item's
own result.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import torch

from tstar_tpu_torch.grounding.fake import FakeVLM
from tstar_tpu_torch.grounding.prompts import (
    REPROMPT_SUFFIX,
    GroundingParseError,
    build_grounding_prompt,
    build_open_qa_prompt,
    build_qa_prompt,
    parse_grounding_response,
)
from tstar_tpu_torch.utils.images import load_video_frames

logger = logging.getLogger(__name__)


class UniversalGrounder:
    def __init__(
        self,
        model_name: str = "gpt-4o",
        model_path: Optional[str] = None,
        api_key: Optional[str] = None,
        num_frames: int = 8,
        backend=None,
        parse_retries: int = 1,
        device="cuda",
        dtype: torch.dtype = torch.bfloat16,
    ):
        self.model_name = model_name
        self.num_frames = num_frames
        self.parse_retries = max(0, int(parse_retries))
        if backend is not None:
            self.backend = backend
            return
        name = model_name.lower()
        if "fake" in name:
            self.backend = FakeVLM()
        elif "gpt" in name:
            from tstar_tpu_torch.grounding.openai_backend import OpenAIBackend

            self.backend = OpenAIBackend(model=model_name, api_key=api_key)
        elif "qwen" in name or "llava" in name:
            path = model_path or model_name
            if not os.path.isdir(path):
                raise ValueError(
                    "VLM backends load from a LOCAL checkpoint directory; "
                    f"pass model_path= (got {path!r})"
                )
            from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend

            self.backend = TorchVLMBackend(path, device=device, dtype=dtype)
        else:
            raise ValueError("model_name must contain one of: 'gpt', 'qwen', 'llava', 'fake'")

    def inference_query_grounding(
        self,
        video_path: str,
        question: str,
        options: Optional[str] = None,
        temperature: float = 0.0,
        max_tokens: int = 512,
        decoder=None,
    ) -> Tuple[List[str], List[str]]:
        frames = load_video_frames(video_path, num_frames=self.num_frames, decoder=decoder)
        prompt = build_grounding_prompt(question, options, len(frames))
        response = self.backend.inference_with_frames(
            query=prompt, frames=frames, temperature=temperature, max_tokens=max_tokens
        )
        return self._parse_with_retry(response, prompt, frames, temperature, max_tokens)

    def _parse_with_retry(self, response, prompt, frames, temperature, max_tokens):
        """Parse a grounding response, re-prompting up to ``parse_retries``
        times with a two-line format reminder on a malformed one."""
        for attempt in range(self.parse_retries + 1):
            try:
                return parse_grounding_response(response)
            except GroundingParseError:
                if attempt == self.parse_retries:
                    raise
                logger.warning(
                    "grounding parse failed (attempt %d/%d); re-prompting "
                    "with an explicit format reminder",
                    attempt + 1, self.parse_retries + 1,
                )
                response = self.backend.inference_with_frames(
                    query=prompt + REPROMPT_SUFFIX, frames=frames,
                    temperature=temperature, max_tokens=max_tokens,
                )

    def inference_query_grounding_batch(
        self,
        requests,            # dicts: {video_path, question, options, decoder}
        temperature: float = 0.0,
        max_tokens: int = 512,
    ) -> List:
        """Ground many (video, question) items at once.  One entry per
        request: ``(targets, cues)``, or the item's own exception (frame
        decode or response parse).  A failure of the backend's forward
        raises."""
        frames_list, prompts, errors = [], [], {}
        for i, req in enumerate(requests):
            try:
                frames = load_video_frames(req["video_path"], num_frames=self.num_frames,
                                           decoder=req.get("decoder"))
            except (OSError, ValueError, RuntimeError) as e:   # this item's frames
                errors[i] = e
                frames_list.append(None)
                prompts.append(None)
                continue
            frames_list.append(frames)
            prompts.append(build_grounding_prompt(req["question"], req.get("options"), len(frames)))

        ok = [i for i in range(len(requests)) if i not in errors]
        batch_fn = getattr(self.backend, "inference_with_frames_batch", None)
        if batch_fn is not None and len(ok) > 1:
            outs = batch_fn([prompts[i] for i in ok], [frames_list[i] for i in ok],
                            temperature=temperature, max_tokens=max_tokens)
            responses = dict(zip(ok, outs))
        else:
            responses = {
                i: self.backend.inference_with_frames(
                    query=prompts[i], frames=frames_list[i],
                    temperature=temperature, max_tokens=max_tokens,
                )
                for i in ok
            }

        results: List = []
        for i in range(len(requests)):
            if i in errors:
                results.append(errors[i])
                continue
            try:
                results.append(self._parse_with_retry(
                    responses[i], prompts[i], frames_list[i], temperature, max_tokens,
                ))
            except GroundingParseError as e:
                results.append(e)
        return results

    def inference_qa(
        self,
        frames,
        question: str,
        options: str,
        temperature: float = 0.2,
        max_tokens: int = 128,
    ) -> str:
        prompt = build_qa_prompt(question, options, len(frames))
        # the reference caps QA at 30 tokens whatever max_tokens says
        # (interface_grounding.py:443)
        response = self.backend.inference_with_frames(
            query=prompt, frames=frames, temperature=temperature, max_tokens=30
        )
        return response.strip()

    def inference_qa_batch(self, items, temperature: float = 0.2) -> List[str]:
        """Answer many QA items ({frames, question, options}) at once through
        the backend's batched path where it has one; the same 30-token cap
        as ``inference_qa``."""
        prompts = [build_qa_prompt(it["question"], it["options"], len(it["frames"])) for it in items]
        batch_fn = getattr(self.backend, "inference_with_frames_batch", None)
        if batch_fn is not None and len(items) > 1:
            responses = batch_fn(prompts, [it["frames"] for it in items],
                                 temperature=temperature, max_tokens=30)
        else:
            responses = [
                self.backend.inference_with_frames(
                    query=p, frames=it["frames"], temperature=temperature, max_tokens=30,
                )
                for p, it in zip(prompts, items)
            ]
        return [r.strip() for r in responses]

    def inference_openend_qa(
        self, frames, question: str, temperature: float = 0.2, max_tokens: int = 2048
    ) -> str:
        prompt = build_open_qa_prompt(question, len(frames))
        response = self.backend.inference_with_frames(
            query=prompt, frames=frames, temperature=temperature, max_tokens=max_tokens
        )
        return response.strip()


# Reference-compatible alias (TStar/interface_grounding.py:327).
TStarUniversalGrounder = UniversalGrounder
