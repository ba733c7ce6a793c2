"""OpenAI chat-completions VLM backend (port of
``tstar_tpu/grounding/openai_backend.py``; network, host-side).

The reference's ``GPT4Interface`` surface: base64 JPEG frames at ``detail:
low``, ``<image>``-tag interleaving, the API key from ``OPENAI_API_KEY``;
bounded retries with backoff, and a failure raises ``OpenAIBackendError``
(``strict=False`` returns the reference's ``"Error: ..."`` string instead).
The ``openai`` package is imported when a backend is built, never with the
module.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence

from tstar_tpu_torch.utils.images import encode_image_to_base64

logger = logging.getLogger(__name__)


class OpenAIBackendError(RuntimeError):
    pass


class OpenAIBackend:
    def __init__(
        self,
        model: str = "gpt-4o",
        api_key: Optional[str] = None,
        max_retries: int = 3,
        retry_backoff: float = 2.0,
        strict: bool = True,
    ):
        self.model_name = model
        self.api_key = api_key or os.getenv("OPENAI_API_KEY")
        if not self.api_key:
            raise ValueError("Environment variable OPENAI_API_KEY is not set.")
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.strict = strict
        import openai

        self._client = openai.OpenAI(api_key=self.api_key)

    @staticmethod
    def _image_part(frame) -> Dict:
        return {
            "type": "image_url",
            "image_url": {
                "url": f"data:image/jpeg;base64,{encode_image_to_base64(frame)}",
                "detail": "low",
            },
        }

    def _interleave(self, query: str, frames: Sequence) -> List[Dict]:
        """Split on <image> tags; frame i follows text part i."""
        parts = query.split("<image>")
        content: List[Dict] = []
        for i, part in enumerate(parts):
            if part.strip():
                content.append({"type": "text", "text": part.strip()})
            if frames is not None and i < len(frames):
                content.append(self._image_part(frames[i]))
        return content or [{"type": "text", "text": query}]

    def _complete(self, content, system_message, temperature, max_tokens) -> str:
        messages = [
            {"role": "system", "content": system_message},
            {"role": "user", "content": content},
        ]
        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                resp = self._client.chat.completions.create(
                    model=self.model_name, messages=messages,
                    temperature=temperature, max_tokens=max_tokens,
                )
                return resp.choices[0].message.content.strip()
            except Exception as e:  # noqa: BLE001  (any transport or API error is retried)
                last_err = e
                logger.warning("OpenAI call failed (attempt %d/%d): %s",
                               attempt + 1, self.max_retries, e)
                time.sleep(self.retry_backoff * (2 ** attempt))
        if self.strict:
            raise OpenAIBackendError(str(last_err)) from last_err
        return f"Error: {last_err}"

    def inference_with_frames(
        self,
        query: str,
        frames: Optional[Sequence] = None,
        system_message: str = "You are a helpful assistant.",
        temperature: float = 0.7,
        max_tokens: int = 1000,
    ) -> str:
        content = self._interleave(query, frames or [])
        return self._complete(content, system_message, temperature, max_tokens)

    def inference_text_only(
        self,
        query: str,
        system_message: str = "You are a helpful assistant.",
        temperature: float = 0.7,
        max_tokens: int = 1000,
    ) -> str:
        return self._complete(query, system_message, temperature, max_tokens)
