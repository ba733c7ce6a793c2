"""The port's VLM backend (port of ``tstar_tpu/grounding/vlm_backend.py``):
Qwen2-VL or LLaVA-OneVision from a local checkpoint, or any model built
beforehand (``from_model``: Kimi-VL too), for grounding and QA.  Each model
prepares its own inputs (``model.prepare_inputs``: its chat template,
tokens, positions and frame preprocessing) and says whether requests of one
input signature may be stacked (``model.batched_requests``).

The ``inference_with_frames(query, frames, temperature, max_tokens)``
surface the ``UniversalGrounder`` facade dispatches to (the reference's
torch ``QwenInterface``, ``TStar/interface_grounding.py:52-150``).  The
model loads onto ``device`` ("cuda" unless the caller asks for another) in
``dtype`` (bf16 by default); the KV cache takes the model's dtype (the
reference's is bf16 whatever the model's, and fails on an f32 model: ROADMAP
queue 3 item 8).  With ``mesh=`` (``parallel/mesh.make_mesh``) the model
loads onto the mesh rank's device (a ``device`` other than that raises)
and is sharded over its model group (``parallel/shardings.shard_module``),
as the reference's ``mesh=``: every rank of the group runs the same
requests and returns the same text.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tstar_tpu_torch.models.generate import GenerateStats, generate
from tstar_tpu_torch.models.loader import load_vlm_checkpoint
from tstar_tpu_torch.parallel.shardings import shard_module
from tstar_tpu_torch.utils.profiling import trace


class TorchVLMBackend:
    def __init__(
        self,
        model_path: str,
        device=None,
        dtype: torch.dtype = torch.bfloat16,
        max_pixels: int = 448 * 448,
        seed: int = 0,
        mesh=None,
    ):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's device {mesh.device}")
            device = mesh.device
        model, tokenizer = load_vlm_checkpoint(model_path, device or "cuda", dtype)
        if mesh is not None:
            shard_module(model, mesh)
        self._adopt(model, tokenizer, max_pixels, seed)

    @classmethod
    def from_model(cls, model, tokenizer, max_pixels: int = 448 * 448,
                   seed: int = 0) -> "TorchVLMBackend":
        """A backend around a model and tokenizer already built (on the
        model's device, in its dtype)."""
        self = cls.__new__(cls)
        self._adopt(model, tokenizer, max_pixels, seed)
        return self

    def _adopt(self, model, tokenizer, max_pixels: int, seed: int) -> None:
        self.model, self.tokenizer = model, tokenizer
        self.max_pixels = max_pixels
        self.generator = torch.Generator(device=model.device).manual_seed(seed)
        self.stats = GenerateStats()

    def _prepare(self, query: str, frames) -> Dict:
        with trace("vlm.prepare"):
            frames = [np.asarray(f) for f in (frames or [])]
            return self.model.prepare_inputs(self.tokenizer, query, frames, self.max_pixels)

    def _generate(self, ids, lens, pos, patches, grid_hw, temperature, max_tokens) -> List[List[int]]:
        tokens = generate(
            self.model, ids, lens, pos,
            max_new_tokens=max_tokens,
            eos_token_ids=[self.tokenizer.eos_id, self.tokenizer.pad_id],
            temperature=temperature, generator=self.generator,
            image_patches=patches, image_grid_hw=grid_hw,
            stats=self.stats,
        )
        return tokens.tolist()

    def _text(self, ids: Sequence[int]) -> str:
        stops = {self.tokenizer.eos_id, self.tokenizer.pad_id}
        out = []
        for t in ids:
            if t in stops:
                break
            out.append(t)
        return self.tokenizer.decode(out).strip()

    def inference_with_frames(
        self,
        query: str,
        frames: Optional[Sequence[np.ndarray]] = None,
        temperature: float = 0.7,
        max_tokens: int = 128,
        **kw,
    ) -> str:
        inp = self._prepare(query, frames)
        tokens = self._generate(inp["input_ids"], inp["prompt_lens"], inp["position_ids"],
                                inp["image_patches"], inp["image_grid_hw"], temperature, max_tokens)
        return self._text(tokens[0])

    def inference_with_frames_batch(
        self,
        queries: Sequence[str],
        frames_list: Sequence[Sequence[np.ndarray]],
        temperature: float = 0.7,
        max_tokens: int = 128,
    ) -> List[str]:
        """Many (query, frames) requests per forward: requests group by input
        signature (image grid and patch shape) so a group stacks into static
        shapes; prompts right-pad to a multiple of 128.  Greedy results equal
        the serial path's.  A model whose ``batched_requests`` is False
        (LLaVA, as in the reference, and Kimi-VL) stays serial."""
        if not self.model.batched_requests:
            return [self.inference_with_frames(q, f, temperature, max_tokens)
                    for q, f in zip(queries, frames_list)]
        prepared = [self._prepare(q, f) for q, f in zip(queries, frames_list)]

        def signature(inp):
            p = inp["image_patches"]
            return (inp["image_grid_hw"], None if p is None else p.shape)

        groups: Dict = {}
        for i, inp in enumerate(prepared):
            groups.setdefault(signature(inp), []).append(i)

        outputs = [""] * len(prepared)
        for (grid_hw, _), idxs in groups.items():
            lens = [int(prepared[i]["prompt_lens"][0]) for i in idxs]
            s_pad = -(-max(lens) // 128) * 128
            b = len(idxs)
            ids = np.full((b, s_pad), self.tokenizer.pad_id, np.int32)
            pos = np.zeros((3, b, s_pad), np.int32)
            for row, i in enumerate(idxs):
                ids[row, :lens[row]] = prepared[i]["input_ids"][0]
                pos[:, row, :lens[row]] = prepared[i]["position_ids"][:, 0]
            patches = None
            if grid_hw is not None:
                # row order: embed() fills image tokens in (B, S) order
                patches = np.concatenate([prepared[i]["image_patches"] for i in idxs], axis=0)
            tokens = self._generate(ids, np.asarray(lens, np.int32), pos, patches, grid_hw,
                                    temperature, max_tokens)
            for row, i in enumerate(idxs):
                outputs[i] = self._text(tokens[row])
        return outputs

    # Legacy shim mirroring QwenInterface.inference (interface_grounding.py:135).
    def inference(self, query: str, frames=None, max_new_tokens: int = 128) -> str:
        return self.inference_with_frames(query=query, frames=frames or [], max_tokens=max_new_tokens)
