"""One user asking about one video after another, with Kimi-VL-A3B as the
grounding and QA VLM: ``pipeline.py``'s question loop (each question one
``TStarFramework.run()``: grounding on the VLM, the frame cache, the
single-video search, QA on the keyframes) and its search checks, by import.

Set-up seeds Kimi-VL's weights on the device, one draw for each layer
(``Weights``: the same seed gives the same weights, layer by layer, in the
program and in the reference), builds the program's byte-level tokenizer
at Kimi-VL's special ids, and answers one question to warm every shape.
Each request keeps its served tokens and the experts the program chose at
every position of the request (the latent cache's route log, copied on the
device after the request).  The window is ``pipeline.py``'s.

The check, after the window with the program's state freed: a sample of the
requests drawn from the seed, the longest (a grounding request) among them.
The float32 reference (``reference/kimi_vl.py``) runs each over its prompt
worked out again (``reference/kimi_inputs.py``) and the served tokens,
following the program's expert choices: ``token_logit_gap`` is the widest
gap by which a served token's reference logit lies below the reference's
best, ``route_gap`` the widest margin by which an expert the program chose
scores below the reference's 6th best (sigmoid score plus the correction
bias), over every MoE layer and position.  The control puts the reference
one precision down (fp8 e4m3 operands in every product) in the program's
place: its own expert choices and its own tokens, judged the same way.  The
searches are checked as the LLaVA cell checks them.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import tempfile
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops, flops_kimi
from benchmark.drivers import pipeline
from benchmark.reference import kimi_inputs
from benchmark.reference import kimi_vl as ref_kimi
from benchmark.reference import owlvit as ref_owlvit
from benchmark.reference import vlm_inputs
from benchmark.search_check import SearchChecker, keyframe_fault, no_tf32, owlvit_heuristic, \
    search_values
from benchmark.seeds import derive
from benchmark.weights import seeded_weights
from tstar_tpu_torch.models import kimi_vl


def program_config(cfg: Dict) -> "kimi_vl.KimiVLConfig":
    """The program's ``KimiVLConfig`` at the configuration's sizes."""
    from tstar_tpu_torch.models.moonvit import MoonViTConfig

    v = cfg["vision_config"]
    return kimi_vl.KimiVLConfig(
        vision=MoonViTConfig(
            hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"], intermediate_size=v["intermediate_size"],
            patch_size=v["patch_size"], pos_emb_height=v["init_pos_emb_height"],
            pos_emb_width=v["init_pos_emb_width"], merge_kernel=tuple(v["merge_kernel_size"]),
            rope_theta=v["rope_theta"], eps=v["layer_norm_eps"]),
        text=kimi_vl.KimiVLTextConfig(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            moe_intermediate_size=cfg["moe_intermediate_size"],
            num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
            kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
            qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
            n_routed_experts=cfg["n_routed_experts"], n_shared_experts=cfg["n_shared_experts"],
            num_experts_per_tok=cfg["num_experts_per_tok"],
            first_k_dense_replace=cfg["first_k_dense_replace"],
            routed_scaling_factor=cfg["routed_scaling_factor"],
            norm_topk_prob=cfg["norm_topk_prob"], rms_norm_eps=cfg["rms_norm_eps"],
            rope_theta=float(cfg["rope_theta"])),
        media_token_id=cfg["media_placeholder_token_id"],
        in_token_limit=v["in_token_limit"])


class Weights:
    """The configuration's weights under the program's checkpoint names,
    made on the device as they are asked for: each group (the tower, the
    embedding, each decoder layer, the final norm, the head) one
    ``seeded_weights`` draw from its own seed, one group held at a time (a
    reader that walks the model in order draws each once)."""

    def __init__(self, cfg: Dict, device, dtype=torch.bfloat16):
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.groups: Dict[str, list] = {}
        for name, shape in kimi_vl.flat_weight_shapes(program_config(cfg)):
            self.groups.setdefault(self.group(name), []).append((name, shape))
        self.key, self.held = None, {}

    @staticmethod
    def group(name: str) -> str:
        parts = name.split(".")
        return ".".join(parts[:2]) if parts[0] == "layers" else parts[0]

    def __getitem__(self, name: str) -> torch.Tensor:
        key = self.group(name)
        if key != self.key:
            self.held = {}
            self.held = seeded_weights(self.groups[key], derive(self.cfg["weights_seed"], key),
                                       self.device, self.dtype)
            self.key = key
        return self.held[name]


def _recording_backend(model, tokenizer):
    """The program's ``TorchVLMBackend`` over ``model``, keeping each
    request's tokens in ``.served`` and its expert choices, (MoE layers,
    positions, K) on the device, in ``.routes``."""
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend

    class Recording(TorchVLMBackend):
        def _generate(self, *args, **kw):
            tokens = super()._generate(*args, **kw)
            self.served.append(tokens[0])
            self.routes.append(self.model.last_cache.routes[:, 0].clone())
            return tokens

    backend = Recording.from_model(model, tokenizer)
    backend.served, backend.routes = [], []
    return backend


class Driver(pipeline.Driver):
    def setup(self) -> None:
        from tstar_tpu_torch import SearchConfig
        from tstar_tpu_torch.grounding.universal import UniversalGrounder
        from tstar_tpu_torch.models.generate import GenerateStats
        from tstar_tpu_torch.models.qwen_tokenizer import QwenTokenizer, write_byte_vocab

        self.heur, self.det_weights = owlvit_heuristic(self.detector_cfg, self.device)
        dtype = getattr(torch, self.cfg["torch_dtype"])
        self.model = kimi_vl.kimi_model_from(program_config(self.cfg),
                                             Weights(self.cfg, self.device, dtype), dtype,
                                             self.device)
        self.tmp = tempfile.TemporaryDirectory()
        vocab = os.path.join(self.tmp.name, "tokenizer")
        os.makedirs(vocab)
        write_byte_vocab(vocab, self.cfg["special_tokens"])
        self.backend = _recording_backend(self.model, QwenTokenizer.from_dir(vocab))
        self.backend.stats = GenerateStats(timed=self.timed)
        self.grounder = UniversalGrounder(
            "kimi-vl-a3b", num_frames=self.mix["grounding_frames"],
            backend=pipeline._StandIn(self.backend, self.mix["grounding_answer"]))
        m = self.mix
        self.search = SearchConfig(cache_hw=tuple(m["cache_hw"]),
                                   detector_threshold=m["detector_threshold"],
                                   verify_batch=m["verify_batch"])
        self._question("warm-up")
        self.questions.clear()
        self.backend.served.clear()
        self.backend.routes.clear()
        self.model.expert_tokens.zero_()
        self.backend.stats = self.stats = GenerateStats(timed=self.timed)
        self._sync()

    def _question(self, tag) -> Dict:
        routes0 = len(self.backend.routes)
        q = super()._question(tag)
        q["routes"] = self.backend.routes[routes0:]
        return q

    def _requests(self):
        """Each request of the window: (question, kind, prompt, frames,
        served tokens, expert choices)."""
        n_frames = self.mix["grounding_frames"]
        out = []
        for q in self.questions:
            video = q["video"]
            total = video.meta.total_frames
            ground = video.decode_batch([int(np.floor(i * total / n_frames))
                                         for i in range(n_frames)])
            keyframes = video.decode_batch([int(t * video.meta.fps)
                                            for t in q["result"]["Frame Timestamps"]])
            prompts = [("grounding", vlm_inputs.grounding_prompt(q["question"], q["options"],
                                                                 n_frames), ground),
                       ("qa", vlm_inputs.qa_prompt(q["question"], q["options"], len(keyframes)),
                        keyframes)]
            for (kind, prompt, frames), tokens, routes in zip(prompts, q["served"], q["routes"]):
                out.append((q, kind, prompt, frames, kimi_inputs.served(tokens, self.cfg), routes))
        return out

    def counters(self) -> Dict:
        """What the per-layer readers read: the window's work and its clocks."""
        cfg = self.cfg
        v = self.detector_cfg["vision_config"]
        image = flops.owlvit_image_flops(v, self.detector_cfg["projection_dim"],
                                         self.search.max_objects, v["image_size"])
        text = flops.owlvit_text_flops(self.detector_cfg["text_config"],
                                       self.detector_cfg["projection_dim"],
                                       self.search.max_objects)
        p = cfg["vision_config"]["patch_size"]
        total, bound_s = 0.0, 0.0
        for q, kind, prompt, frames, served, _ in self._requests():
            n = len(kimi_inputs.request_ids(prompt, frames, cfg))
            ph, pw = kimi_inputs.padded_hw(*np.asarray(frames[0]).shape[:2], cfg)
            total += flops_kimi.request_flops(cfg, len(frames), ph // p, pw // p, n, len(served))
            bound_s += flops_kimi.decode_bound_s(cfg, n, len(served))
        images = sum(q["grid_images"] + sum(q["verify_widths"]) for q in self.questions)
        total += images * image + len(self.questions) * text
        stats = self.stats
        counts = self.model.expert_tokens.float()
        share = counts / counts.sum(dim=1, keepdim=True)
        print(f"expert_tokens: {int(counts.sum())} token-expert pairs over {counts.shape[0]} MoE "
              f"layers; busiest expert's share of a layer, mean {share.max(1).values.mean():.4f}, "
              f"max {share.max():.4f}; least {share.min():.4f}; uniform "
              f"{1 / counts.shape[1]:.4f}", file=sys.stderr)
        return {
            "questions": len(self.questions), "flops": total,
            "grounding_s": sum(q["timings"]["grounding"] for q in self.questions),
            "qa_s": sum(q["timings"]["qa"] for q in self.questions),
            "decode_steps": stats.decode_steps,
            "decode_ms": sum(stats.decode_ms) if stats.timed else None,
            "decode_bound_s": bound_s,
            "moe_layers": stats.moe_layers,
            "moe_decode_bound_s": stats.moe_layers * stats.decode_steps
            * flops_kimi.moe_decode_bytes(cfg) / flops.PEAK_HBM_BYTES_PER_S,
        }

    # -- the check ------------------------------------------------------------
    def check(self, control: bool = False) -> List[Dict]:
        limits, chk = self.cell["limits"], self.cell["check"]
        self.failed = sum(keyframe_fault(q["keyframe_secs"], q["hist"]["Score_history"][-1],
                                         q["n_valid"], self.search) for q in self.questions)
        rng = np.random.default_rng(derive(self.seed, "check"))
        requests = self._requests()
        longest = max(range(len(requests)), key=lambda i: len(requests[i][4]))
        others = [i for i in range(len(requests)) if i != longest]
        picked = [longest] + sorted(rng.choice(others, min(chk["requests"] - 1, len(others)),
                                               replace=False).tolist())
        token_gaps: List[float] = []
        route_gaps: List[float] = []
        grid, verify, update = [], [], []
        with no_tf32():
            w = Weights(self.cfg, self.device, getattr(torch, self.cfg["torch_dtype"]))
            for i in picked:
                _, kind, prompt, frames, served, routes = requests[i]
                t, r = self._gaps(prompt, frames, served, routes, w, control)
                token_gaps += t
                route_gaps.append(r)
            del w
            gc.collect()
            checker = SearchChecker(self.detector_cfg, self.det_weights, self.search,
                                    *pipeline._objects(self.mix["grounding_answer"]), chk,
                                    self.device, control)
            for qi in sorted(rng.choice(len(self.questions), min(chk["searches"],
                                                                 len(self.questions)),
                                        replace=False).tolist()):
                q = self.questions[qi]
                frames = torch.as_tensor(q["video"].decode_sweep(
                    1.0 / self.search.sampling_fps, q["n_valid"], tuple(self.search.cache_hw)),
                    device=self.device)
                g, v, u = checker.readings(q["hist"], q["steps"], frames, rng)
                grid, verify, update = grid + g, verify + v, update + u
        self.readings = {"token_gaps": token_gaps, "route_gaps": route_gaps, "grid_gaps": grid,
                         "verify_gaps": verify, "p_gaps": update}
        values = {"token_logit_gap": max(token_gaps, default=math.inf),
                  "route_gap": max(route_gaps, default=math.inf),
                  **search_values(grid, verify, update), "keyframe_faults": float(self.failed)}
        return [{"name": k, "value": values[k], "limit": limits[k]} for k in values]

    def _gaps(self, prompt, frames, served, routes, w, control: bool):
        """One request -> (per served token, how far its reference logit lies
        below the reference's best; the widest route gap).  With
        ``control``, the fp8 reference's own experts and tokens take the
        program's place."""
        ids = kimi_inputs.request_ids(prompt, frames, self.cfg)
        seq = torch.as_tensor(ids + served[:-1], device=self.device)
        pixels = kimi_inputs.frame_pixels(frames, self.cfg).to(self.device)
        n = len(ids)
        follow = routes[:, :len(seq)]
        chosen = torch.as_tensor(served, device=self.device)
        if control:
            low, follow, _ = ref_kimi.forward(seq, pixels, w, self.cfg, ref_owlvit.fp8_e4m3,
                                              first=n - 1)
            chosen = low.argmax(dim=-1)
            del low
        logits, _, gap = ref_kimi.forward(seq, pixels, w, self.cfg, follow=follow, first=n - 1)
        token = logits.max(dim=-1).values - logits.gather(1, chosen[:, None])[:, 0]
        return token.tolist(), gap
