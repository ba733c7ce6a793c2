"""One user asking about one video after another: each question one
``TStarFramework.run()`` (grounding on the VLM, the frame cache, the
single-video search with its histories, QA on the keyframes), closed loop,
one client.

Set-up seeds LLaVA-OneVision's weights and the detector's on the device,
builds the program's byte-level tokenizer, and answers one question to warm
every shape (the decode step's graphs, the search's graphs).  The window
then asks question after question, each on a distinct video made from the
seed (``benchmark/video.py``, 600 s at 10 fps) and a question drawn from
the mix's list, and closes at the first question boundary after
``seconds``.  ``question_s``: the window over the questions answered.

The grounder's backend is the program's ``TorchVLMBackend``, behind a
stand-in for the grounding request only: that request runs on the model at
the framework's cap and temperature 0, then its text is replaced by the
mix's two lines (seeded weights name no objects); the QA request runs at
temperature 0 so that its tokens can be judged.  Every request's tokens are
kept.

The check, after the window with the program's state freed: a sample of
the requests drawn from the seed, a grounding request (the longest) among
them: the widest gap by which a served token's logit lies below the best
logit of the float32 reference, run over the request worked out again
(``reference/vlm_inputs.py``: prompt, template, tokens, frames) with the
served tokens; a sample of the searches as the search cell checks them
(``search_check``); every search's keyframes.
"""

from __future__ import annotations

import gc
import math
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops
from benchmark.reference import llava as ref_llava
from benchmark.reference import owlvit as ref_owlvit
from benchmark.reference import vlm_inputs
from benchmark.search_check import (SearchChecker, keyframe_fault, no_tf32, owlvit_heuristic,
                                    search_values)
from benchmark.seeds import derive
from benchmark.video import SeededVideo
from benchmark.weights import seeded_weights


def llava_config(cfg: Dict):
    """The program's ``LlavaOnevisionConfig`` at the configuration's sizes."""
    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionConfig
    from tstar_tpu_torch.models.qwen2vl import Qwen2VLTextConfig
    from tstar_tpu_torch.models.siglip import SiglipVisionConfig

    v, t = cfg["vision_config"], cfg["text_config"]
    head_dim = t["hidden_size"] // t["num_attention_heads"]
    return LlavaOnevisionConfig(
        vision=SiglipVisionConfig(
            hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"], intermediate_size=v["intermediate_size"],
            patch_size=v["patch_size"], image_size=v["image_size"], eps=v["layer_norm_eps"]),
        text=Qwen2VLTextConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
            num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
            num_kv_heads=t["num_key_value_heads"], intermediate_size=t["intermediate_size"],
            rms_norm_eps=t["rms_norm_eps"], rope_theta=t["rope_theta"],
            mrope_section=(head_dim // 2, 0, 0),
            tie_word_embeddings=t["tie_word_embeddings"], hidden_act=t["hidden_act"]),
        image_token_id=cfg["image_token_index"], video_token_id=cfg["video_token_index"],
        vision_feature_layer=cfg["vision_feature_layer"],
        vision_feature_select_strategy=cfg["vision_feature_select_strategy"])


class _StandIn:
    """The grounder's backend: the grounding request (the prompt that asks
    for key objects) runs on the real backend, at the cap and temperature
    the framework asks for, and its text is then replaced by ``lines``;
    every other request runs on the real backend at temperature 0."""

    def __init__(self, backend, lines: str):
        self.backend, self.lines = backend, lines

    def inference_with_frames(self, query, frames=None, temperature=0.7, max_tokens=128, **kw):
        if "key objects" not in query:
            return self.backend.inference_with_frames(query, frames, 0.0, max_tokens, **kw)
        self.backend.inference_with_frames(query, frames, temperature, max_tokens, **kw)
        return self.lines


def _recording_backend(model, tokenizer):
    """The program's ``TorchVLMBackend`` over ``model``, keeping each
    request's generated tokens in ``.served``."""
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend

    class Recording(TorchVLMBackend):
        def _generate(self, *args, **kw):
            tokens = super()._generate(*args, **kw)
            self.served.append(tokens[0])
            return tokens

    backend = Recording.from_model(model, tokenizer)
    backend.served = []
    return backend


class Driver:
    def __init__(self, cell: Dict, config: Dict, seed: int, device, configs: Dict,
                 traced: bool = False):
        self.cell, self.cfg, self.seed = cell, config, seed
        self.device = torch.device(device)
        self.mix = cell["mix"]
        self.detector_cfg = configs["detector_config"]
        self.questions: List[Dict] = []
        self.timed = traced      # the decode's CUDA-event clock, in the traced run only

    # -- set-up ---------------------------------------------------------------
    def _llava_shapes(self):
        from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionModel

        with torch.device("meta"):
            model = LlavaOnevisionModel(self.llava_cfg)
        return model, [(k, tuple(p.shape)) for k, p in model.state_dict().items()]

    def setup(self) -> None:
        from tstar_tpu_torch import SearchConfig
        from tstar_tpu_torch.grounding.universal import UniversalGrounder
        from tstar_tpu_torch.models.generate import GenerateStats
        from tstar_tpu_torch.models.qwen_tokenizer import QwenTokenizer, write_byte_vocab

        self.heur, self.det_weights = owlvit_heuristic(self.detector_cfg, self.device)
        self.llava_cfg = llava_config(self.cfg)
        dtype = getattr(torch, self.cfg["torch_dtype"])
        model, shapes = self._llava_shapes()
        model = model.to(dtype).to_empty(device=self.device)
        weights = seeded_weights(shapes, self.cfg["weights_seed"], self.device, dtype)
        with torch.no_grad():
            for k, p in model.state_dict().items():
                p.copy_(weights[k])
        del weights
        self.model = model.requires_grad_(False).eval()
        self.tmp = tempfile.TemporaryDirectory()
        vocab = os.path.join(self.tmp.name, "tokenizer")
        os.makedirs(vocab)
        write_byte_vocab(vocab)
        self.backend = _recording_backend(self.model, QwenTokenizer.from_dir(vocab))
        self.backend.stats = GenerateStats(timed=self.timed)
        self.grounder = UniversalGrounder(
            "llava-onevision-7b", num_frames=self.mix["grounding_frames"],
            backend=_StandIn(self.backend, self.mix["grounding_answer"]))
        m = self.mix
        self.search = SearchConfig(cache_hw=tuple(m["cache_hw"]),
                                   detector_threshold=m["detector_threshold"],
                                   verify_batch=m["verify_batch"])
        self._question("warm-up")
        self.questions.clear()
        self.backend.served.clear()
        self.backend.stats = self.stats = GenerateStats(timed=self.timed)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _question(self, tag) -> Dict:
        from tstar_tpu_torch.framework.framework import TStarFramework
        from tstar_tpu_torch.search import searcher as searcher_module
        from tstar_tpu_torch.search.step_graphs import StepStats

        m = self.mix
        rng = np.random.default_rng(derive(self.seed, "question", tag))
        question, options = m["questions"][int(rng.integers(len(m["questions"])))]
        video = SeededVideo(derive(self.seed, "video", tag), m["video_seconds"], m["video_fps"],
                            tuple(m["video_hw"]), m["scene_seconds"])
        served0 = len(self.backend.served)
        # the searcher's steps keep their sampled seconds and grid confidences
        searcher_module.StepStats = lambda: StepStats(record=True)
        try:
            with torch.profiler.record_function("question.run"):
                fw = TStarFramework(f"mem://bench-question-{tag}", self.heur, self.grounder,
                                    question, options, search_budget=m["search_budget"],
                                    confidence_threshold=m["confidence_threshold"],
                                    config=self.search, output_dir=self.tmp.name,
                                    seed=derive(self.seed, "search", tag), save_artifacts=False,
                                    decoder=video, device=str(self.device))
                result = fw.run()
        finally:
            searcher_module.StepStats = StepStats
        s = fw.video_searcher
        st = s.step_stats
        with torch.profiler.record_function("question.keep_trace"):
            secs = torch.stack([r["secs"][0] for r in st.trace]).cpu().numpy()
            conf = torch.stack([r["conf"][0] for r in st.trace]).cpu().numpy()
            trace = list(zip(secs, conf))
        q = {"question": question, "options": options, "video": video, "result": result,
             "timings": {k: v["total_s"] for k, v in fw.results["Timings"].items()},
             "served": self.backend.served[served0:],
             "hist": {"Score_history": s.Score_history,
                      "non_visiting_history": s.non_visiting_history,
                      "P_history": s.P_history},
             "keyframe_secs": [int(round(t * s.fps)) for t in result["Frame Timestamps"]],
             "steps": trace, "grid_images": st.grid_images,
             "verify_widths": list(st.verify_widths), "n_valid": s.total_frame_num}
        self.questions.append(q)
        return q

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> float:
        self._sync()
        t0 = time.perf_counter()
        i = 0
        while True:
            self._question(i)
            i += 1
            self._sync()
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        return self.window_s

    def end_to_end(self) -> Dict[str, float]:
        return {"question_s": self.window_s / len(self.questions)}

    def attempted(self) -> int:
        return len(self.questions)

    def _requests(self):
        """Each request of the window: (question, kind, prompt, frames, served tokens)."""
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
            for (kind, prompt, frames), tokens in zip(prompts, q["served"]):
                out.append((q, kind, prompt, frames, vlm_inputs.served(tokens)))
        return out

    def counters(self) -> Dict:
        """What the per-layer readers read: the window's work and its clocks."""
        tpf = vlm_inputs.tokens_per_frame(self.cfg)
        v = self.detector_cfg["vision_config"]
        image = flops.owlvit_image_flops(v, self.detector_cfg["projection_dim"],
                                         self.search.max_objects, v["image_size"])
        text = flops.owlvit_text_flops(self.detector_cfg["text_config"],
                                       self.detector_cfg["projection_dim"],
                                       self.search.max_objects)
        _, shapes = self._llava_shapes()
        lm_params = sum(math.prod(s) for k, s in shapes
                        if not k.startswith(("vision_tower", "projector", "image_newline",
                                             "embed_tokens")))
        total, bound_s = 0.0, 0.0
        for q, kind, prompt, frames, served in self._requests():
            p = len(vlm_inputs.request_ids(prompt, len(frames), tpf))
            total += flops.llava_request_flops(self.cfg, len(frames), p, len(served))
            bound_s += flops.llava_decode_bound_s(self.cfg, lm_params, p, len(served))
        images = sum(q["grid_images"] + sum(q["verify_widths"]) for q in self.questions)
        total += images * image + len(self.questions) * text
        stats = self.stats
        return {
            "questions": len(self.questions), "flops": total,
            "grounding_s": sum(q["timings"]["grounding"] for q in self.questions),
            "qa_s": sum(q["timings"]["qa"] for q in self.questions),
            "decode_steps": stats.decode_steps,
            "decode_ms": sum(stats.decode_ms) if stats.timed else None,
            "decode_bound_s": bound_s,
        }

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.heur, self.model, self.backend, self.grounder
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

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
        grid, verify, update = [], [], []
        with no_tf32():
            _, shapes = self._llava_shapes()
            dtype = getattr(torch, self.cfg["torch_dtype"])
            weights = seeded_weights(shapes, self.cfg["weights_seed"], self.device, dtype)
            cast = ref_owlvit.fp8_e4m3 if control else None
            for i in picked:
                _, kind, prompt, frames, served = requests[i]
                token_gaps += self._token_gaps(prompt, frames, served, weights, cast)
            del weights
            gc.collect()
            checker = SearchChecker(self.detector_cfg, self.det_weights, self.search,
                                    *_objects(self.mix["grounding_answer"]), chk, self.device,
                                    control)
            for qi in sorted(rng.choice(len(self.questions), min(chk["searches"],
                                                                 len(self.questions)),
                                        replace=False).tolist()):
                q = self.questions[qi]
                frames = torch.as_tensor(q["video"].decode_sweep(
                    1.0 / self.search.sampling_fps, q["n_valid"], tuple(self.search.cache_hw)),
                    device=self.device)
                g, v, u = checker.readings(q["hist"], q["steps"], frames, rng)
                grid, verify, update = grid + g, verify + v, update + u
        self.readings = {"token_gaps": token_gaps, "grid_gaps": grid, "verify_gaps": verify,
                         "p_gaps": update}
        values = {"token_logit_gap": max(token_gaps, default=math.inf),
                  **search_values(grid, verify, update), "keyframe_faults": float(self.failed)}
        return [{"name": k, "value": values[k], "limit": limits[k]} for k in values]

    def _token_gaps(self, prompt, frames, served, weights, cast) -> List[float]:
        """Per served token: how far its reference logit lies below the
        reference's best there; with ``cast``, of the token the reference
        one precision down puts first instead."""
        tpf = vlm_inputs.tokens_per_frame(self.cfg)
        ids = vlm_inputs.request_ids(prompt, len(frames), tpf)
        seq = torch.as_tensor(ids + served[:-1], device=self.device)
        positions = torch.arange(len(ids) - 1, len(ids) - 1 + len(served), device=self.device)
        pixels = vlm_inputs.frame_pixels(frames, self.cfg["vision_config"]["image_size"])
        pixels = pixels.to(self.device)
        video = ref_llava.video_embeddings(pixels, weights, self.cfg)
        logits = ref_llava.logits_at(seq, video, self.cfg["video_token_index"], positions,
                                     weights, self.cfg)
        chosen = torch.as_tensor(served, device=self.device)
        if cast is not None:
            video = ref_llava.video_embeddings(pixels, weights, self.cfg, cast)
            chosen = ref_llava.logits_at(seq, video, self.cfg["video_token_index"], positions,
                                         weights, self.cfg, cast).argmax(dim=-1)
        gap = logits.max(dim=-1).values - logits.gather(1, chosen[:, None])[:, 0]
        return gap.tolist()


def _objects(answer: str):
    """The stand-in's two lines -> (targets, cues)."""
    lines = [line for line in answer.split("\n") if line.strip()]
    return ([o.strip() for o in lines[0].split(",")], [o.strip() for o in lines[1].split(",")])
