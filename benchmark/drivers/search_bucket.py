"""The dataset run's batched search: bucket after bucket of B videos, each
bucket one ``parallel.multi_video._search_bucket`` (B stacked searches, one
grid forward of B canvases a step, the candidates verified in flat batches
of ``verify_batch``), as ``tools/profile_search``'s ``_bucket`` drives it.

Set-up makes B videos' frame caches on the device from the seed (a
``FrameCache`` over a tensor: the card's machine has no decoder, so decode
stays out of the window, as in the JAX benchmark), seeds the detector's
weights on the device, and searches one bucket to warm every shape (graph
captures included).  The window then searches the same videos bucket after
bucket with fresh search seeds, with the per-step histories that the
dataset runner's ``--collect_history`` keeps and ``StepStats(record=True)``,
and closes at the first bucket boundary after ``seconds``.

``frames_per_s``: the frames the detector scored in the window (16 a grid
canvas, one a verification image) over the window.

The check (after the window, the program's state freed): for a sample of
the window's searches drawn from the seed, each step's grid confidences and
verification rescores against the float32 reference detector on the same
frames, and each step's distribution update (splat and spline refit) from
the program's own state before it and its own sampled seconds and
confidences, against the float64 reference update; and for every search of
the window, its keyframes.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops
from benchmark.search_check import (SearchChecker, keyframe_fault, no_tf32, owlvit_heuristic,
                                    search_values)
from benchmark.seeds import derive


def make_frames(n_frames: int, n_pad: int, hw, scene_seconds: int, seed: int, device,
                chunk: int = 600) -> torch.Tensor:
    """(n_pad, h, w, 3) uint8: scenes of ``scene_seconds`` seconds, each a
    random coarse colour field, with a coarse per-second change; zero
    frames past ``n_frames``.  Made on the device from ``seed``."""
    h, w = hw
    gen = torch.Generator(device=device).manual_seed(seed)
    n_scenes = -(-n_frames // scene_seconds)
    scenes = torch.rand(n_scenes, 3, 6, 12, generator=gen, device=device) * 255.0
    wiggle = torch.randn(n_frames, 3, 6, 12, generator=gen, device=device) * 24.0
    out = torch.zeros((n_pad, h, w, 3), dtype=torch.uint8, device=device)
    for s in range(0, n_frames, chunk):
        e = min(n_frames, s + chunk)
        idx = torch.arange(s, e, device=device) // scene_seconds
        coarse = scenes[idx] + wiggle[s:e]
        full = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                               align_corners=False)
        out[s:e] = full.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return out


class Driver:
    """One run of the cell: ``setup``, ``window``, ``release``, ``check``."""

    def __init__(self, cell: Dict, config: Dict, seed: int, device, configs: Dict,
                 traced: bool = False):
        self.cell, self.cfg, self.seed = cell, config, seed
        self.device = torch.device(device)
        t = cell["mix"]
        self.videos, self.seconds_long = t["videos_per_bucket"], t["video_seconds"]
        self.targets, self.cues = t["targets"], t["cues"]
        self.buckets: List[Dict] = []

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from tstar_tpu_torch import SearchConfig
        from tstar_tpu_torch.video.cache import FrameCache

        self.heur, self.weights = owlvit_heuristic(self.cfg, self.device)
        t = self.cell["mix"]
        self.search = SearchConfig(
            cache_hw=tuple(t["cache_hw"]), search_budget=t["search_budget"],
            budget_cap=t["budget_cap"], verify_batch=t["verify_batch"],
            confidence_threshold=t["confidence_threshold"],
            detector_threshold=t["detector_threshold"],
            detector_quant=t.get("detector_quant"), verify_image_size=t.get("verify_image_size"))
        n = int(self.seconds_long * self.search.sampling_fps)
        n_pad = self.search.padded_frames(n)
        self.caches = [
            FrameCache(frames=make_frames(n, n_pad, self.search.cache_hw, t["scene_seconds"],
                                          derive(self.seed, "video", i), self.device),
                       n_valid=n, raw_fps=1.0, duration=float(self.seconds_long))
            for i in range(self.videos)]
        self._bucket("warm-up")
        self.buckets.clear()
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket(self, tag) -> Dict:
        from tstar_tpu_torch.parallel.multi_video import VideoTask, _search_bucket
        from tstar_tpu_torch.search.step_graphs import StepStats

        tasks = [VideoTask(f"mem://bench-video-{i}", list(self.targets), list(self.cues),
                           seed=derive(self.seed, "search", tag, i))
                 for i in range(self.videos)]
        stats = StepStats(record=True)
        with torch.profiler.record_function("bucket.search"):
            rows = _search_bucket(tasks, list(self.caches), self.heur, self.search, None, stats,
                                  collect_history=True)
        with torch.profiler.record_function("bucket.keep_trace"):
            secs = torch.stack([r["secs"] for r in stats.trace]).cpu().numpy()
            conf = torch.stack([r["conf"] for r in stats.trace]).cpu().numpy()
            trace = [(list(r["active"]), s, c) for r, s, c in zip(stats.trace, secs, conf)]
            stats.trace = []
        bucket = {"rows": rows, "trace": trace, "steps": stats.steps,
                  "grid_images": stats.grid_images, "verify_widths": list(stats.verify_widths),
                  "host_reads": stats.host_reads}
        self.buckets.append(bucket)
        return bucket

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> float:
        """Buckets until the first boundary after ``seconds``; returns the
        window's length (host clock, ending in a synchronize)."""
        self._sync()
        t0 = time.perf_counter()
        b = 0
        while True:
            self._bucket(b)
            b += 1
            self._sync()
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        return self.window_s

    def frames(self) -> int:
        k = self.search.frames_per_iteration
        return sum(k * b["grid_images"] + sum(b["verify_widths"]) for b in self.buckets)

    def end_to_end(self) -> Dict[str, float]:
        return {"frames_per_s": self.frames() / self.window_s}

    def attempted(self) -> int:
        return sum(len(b["rows"]) for b in self.buckets)

    def counters(self) -> Dict:
        """What the per-layer readers read: counts of the window's work."""
        v = self.cfg["vision_config"]
        q = self.search.max_objects
        size = v["image_size"]
        image = flops.owlvit_image_flops(v, self.cfg["projection_dim"], q, size)
        text = flops.owlvit_text_flops(self.cfg["text_config"], self.cfg["projection_dim"], q)
        steps = sum(b["steps"] for b in self.buckets)
        grid = sum(b["grid_images"] for b in self.buckets)
        widths = [w for b in self.buckets for w in b["verify_widths"]]
        seq = (size // v["patch_size"]) ** 2 + 1
        heads, hd = v["num_attention_heads"], v["hidden_size"] // v["num_attention_heads"]
        forwards: Dict[int, int] = {}
        for b in self.buckets:
            forwards[self.videos] = forwards.get(self.videos, 0) + b["steps"]
            for w in b["verify_widths"]:
                forwards[w] = forwards.get(w, 0) + 1
        return {
            "frames": self.frames(), "steps": steps,
            "host_reads": sum(b["host_reads"] for b in self.buckets),
            "flops": (grid + sum(widths)) * image + self.attempted() * text,
            "attention_forwards": [
                {"batch": bb, "seq": seq, "heads": heads, "head_dim": hd,
                 "layers": v["num_hidden_layers"], "count": n}
                for bb, n in sorted(forwards.items())],
        }

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.heur
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------
    def check(self, control: bool = False) -> List[Dict]:
        """-> [{"name", "value", "limit"}]: the numbers compared
        (``search_check``); ``control``: the reference one precision down
        in the program's place, which has to come out as not correct."""
        limits = self.cell["limits"]
        self.failed = sum(
            keyframe_fault(r["keyframe_secs"], r["Score_history"][-1],
                           len(r["keyframe_distribution"]), self.search)
            for b in self.buckets for r in b["rows"])
        rng = np.random.default_rng(derive(self.seed, "check"))
        pairs = [(bi, vi) for bi in range(len(self.buckets)) for vi in range(self.videos)]
        n_check = min(self.cell["check"]["searches"], len(pairs))
        picked = [pairs[i] for i in sorted(rng.choice(len(pairs), n_check, replace=False))]
        grid, verify, update = [], [], []
        with no_tf32():
            checker = SearchChecker(self.cfg, self.weights, self.search, self.targets, self.cues,
                                    self.cell["check"], self.device, control)
            for bi, vi in picked:
                bucket = self.buckets[bi]
                steps = [(secs[vi], conf[vi]) for active, secs, conf in bucket["trace"]
                         if active[vi]]
                g, v, u = checker.readings(bucket["rows"][vi], steps,
                                           self.caches[vi].frames, rng)
                grid, verify, update = grid + g, verify + v, update + u
        self.readings = {"grid_gaps": grid, "verify_gaps": verify, "p_gaps": update}
        values = dict(search_values(grid, verify, update), keyframe_faults=float(self.failed))
        return [{"name": k, "value": values[k], "limit": limits[k]} for k in values]
