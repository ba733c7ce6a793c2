"""Recall A/B of the detector knobs that change detections, on the port.

    python -m tstar_tpu_torch.tools.ab_knob_recall [--scenes 8] [--seeds 4]
        [--cal-seeds 32] [--checkpoint_dir DIR] [--knobs bf16,int8,...]
        [--device cuda]

What ``detector_quant`` (int8 W8A8, w8a16) and ``verify_image_size`` cost in
keyframe recall, with no checkpoint.  The detector is ``owl-vit-calibrated``
(``framework/heuristics.CalibratedOwlVitHeuristic``): random frozen OWL-ViT
weights whose query embeddings are calibrated to the planted-object scenes,
so the detector's real compute path works as a detector.  At B/32's widths
(12 layers of 768) the class head's context noise drowns the calibrated
signal, so the A/B runs at a scaled geometry with the production token
count:

    image 192 / patch 8  -> S = 577 tokens   (B/32 at 768: 577)
    verify_image_size 128 == 2/3 resolution  (512 / 768)
    verify_image_size  96 == 1/2 resolution  (384 / 768)

The knobs' code paths do not depend on the widths: ``detector_quant``
quantizes the same six matmuls a layer (``models/owlvit_quant.py``), and
``verify_image_size`` resamples the position embedding through the same
``resize_detector``.  What it measures: how the knobs' numerics move
detections, verification decisions and keyframes.  What it cannot: the
recall of released weights.  With ``--checkpoint_dir`` it loads a local HF
OWL-ViT checkpoint instead and runs the knobs at its native geometry
(verification at 512 / 384).

The detector runs in f32; ``bf16`` names the base configuration, the
other knobs' yardstick.  Each (scene, seed) pair runs every knob at the
same budget; the metrics are temporal P / R / F1 at 5 s
(``bench/metrics.temporal_prf``), the mean iterations, each knob's keyframe
overlap and recall delta against ``bf16``, the launches of each port
kernel under the knob and, for the int8 knobs, the int8 tower's route plan
(``models/owlvit_quant.route_counts``: at this geometry K4 takes none of its
matmuls, so all 12 run K4's math in plain ops).  It prints one JSON line
last.

Settings are the reference tool's: the geometry, the seed lottery over
``--cal-seeds`` (the seed with the largest of the smaller of the grid and
verification margins; it refuses a best margin of 0.02 or less), the
knobs, scenes of 180 s at 10 fps, 96x160, a 6 s couch event of size 0.8
starting at a seeded uniform second.  Two differences.  The scenes are
served from memory (``video/synthetic.SyntheticDecoder``), where the
reference writes them through an mp4v encode and decodes them back; the
card's machine has no video codec.  And the lottery's default is 32 seeds,
not 4: the port's ``init_params`` draws other weights than flax's for a
seed (and other weights again under another torch version), and of the
port's draws few calibrate: with torch 2.13 seeds 0-8 give a smaller
margin of at most 0.012 and seed 25 the largest of the first 32 (0.216);
with the card machine's torch 2.11, seed 18 (0.244).  The reference's seed
2 gives both margins above 0.1.

Not measured here, and still open: a float64 smoother (no feature of the
reference), and the K8 attention route against K1 (at this geometry a head
is 16 wide, so attention takes the plain path, neither K1 nor K8).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# The S = 577 geometry: the production token count at calibratable widths.
GEOMETRY = dict(
    vision=dict(hidden_size=64, num_layers=3, num_heads=4,
                intermediate_size=128, patch_size=8, image_size=192),
    text=dict(vocab_size=100, hidden_size=48, num_layers=2,
              num_heads=4, intermediate_size=64, max_length=8),
    projection_dim=48,
)

DURATION = 180.0
EVENT_LEN = 6.0
OBJECT_SIZE = 0.8


def model_config():
    from tstar_tpu_torch.models.owlvit import OwlViTConfig, TextConfig, VisionConfig

    return OwlViTConfig(
        vision=VisionConfig(**GEOMETRY["vision"]),
        text=TextConfig(**GEOMETRY["text"]),
        projection_dim=GEOMETRY["projection_dim"],
    )


def calibrated_heuristic(seed: int, device):
    from tstar_tpu_torch.framework.heuristics import CalibratedOwlVitHeuristic

    return CalibratedOwlVitHeuristic(dtype=torch.float32, model_config=model_config(),
                                     seed=seed, object_size=OBJECT_SIZE, device=device)


def pick_calibrated_heuristic(base_cfg, cal_seeds: int, device):
    """The seed lottery: the quality of random features varies by seed, so
    keep the seed with the best smaller margin (both scales must separate
    for a working detector).  -> (heuristic, seed, margin)."""
    best = None
    for seed in range(cal_seeds):
        h = calibrated_heuristic(seed, device)
        cal = h.calibrate(base_cfg.cache_hw, ["couch"], [], base_cfg)
        margin = min(cal["couch"]["grid_margin"], cal["couch"]["verify_margin"])
        print(f"cal seed {seed}: min margin {margin:+.3f}", flush=True)
        if best is None or margin > best[0]:
            best = (margin, seed, h)
    margin, seed, h = best
    if margin <= 0.02:
        raise SystemExit(
            f"no calibration seed in range({cal_seeds}) yields a working detector "
            f"(best min-margin {margin:+.3f}); raise --cal-seeds")
    return h, seed, margin


def make_scenes(n: int):
    """(decoder, event start) for each scene: a couch for EVENT_LEN seconds
    from a seeded uniform start, 180 s at 10 fps, 96x160."""
    from tstar_tpu_torch.video.synthetic import PlantedObject, SyntheticDecoder

    rng = np.random.default_rng(0)
    scenes = []
    for _ in range(n):
        start = float(rng.uniform(30, DURATION - 40))
        obj = PlantedObject("couch", (start, start + EVENT_LEN), (200, 40, 40), (0.5, 0.45),
                            OBJECT_SIZE)
        scenes.append((lambda o=obj: SyntheticDecoder(DURATION, fps=10.0, hw=(96, 160),
                                                      objects=[o]), start))
    return scenes


def run(heuristic, knob_cfgs: Dict, scenes, seeds: int) -> Dict[str, Dict]:
    """Every knob over every (scene, seed) -> per-knob metrics."""
    from tstar_tpu_torch.bench.metrics import temporal_prf
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models.owlvit_quant import route_counts
    from tstar_tpu_torch.search.searcher import KeyframeSearcher

    out: Dict[str, Dict] = {}
    bf16_frames = {}
    for knob, cfg in knob_cfgs.items():
        gt, pred, iters = [], [], []
        reset_launch_counts()
        t0 = time.perf_counter()
        for i, (make_decoder, start) in enumerate(scenes):
            for seed in range(seeds):
                s = KeyframeSearcher(
                    f"mem://knob-scene{i}", heuristic, ["couch"], [], config=cfg,
                    seed=1000 * seed + i, search_budget=cfg.search_budget,
                    confidence_threshold=cfg.confidence_threshold, decoder=make_decoder(),
                )
                _, ts = s.search()
                gt.append(np.arange(start, start + EVENT_LEN))
                pred.append(np.asarray(ts))
                iters.append(int(s._final_state.iteration))
                if knob == "bf16":
                    bf16_frames[(i, seed)] = set(int(t) for t in ts)
        seconds = time.perf_counter() - t0
        p, r, f1 = temporal_prf(gt, pred, threshold=5)
        entry = {
            "precision": round(float(p), 4),
            "recall": round(float(r), 4),
            "f1": round(float(f1), 4),
            "mean_iterations": round(float(np.mean(iters)), 2),
            "seconds": round(seconds, 3),
            "launches": {k: v for k, v in launch_counts().items() if v},
        }
        if cfg.detector_quant == "int8":
            entry["int8_routes"] = route_counts(s.scorer.qvision)
        if knob != "bf16" and bf16_frames:
            overlaps = []
            idx = 0
            for i in range(len(scenes)):
                for seed in range(seeds):
                    ours = set(int(t) for t in pred[idx])
                    ref = bf16_frames.get((i, seed), set())
                    overlaps.append(len(ours & ref) / max(len(ref), 1))
                    idx += 1
            entry["keyframe_overlap_vs_bf16"] = round(float(np.mean(overlaps)), 4)
        out[knob] = entry
        print(f"{knob}: {entry}", flush=True)
    ref = out.get("bf16", {})
    for e in out.values():
        e["recall_delta_vs_bf16"] = round(e["recall"] - ref.get("recall", 0.0), 4)
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--cal-seeds", type=int, default=32)
    ap.add_argument("--checkpoint_dir", default=None,
                    help="a local HF OWL-ViT checkpoint: the knobs at its native geometry "
                         "(verify 512 / 384) instead of the calibrated scaled detector")
    ap.add_argument("--knobs", default=None, help="comma-separated subset of the knobs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from tstar_tpu_torch.utils.config import SearchConfig

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    base = SearchConfig(search_budget=1.0)
    if args.checkpoint_dir:
        from tstar_tpu_torch.framework.heuristics import OwlVitHeuristic

        h = OwlVitHeuristic(checkpoint_dir=args.checkpoint_dir, dtype=torch.float32,
                            device=device)
        cal_seed, margin = -1, None
        cfg0 = base
        geometry = (f"native checkpoint dims ({args.checkpoint_dir}); "
                    "verify512/verify384 vs the native verify resolution")
        lo, hi = 512, 384
        names = dict(lo="verify512", hi="verify384", combo="int8_verify512")
    else:
        h, cal_seed, margin = pick_calibrated_heuristic(base, args.cal_seeds, device)
        cfg0 = dataclasses.replace(
            base, detector_threshold=h.suggested_detector_threshold,
            confidence_threshold=h.suggested_confidence_threshold,
        )
        geometry = ("S577 (image 192 / patch 8); verify128==2/3 (mirrors 512/768), "
                    "verify96==1/2 (mirrors 384/768)")
        lo, hi = 128, 96
        names = dict(lo="verify128", hi="verify96", combo="int8_verify128")

    knob_cfgs = {
        "bf16": cfg0,
        names["lo"]: dataclasses.replace(cfg0, verify_image_size=lo),
        names["hi"]: dataclasses.replace(cfg0, verify_image_size=hi),
        "int8": dataclasses.replace(cfg0, detector_quant="int8"),
        "w8a16": dataclasses.replace(cfg0, detector_quant="w8a16"),
        names["combo"]: dataclasses.replace(cfg0, detector_quant="int8", verify_image_size=lo),
    }
    wanted = args.knobs.split(",") if args.knobs else list(knob_cfgs)
    knob_cfgs = {k: knob_cfgs[k] for k in wanted if k in knob_cfgs}

    out = {
        "geometry": geometry,
        "weights": "real" if args.checkpoint_dir else "calibrated-random",
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "scene_source": "in-memory SyntheticDecoder",
        "cal_seed": cal_seed,
        "cal_min_margin": None if margin is None else round(margin, 4),
        "scenes": args.scenes,
        "seeds": args.seeds,
        "knobs": run(h, knob_cfgs, make_scenes(args.scenes), args.seeds),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
