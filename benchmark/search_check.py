"""What the search cells share: the detector built from the benchmark's own
weights, and the check of a search's steps against the plain references.

The check follows the program step by step from its own state: for each
step sampled, the state the step started from (the program's scores and
visited seconds after the step before), its sampled seconds and grid
confidences are the program's; the reference then works out again

  * the grid canvas's per-cell confidences (float32 OWL-ViT on the same
    frames of the same cache), as bounds that allow a near-tie of two
    queries or a box centre at a cell's edge to fall either way;
  * each rescored second's verification confidence, likewise, or, where the
    second was not rescored, its splat value;
  * the update: splat and spline refit, in float64, against the program's
    distribution after the step, over the visited seconds of the steps
    whose spline is well conditioned;

and, for every search, the keyframes.  ``control`` puts the reference in the
program's place one precision below the configuration's: fp8 e4m3 operands
for the bf16 detector, bfloat16 for the float32 update.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import owlvit as ref_owlvit
from benchmark.reference import search_update
from benchmark.reference.prompts import prompt_batch
from benchmark.weights import seeded_weights


def owlvit_heuristic(cfg: Dict, device):
    """The program's OWL-ViT heuristic (``owl-vit-random``) at the
    configuration's sizes, holding the benchmark's weights (seeded on the
    device from the configuration's ``weights_seed``) -> (heuristic,
    weights)."""
    from tstar_tpu_torch.framework import heuristics
    from tstar_tpu_torch.models.owlvit import OwlViTConfig, TextConfig, VisionConfig

    v, tx = cfg["vision_config"], cfg["text_config"]
    model_cfg = OwlViTConfig(
        vision=VisionConfig(
            hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"], intermediate_size=v["intermediate_size"],
            patch_size=v["patch_size"], image_size=v["image_size"],
            activation=v["hidden_act"], eps=v["layer_norm_eps"]),
        text=TextConfig(
            vocab_size=tx["vocab_size"], hidden_size=tx["hidden_size"],
            num_layers=tx["num_hidden_layers"], num_heads=tx["num_attention_heads"],
            intermediate_size=tx["intermediate_size"],
            max_length=tx["max_position_embeddings"], activation=tx["hidden_act"],
            eps=tx["layer_norm_eps"]),
        projection_dim=cfg["projection_dim"])
    dtype = getattr(torch, cfg["torch_dtype"])
    # The benchmark makes the weights itself, on the device; the program's
    # own seeded host init of owl-vit-random is skipped.
    init = heuristics.init_params
    heuristics.init_params = lambda model, seed: model
    try:
        heur = heuristics.initialize_heuristic(
            "owl-vit-random", model_config=model_cfg, device=str(device), dtype=dtype)
    finally:
        heuristics.init_params = init
    shapes = [(k, tuple(p.shape)) for k, p in heur.model.state_dict().items()]
    # one fixed set of weights, as a deployment serves one checkpoint
    weights = seeded_weights(shapes, cfg["weights_seed"], device, dtype)
    with torch.no_grad():
        for k, p in heur.model.state_dict().items():
            p.copy_(weights[k])
    return heur, weights


def outside(values, lo, hi) -> np.ndarray:
    """How far each value lies outside [lo, hi]."""
    return np.maximum(0.0, np.maximum(values - hi, lo - values))


class no_tf32:
    """The reference's float32 products in float32, not TF32."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


class SearchChecker:
    """The reference's side of a search cell's check, for one detector
    configuration, prompt set and search config (``search``)."""

    def __init__(self, cfg: Dict, weights, search, targets: Sequence[str], cues: Sequence[str],
                 tolerances: Dict, device, control: bool = False):
        self.cfg, self.search, self.tol, self.device = cfg, search, tolerances, device
        self.w32 = ref_owlvit.to_float32(weights)
        t = cfg["text_config"]
        ids, mask, qmask, cw = prompt_batch(
            targets, cues, t["vocab_size"], t["max_position_embeddings"], search.max_objects,
            search.target_weight, search.cue_weight)
        self.prompts = tuple(torch.as_tensor(a, device=device) for a in (ids, mask, qmask, cw))
        self.queries = self._queries()
        self.cast = ref_owlvit.fp8_e4m3 if control else None
        self.lower = self._queries(self.cast) if control else None

    def _queries(self, cast=None):
        ids, mask, qmask, cw = self.prompts
        return ref_owlvit.text_queries(ids, mask, self.w32, self.cfg, cast), qmask, cw

    def _bounds(self, pixels, rows, cols, queries, cast=None, exact=False):
        """The reference detector over ``pixels`` in blocks of 8 images ->
        each cell's confidence bounds (low, high); ``exact``: without the
        tie and edge allowance (low = high, the confidence itself)."""
        emb, qmask, cw = queries
        tie, edge = (0.0, 0.0) if exact else (self.tol["tie_logit"], self.tol["edge_px"])
        los, his = [], []
        for s in range(0, pixels.shape[0], 8):
            feats = ref_owlvit.image_features(pixels[s:s + 8], self.w32, self.cfg, cast)
            logits, centres = ref_owlvit.detect(feats, emb, qmask, self.w32, pixels.shape[1],
                                                self.cfg["vision_config"]["patch_size"], cast)
            lo, hi = ref_owlvit.cell_confidence_bounds(
                logits, centres, cw, self.search.detector_threshold, rows, cols,
                pixels.shape[1], tie, edge)
            los.append(lo)
            his.append(hi)
        return torch.cat(los).cpu().numpy(), torch.cat(his).cpu().numpy()

    def readings(self, hist: Dict, steps: List[Tuple[np.ndarray, np.ndarray]], frames,
                 rng) -> Tuple[List[float], List[float], List[float]]:
        """One search's (grid gaps, verification gaps, update gaps) over a
        sample of its steps, the first and the last among them.  ``hist``:
        the program's ``Score_history``, ``non_visiting_history`` and
        ``P_history`` (after each step, over the video's seconds);
        ``steps``: each step's (sampled seconds, grid confidences);
        ``frames``: the video's frame cache on the device."""
        cfg = self.search
        s_hist = np.asarray(hist["Score_history"], np.float64)
        visited_hist = np.asarray(hist["non_visiting_history"], np.float64) < 0.5
        p_hist = np.asarray(hist["P_history"], np.float64)
        n = s_hist.shape[1]
        size = self.cfg["vision_config"]["image_size"]
        k = min(self.tol["steps"], len(steps))
        sample = rng.choice(len(steps), k, replace=False).tolist()
        chosen = sorted({0, len(steps) - 1} | set(sample))
        splats, visited = [], []
        for t in chosen:
            secs, conf = steps[t]
            # the state the step starts from: the initial one, then the program's
            prev = s_hist[t - 1] if t else np.full(n, cfg.score_init)
            vis = visited_hist[t - 1].copy() if t else np.zeros(n, bool)
            splats.append(search_update.splat(prev, secs, conf, n, cfg.window_size,
                                              cfg.top_percentile))
            vis[secs] = True
            visited.append(vis)
        splats, visited = np.stack(splats), np.stack(visited)
        p_ref, log_lam = search_update.distribution(splats, visited, n, cfg.spline_smoothing)
        p_got = p_hist[chosen]
        if self.lower is not None:
            p_got = search_update.distribution(splats, visited, n, cfg.spline_smoothing,
                                               dtype=torch.bfloat16)[0]
        # Over the visited seconds of the steps whose spline is well
        # conditioned: a float32 solve at a large lam with long unvisited
        # runs parts from the exact fit by up to tens of percent (a few at
        # the visited seconds), and the update there is not compared.
        gap = np.where(visited, np.abs(p_got - p_ref), 0.0).max(axis=1) / p_ref.max(axis=1)
        p_gaps = gap[log_lam <= self.tol["update_log10_lam_max"]].tolist()

        grid_gaps, verify_gaps = [], []
        rows, cols = cfg.grid_rows, cfg.grid_cols
        for j, t in enumerate(chosen):
            secs, conf = steps[t]
            idx = torch.as_tensor(secs, device=frames.device)
            canvas = ref_owlvit.grid_canvas(frames[idx], rows, cols, size)
            images = ref_owlvit.clip_normalise(ref_owlvit.resize_bilinear(frames[idx],
                                                                          (size, size)))
            got = s_hist[t][secs]
            if self.lower is not None:
                conf = self._bounds(canvas, rows, cols, self.lower, self.cast, exact=True)[0][0]
                got = self._bounds(images, 1, 1, self.lower, self.cast, exact=True)[0][:, 0]
            lo, hi = self._bounds(canvas, rows, cols, self.queries)
            grid_gaps += outside(conf, lo[0], hi[0]).tolist()
            lo, hi = self._bounds(images, 1, 1, self.queries)
            # a rescored second holds its verification confidence, another
            # its splat value
            verify_gaps += np.minimum(outside(got, lo[:, 0], hi[:, 0]),
                                      np.abs(got - splats[j][secs])).tolist()
        return grid_gaps, verify_gaps, p_gaps


def keyframe_fault(secs: Sequence[int], final_scores, n: int, search) -> int:
    """1 unless a search's keyframes are ``search_nframes`` distinct seconds
    of the video, sorted, each one the search scored or spread a score to
    (a draw proportional to the scores lands on an unscored second with
    odds of about 1e-5)."""
    ok = (len(secs) == search.search_nframes and len(set(secs)) == len(secs)
          and list(secs) == sorted(secs) and all(0 <= s < n for s in secs))
    if ok:
        ok = all(final_scores[s] > 10 * search.score_init for s in secs)
    return 0 if ok else 1


def search_values(grid, verify, update) -> Dict[str, float]:
    """The three numbers a search's readings give."""
    return {"grid_conf_gap": max(grid, default=math.inf),
            "verify_conf_gap": max(verify, default=math.inf),
            "p_update_gap": max(update, default=math.inf)}
