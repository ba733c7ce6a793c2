"""The T* search loop (port of ``tstar_tpu/search/engine.py``).

The reference runs the whole search as one ``lax.while_loop`` on the device.
Here ``run_search`` is a host loop of ``search_step`` calls.  Each step reads
the device twice: the verification candidate count (whether and how wide to
rescore) and the loop condition ``_continue`` (any target left).  Everything
else, sampling included, stays on the device.

Semantics are the reference's, step for step:
  * iteration-0 uniform stride sampling, then quartile-masked resampling of
    unvisited seconds with the ``(P + K/N)`` exploration bonus and the
    starved-mask fallback;
  * direct score writes, then the order-dependent windowed max-splat over the
    top quartile of this batch;
  * smoother -> 1/N floor -> sigmoid -> normalize;
  * verification AFTER the distribution update: rescore triggered frames,
    overwrite their scores, and remove at most one target per frame;
  * budget decrement per grid and the ``remaining and budget > 0`` exit;
    final keyframes drawn from the score distribution (or top-k).

Noise: ``state.rng`` is a noise source (``ops/sampling.py``); a step draws
from it only when it samples (not at iteration 0), and the final pop draws
once unless ``deterministic_pop``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.ops.percentile import masked_percentile
from tstar_tpu_torch.ops.sampling import (
    gumbel_topk_without_replacement,
    topk_indices,
    uniform_stride_indices,
)
from tstar_tpu_torch.ops.smoother import smoothing_spline_distribution
from tstar_tpu_torch.ops.splat import window_splat
from tstar_tpu_torch.search.scorers import Scorer
from tstar_tpu_torch.search.state import SearchState


def sample_frame_secs(state: SearchState, config: SearchConfig) -> torch.Tensor:
    """Choose the K seconds to score this iteration."""
    k = config.frames_per_iteration
    if state.iteration == 0:
        return uniform_stride_indices(state.n_valid, k, device=state.scores.device)
    valid = state.valid
    bonus = float(np.float32(k) / np.float32(state.n_valid))
    non_visiting = (~state.visited).to(state.P.dtype)
    p_bonus = (state.P + bonus) * valid
    weights = p_bonus * non_visiting
    thr = masked_percentile(weights, config.top_percentile, valid)
    masked = weights * (weights >= thr)
    # When the quartile mask starves the sampler, drop BOTH the mask and the
    # non-visiting filter (the reference's fallback).
    starved = (masked.sum() == 0) | ((masked > 0).sum() < k)
    weights = torch.where(starved, p_bonus, masked)
    idx, _ = gumbel_topk_without_replacement(state.rng, weights, k)
    return idx


def _percentile_static(x: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile('linear') over a fully valid vector."""
    s = torch.sort(x).values
    pos = (x.shape[0] - 1) * (q / 100.0)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def verification_replay(
    scores: torch.Tensor,
    remaining: torch.Tensor,
    secs: torch.Tensor,             # (K,)
    target_presence: torch.Tensor,  # (K, T)
    vconf: torch.Tensor,            # (K,)
    vpres_t: torch.Tensor,          # (K, T)
    config: SearchConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's per-frame removal loop with the rescores precomputed:
    a triggered frame overwrites its score, and at most the FIRST remaining
    passing target per frame is removed.  No host reads."""
    scores = scores.clone()
    slots = torch.arange(remaining.shape[0], device=remaining.device)
    for k in range(secs.shape[0]):
        in_cell = target_presence[k] & remaining
        triggered = in_cell.any()
        sec = secs[k:k + 1]
        scores.index_put_((sec,), torch.where(triggered, vconf[k:k + 1], scores[sec]))
        passing = in_cell & vpres_t[k] & (vconf[k] > config.confidence_threshold)
        first = torch.argmax(passing.to(torch.int32))
        remaining = remaining & ~((slots == first) & passing.any())
    return scores, remaining


def _apply_verification(
    scores: torch.Tensor,
    remaining: torch.Tensor,
    secs: torch.Tensor,
    grid_presence: torch.Tensor,  # (K, C)
    scorer: Scorer,
    config: SearchConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential target verification.

    Frames whose grid cell shows a remaining target are candidates; only
    they can trigger (removals only shrink the trigger set), so only they
    are rescored: ``verify_batch`` at a time (bucketed), or all K frames in
    one forward when the width is K or, with ``verify_adaptive``, when more
    than half the frames are candidates.  Both forms fill the candidate rows
    identically, so the trajectory does not depend on the choice.
    """
    t_max = config.max_targets
    k_frames = secs.shape[0]
    target_presence = grid_presence[:, :t_max]
    candidate = (target_presence & remaining[None, :]).any(dim=-1)
    n_cand = int(candidate.sum())                       # host read
    if n_cand == 0:
        return scores, remaining

    t_bucket = min(config.verify_batch or k_frames, k_frames)
    wide = t_bucket >= k_frames or (config.verify_adaptive and n_cand * 2 > k_frames)
    if wide:
        vconf, vpres = scorer.score_verify(secs)
        vpres_t = vpres[:, :t_max]
    else:
        # stable partition: candidate frames first, in their original order
        order = torch.argsort((~candidate).to(torch.int32), stable=True)
        vconf = torch.zeros(k_frames, dtype=torch.float32, device=secs.device)
        vpres_t = torch.zeros(k_frames, t_max, dtype=torch.bool, device=secs.device)
        r = 0
        while r * t_bucket < n_cand:
            # the last round's start clamps like lax.dynamic_slice; its extra
            # rows land on frames the replay never reads
            start = min(r * t_bucket, k_frames - t_bucket)
            idx = order[start:start + t_bucket]
            c, p = scorer.score_verify(secs[idx])
            vconf[idx] = c.to(vconf.dtype)
            vpres_t[idx] = p[:, :t_max]
            r += 1
    return verification_replay(
        scores, remaining, secs, target_presence, vconf, vpres_t, config
    )


def apply_grid_scores(
    state: SearchState, secs: torch.Tensor, conf: torch.Tensor, config: SearchConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Visited marks + raw writes, windowed top-quartile splat, smoother
    refit.  Returns (scores, visited, P, is_top)."""
    scores = state.scores.index_put((secs,), conf.to(state.scores.dtype))
    visited = state.visited.index_put(
        (secs,), torch.ones_like(secs, dtype=torch.bool)
    )
    thr = _percentile_static(conf, config.top_percentile)
    is_top = conf >= thr
    scores = window_splat(scores, secs, is_top, state.n_valid, config.window_size)
    p = smoothing_spline_distribution(
        scores, visited, state.valid, state.n_valid, smoothing=config.spline_smoothing
    )
    return scores, visited, p, is_top


def search_step(
    state: SearchState, scorer: Scorer, config: SearchConfig
) -> Tuple[SearchState, Dict[str, torch.Tensor]]:
    """One search iteration: (new state, aux with secs/conf/presence/is_top)."""
    secs = sample_frame_secs(state, config)
    return presampled_search_step(state, secs, scorer, config)


def presampled_search_step(
    state: SearchState, secs: torch.Tensor, scorer: Scorer, config: SearchConfig
) -> Tuple[SearchState, Dict[str, torch.Tensor]]:
    """``search_step`` after the sampling."""
    conf, presence = scorer.score_grid(secs)
    scores, visited, p, is_top = apply_grid_scores(state, secs, conf, config)
    scores, remaining = _apply_verification(
        scores, state.remaining, secs, presence, scorer, config
    )
    new_state = state.replace(
        scores=scores,
        visited=visited,
        P=p,
        remaining=remaining,
        budget=state.budget - config.frames_per_iteration,
        iteration=state.iteration + 1,
    )
    aux = {"secs": secs, "conf": conf, "presence": presence, "is_top": is_top}
    return new_state, aux


def pop_frame_secs(state: SearchState, config: SearchConfig) -> torch.Tensor:
    """Final keyframe seconds (sorted): a draw proportional to the scores, or
    the top-k under ``deterministic_pop``."""
    weights = state.scores * state.valid
    if config.deterministic_pop:
        secs = topk_indices(weights, config.search_nframes)
    else:
        secs, _ = gumbel_topk_without_replacement(
            state.rng, weights, config.search_nframes
        )
    return torch.sort(secs).values


def _continue(state: SearchState) -> bool:
    """Loop condition; reads ``remaining`` from the device once."""
    return state.budget > 0 and bool(state.remaining.any())


def run_search(
    state: SearchState, scorer: Scorer, config: SearchConfig
) -> Tuple[SearchState, torch.Tensor]:
    """Full search: host loop of steps + final pop.

    Returns (final state, sorted keyframe seconds (search_nframes,)).
    """
    while _continue(state):
        state, _ = search_step(state, scorer, config)
    return state, pop_frame_secs(state, config)
