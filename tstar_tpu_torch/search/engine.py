"""The T* search loop (port of ``tstar_tpu/search/engine.py``).

The reference runs the whole search as one ``lax.while_loop`` on the device.
Here a search is a host loop of steps (``search/step_graphs.py``), each of
three phases over static device buffers, replayed as CUDA graphs on the card.
The host reads the device twice a step: the verification candidate count
(how many rescore rounds) and the loop condition (any target left).
Everything else, sampling included, stays on the device.  A streaming
search (``run_search_streaming``) also reads each step's sampled seconds,
to decode their frames on the host.

The step math below works on a leading video axis, (B, N_pad) rows that never
mix, so one code path serves the single-video search (B = 1) and the
batched multi-video search (``parallel/batched.py``).

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
from typing import Any, Dict, List, Optional, Tuple

import torch

from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.ops.percentile import masked_percentile
from tstar_tpu_torch.ops.sampling import (
    draw_gumbel,
    gumbel_topk_from_noise,
    gumbel_topk_without_replacement,
    topk_indices,
    uniform_stride_indices,
)
from tstar_tpu_torch.ops.smoother import smoothing_spline_distribution
from tstar_tpu_torch.ops.splat import window_splat
from tstar_tpu_torch.search.scorers import Scorer
from tstar_tpu_torch.search.state import SearchState


def sample_secs(
    P: torch.Tensor,              # (B, N_pad)
    visited: torch.Tensor,        # (B, N_pad) bool
    valid: torch.Tensor,          # (B, N_pad) bool
    n_valid: torch.Tensor,        # (B,) int64
    gumbel: Optional[torch.Tensor],   # (B, N_pad) noise, None when every row is first
    first: Optional[torch.Tensor],    # (B,) bool rows at iteration 0; None: no row is
    config: SearchConfig,
) -> torch.Tensor:
    """Choose the K seconds of each row to score this iteration, (B, K)."""
    k = config.frames_per_iteration
    stride = uniform_stride_indices(n_valid, k) if first is not None else None
    if gumbel is None:
        return stride
    draw, _, _ = sampling_weights(P, visited, valid, n_valid, config)
    idx, _ = gumbel_topk_from_noise(gumbel, draw, k)
    return idx if stride is None else torch.where(first[:, None], stride, idx)


def sampling_weights(P, visited, valid, n_valid, config: SearchConfig):
    """What ``sample_secs`` draws from -> (the drawn weights, the weights
    before the quartile mask (P + K/N on the valid, unvisited seconds), the
    mask's threshold (B, 1)), all (B, N_pad) rows."""
    k = config.frames_per_iteration
    nf = n_valid.to(P.dtype)
    bonus = torch.div(torch.full_like(nf, float(k)), nf)[:, None]   # float32 K/N
    non_visiting = (~visited).to(P.dtype)
    p_bonus = (P + bonus) * valid
    weights = p_bonus * non_visiting
    thr = masked_percentile(weights, config.top_percentile, valid)[:, None]
    masked = weights * (weights >= thr)
    # When the quartile mask starves the sampler, drop BOTH the mask and the
    # non-visiting filter (the reference's fallback).
    starved = (masked.sum(dim=-1, keepdim=True) == 0) | (
        (masked > 0).sum(dim=-1, keepdim=True) < k
    )
    return torch.where(starved, p_bonus, masked), weights, thr


def _percentile_static(x: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile('linear') of each fully valid row (last axis)."""
    s = torch.sort(x, dim=-1).values
    pos = (x.shape[-1] - 1) * (q / 100.0)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return s[..., lo] * (1.0 - frac) + s[..., hi] * frac


def apply_grid_scores(
    scores: torch.Tensor, visited: torch.Tensor, valid: torch.Tensor,
    n_valid: torch.Tensor, secs: torch.Tensor, conf: torch.Tensor, config: SearchConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Visited marks + raw writes, windowed top-quartile splat, smoother
    refit, on (B, N_pad) rows.  Returns (scores, visited, P)."""
    scores = scores.scatter(-1, secs, conf.to(scores.dtype))
    visited = visited.scatter(-1, secs, torch.ones_like(secs, dtype=torch.bool))
    thr = _percentile_static(conf, config.top_percentile)
    is_top = conf >= thr[:, None]
    scores = window_splat(scores, secs, is_top, n_valid, config.window_size)
    p = smoothing_spline_distribution(
        scores, visited, valid, n_valid, smoothing=config.spline_smoothing
    )
    return scores, visited, p


def replay_verification(
    scores: torch.Tensor,           # (B, N_pad)
    remaining: torch.Tensor,        # (B, T)
    secs: torch.Tensor,             # (B, K)
    target_presence: torch.Tensor,  # (B, K, T)
    vconf: torch.Tensor,            # (B, K)
    vpres_t: torch.Tensor,          # (B, K, T)
    config: SearchConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's per-frame removal loop with the rescores precomputed:
    a triggered frame overwrites its score, and at most the FIRST remaining
    passing target per frame is removed.  No host reads."""
    scores = scores.clone()
    slots = torch.arange(remaining.shape[-1], device=remaining.device)
    for k in range(secs.shape[-1]):
        in_cell = target_presence[:, k] & remaining
        triggered = in_cell.any(dim=-1, keepdim=True)
        sec = secs[:, k:k + 1]
        scores.scatter_(-1, sec, torch.where(triggered, vconf[:, k:k + 1], scores.gather(-1, sec)))
        passing = in_cell & vpres_t[:, k] & (vconf[:, k:k + 1] > config.confidence_threshold)
        first = torch.argmax(passing.to(torch.int32), dim=-1, keepdim=True)
        remaining = remaining & ~((slots == first) & passing.any(dim=-1, keepdim=True))
    return scores, remaining


def verification_replay(
    scores: torch.Tensor,           # (N_pad,)
    remaining: torch.Tensor,        # (T,)
    secs: torch.Tensor,             # (K,)
    target_presence: torch.Tensor,  # (K, T)
    vconf: torch.Tensor,            # (K,)
    vpres_t: torch.Tensor,          # (K, T)
    config: SearchConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``replay_verification`` of one video."""
    s, r = replay_verification(
        scores[None], remaining[None], secs[None].to(torch.int64), target_presence[None],
        vconf[None], vpres_t[None], config,
    )
    return s[0], r[0]


def sample_frame_secs(state: SearchState, config: SearchConfig) -> torch.Tensor:
    """Choose the K seconds to score this iteration (draws from ``state.rng``
    after iteration 0)."""
    device = state.scores.device
    n_valid = torch.full((1,), state.n_valid, dtype=torch.int64, device=device)
    if state.iteration == 0:
        return sample_secs(state.P[None], state.visited[None], state.valid[None], n_valid,
                           None, torch.ones(1, dtype=torch.bool, device=device), config)[0]
    gumbel = draw_gumbel(state.rng, state.P.shape[0], device)[None]
    return sample_secs(state.P[None], state.visited[None], state.valid[None], n_valid,
                       gumbel, None, config)[0]


def search_step(
    state: SearchState, scorer: Scorer, config: SearchConfig
) -> Tuple[SearchState, Dict[str, torch.Tensor]]:
    """One search iteration, eagerly: (new state, aux with secs / conf)."""
    from tstar_tpu_torch.search.step_graphs import Stepper

    stepper = Stepper.single(state, scorer, config, graphs=False)
    stepper.setup()
    stepper.step([True])
    return stepper.single_state(state, steps=1), {
        "secs": stepper.secs[0].clone(), "conf": stepper.conf[0].clone(),
    }


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


def masked_search_step(
    state: SearchState, scorer: Scorer, config: SearchConfig
) -> SearchState:
    """One step that is the identity once the loop condition has exited."""
    return search_step(state, scorer, config)[0] if _continue(state) else state


def run_search(
    state: SearchState, scorer: Scorer, config: SearchConfig,
    graphs: Optional[bool] = None, stats=None,
) -> Tuple[SearchState, torch.Tensor]:
    """Full search: steps until no target is left or the budget is spent,
    then the final pop.  Returns (final state, sorted keyframe seconds
    (search_nframes,)).

    ``graphs``: step through CUDA graphs (None: on a CUDA device); False runs
    every phase eagerly.  ``stats``: a ``step_graphs.StepStats`` to fill.
    """
    from tstar_tpu_torch.search.step_graphs import run_single

    final = run_single(state, scorer, config, None, graphs, stats)
    return final, pop_frame_secs(final, config)


def run_search_chained(
    state: SearchState,
    scorer: Scorer,
    config: SearchConfig,
    max_iterations: Optional[int] = None,
    graphs: Optional[bool] = None,
    stats=None,
) -> Tuple[SearchState, torch.Tensor]:
    """``run_search`` with at most ``max_iterations`` steps (default
    ``config.iteration_cap``): the reference's chain of masked steps, whose
    steps after the loop condition exits are identities.  The same results
    as ``run_search`` whenever the cap is not reached."""
    from tstar_tpu_torch.search.step_graphs import run_single

    if max_iterations is None:
        max_iterations = config.iteration_cap(state.n_valid)
    final = run_single(state, scorer, config, max_iterations, graphs, stats)
    return final, pop_frame_secs(final, config)


def run_search_streaming(
    state: SearchState, scorer: Scorer, stream, config: SearchConfig,
    graphs: Optional[bool] = None, stats=None,
) -> Tuple[SearchState, torch.Tensor]:
    """``run_search`` over a streaming cache (``video/cache.StreamingFrameCache``):
    each step's sampled seconds are read by the host, their frames decoded
    at the full cache resolution (``stream.gather_host``) and copied into
    the scorer's static step buffer, between the sampling and the grid
    forward (``step_graphs.Stepper``: three host reads a step).  The same
    steps, trajectory and keyframes as the resident search over the same
    frames; memory does not grow with the video's length.  A scorer without
    a step buffer raises ``TypeError``."""
    from tstar_tpu_torch.search.step_graphs import run_single

    final = run_single(state, scorer, config, None, graphs, stats, paged=stream)
    return final, pop_frame_secs(final, config)


def run_search_with_history(
    state: SearchState, scorer: Scorer, config: SearchConfig,
    graphs: Optional[bool] = None, stats=None,
) -> Tuple[SearchState, torch.Tensor, List[Dict[str, Any]]]:
    """``run_search`` that also keeps each step's snapshot for the
    visualization sinks: (final state, keyframe seconds, history), one
    history entry a step with the host arrays ``P``, ``scores``, ``visited``
    (N_pad,), ``secs``, ``conf`` (K,) and, where the scorer has
    ``score_grid_detailed``, ``detections`` ({"scores", "class_ids",
    "boxes", "valid"}, the grid image's top boxes).

    The same steps as ``run_search`` (on a CUDA device through the same CUDA
    graphs, in history mode: ``step_graphs.Stepper``), so the same
    trajectory and two host reads a step; the history is read once, after
    the loop."""
    from tstar_tpu_torch.search.step_graphs import run_single

    final, history = run_single(state, scorer, config, None, graphs, stats, history=True)
    return final, pop_frame_secs(final, config), history
