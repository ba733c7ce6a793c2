"""Batched multi-video search (port of ``tstar_tpu/parallel/batched.py``).

B videos search at once: their states stack on a leading axis
(``search/state.stack_states``), their scorers into one that shares the
detector weights (``stack_scorers``), and every step runs ONE grid forward
over B canvases and verification forwards over candidates of all videos.
Videos that finish early keep their state until every video has finished.

The reference's step (``_flat_batched_step``: vmapped sampling, splat,
smoother and replay around flat detector forwards), its active mask
(``_active``) and its verification (``_batched_verification``) are the
phases of ``search/step_graphs.Stepper`` in its 'flat' and 'per_video'
modes, with the step math on the video axis:
  * global-flat buckets (``verify_flat`` None or True): the candidates of
    all videos form one list, rescored ``verify_batch`` at a time by
    ``score_verify_flat``, so the work follows the total candidate count;
  * per-video buckets (``verify_flat=False``): rounds follow the video with
    the most candidates, each ``score_verify_batch`` over (B, width) frames;
  * a width of K frames or more rescores every sampled frame in one forward.
Finished videos' candidates are rescored by no forward (the reference
rescores them and discards the result).  Table scorers take the same flat
steps through ``BatchedTableScorer``'s lookups, and YOLO-World scorers
through their own flat methods (the reference vmaps its single-video step
over them: per video the same detections).

Drivers.  The reference has a one-dispatch ``while_loop`` (``run_search_batched``)
and a host-chained form with a cap (``run_search_batched_chained``), and
``run_search_batched_auto`` picks by a batch size measured on a TPU (and drops
the cap below it).  Here both are the same loop of graph-stepped steps, one
with and one without a cap, so ``_auto`` is the chained driver at every batch
size: the cap always applies.

Not ported: the mesh guard and ``scorer_batch_axes`` (TPU- and mesh-only),
histories (``run_search_batched_with_history``, ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from tstar_tpu_torch.ops.sampling import gumbel_topk_without_replacement, topk_indices
from tstar_tpu_torch.search.detector_scorer import OwlVitScorer
from tstar_tpu_torch.search.scorers import BatchedTableScorer, TableScorer
from tstar_tpu_torch.search.state import BatchedState
from tstar_tpu_torch.search.step_graphs import StepStats, Stepper
from tstar_tpu_torch.search.yolo_scorer import YoloWorldScorer
from tstar_tpu_torch.utils.config import SearchConfig

# Per-video (stacked) fields of each scorer class; the rest (the detector's
# weights and views) is shared by the batch.
_PER_VIDEO_FIELDS = {
    OwlVitScorer: ("cache", "query_embeds", "query_mask", "class_weights"),
    YoloWorldScorer: ("cache", "text_embeds", "query_mask", "class_weights"),
    TableScorer: ("grid_conf", "grid_presence", "verify_conf", "verify_presence"),
}


def stack_scorers(scorers: Sequence, config: SearchConfig):
    """Stack per-video scorers into one batched scorer with shared weights."""
    s0 = scorers[0]
    fields = _PER_VIDEO_FIELDS.get(type(s0))
    if fields is None or any(type(s) is not type(s0) for s in scorers):
        raise TypeError(
            f"batched search needs OwlVitScorer, YoloWorldScorer or TableScorer backends, got "
            f"{sorted({type(s).__name__ for s in scorers})}"
        )
    stacked = {f: torch.stack([getattr(s, f) for s in scorers]) for f in fields}
    if isinstance(s0, TableScorer):
        return BatchedTableScorer(**stacked)
    return dataclasses.replace(s0, config=config, **stacked)


@torch.no_grad()
def batched_search_step(
    states: BatchedState, scorer, config: SearchConfig
) -> BatchedState:
    """One masked step across the video batch, eagerly: videos that have
    finished keep their state (and draw no noise)."""
    stepper = Stepper.batched(states, scorer, config, graphs=False)
    active = stepper.setup()
    if any(active):
        stepper.step(active)
    return stepper.batched_state()


def _batched_pop(states: BatchedState, config: SearchConfig) -> torch.Tensor:
    """Each video's final keyframe seconds, sorted: (B, search_nframes)."""
    weights = states.scores * states.valid
    out = []
    for i, rng in enumerate(states.rngs):
        if config.deterministic_pop:
            secs = topk_indices(weights[i], config.search_nframes)
        else:
            secs, _ = gumbel_topk_without_replacement(rng, weights[i], config.search_nframes)
        out.append(torch.sort(secs).values)
    return torch.stack(out)


@torch.no_grad()
def _run(states, scorer, config, max_iterations, graphs, stats):
    stepper = Stepper.batched(states, scorer, config, graphs, stats)
    stepper.run(max_iterations)
    final = stepper.batched_state()
    return final, _batched_pop(final, config)


def run_search_batched(
    states: BatchedState, scorer, config: SearchConfig,
    graphs: Optional[bool] = None, stats: Optional[StepStats] = None,
) -> Tuple[BatchedState, torch.Tensor]:
    """Search every video to its end; returns (final states, keyframe
    seconds (B, search_nframes)).  ``graphs``: step through CUDA graphs
    (None: on a CUDA device); ``stats``: a ``StepStats`` to fill."""
    return _run(states, scorer, config, None, graphs, stats)


def run_search_batched_chained(
    states: BatchedState, scorer, config: SearchConfig, max_iterations: int,
    graphs: Optional[bool] = None, stats: Optional[StepStats] = None,
) -> Tuple[BatchedState, torch.Tensor]:
    """``run_search_batched`` with at most ``max_iterations`` steps."""
    return _run(states, scorer, config, max_iterations, graphs, stats)


def run_search_batched_auto(
    states: BatchedState, scorer, config: SearchConfig, max_iterations: int,
    graphs: Optional[bool] = None, stats: Optional[StepStats] = None,
) -> Tuple[BatchedState, torch.Tensor]:
    """The batched driver for any batch size: the chained one, whose cap
    applies at every B (module docstring)."""
    return run_search_batched_chained(states, scorer, config, max_iterations, graphs, stats)
