"""Search state (port of ``tstar_tpu/search/state.py``).

The per-second arrays live on the search's device as tensors.  The scalars
the host already knows exactly (video length, budget left, iteration count)
are plain ints: the budget drops by K every step whatever the scores say, so
keeping it on the device would only cost a read per step.  ``rng`` is the
noise source of ``ops/sampling.py``.

``BatchedState`` stacks B videos' states on a leading axis (the reference's
``tree_map(jnp.stack)`` of states).  There a video's budget drops only while
it is active, and whether it is active depends on ``remaining``, which lives
on the device: budget, iteration and length are (B,) tensors beside it.
Noise stays one source per video, so video i draws what its own
single-video search would draw.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from tstar_tpu_torch.utils.config import SearchConfig


@dataclasses.dataclass
class SearchState:
    scores: torch.Tensor     # (N_pad,) f32 per-second score (init 1e-6 on valid)
    visited: torch.Tensor    # (N_pad,) bool; padding counts as visited
    P: torch.Tensor          # (N_pad,) f32 sampling distribution
    remaining: torch.Tensor  # (T_max,) bool remaining-target mask
    budget: int              # scored-frame budget left
    n_valid: int             # true number of 1-fps seconds
    iteration: int           # completed search iterations
    rng: Any                 # noise source: torch.Generator or replay iterator

    @property
    def valid(self) -> torch.Tensor:
        return torch.arange(self.scores.shape[0], device=self.scores.device) < self.n_valid

    def replace(self, **changes) -> "SearchState":
        return dataclasses.replace(self, **changes)


def init_state(
    n_valid: int,
    n_targets: int,
    config: SearchConfig,
    rng: Any,
    n_pad: Optional[int] = None,
    device=None,
) -> SearchState:
    """Initial state: scores = 1e-6, nothing visited, P = 0.3 * conf."""
    n_valid = int(n_valid)
    if n_pad is None:
        n_pad = config.padded_frames(n_valid)
    valid = torch.arange(n_pad, device=device) < n_valid
    zero = torch.zeros((), dtype=torch.float32, device=device)
    scores = torch.where(valid, torch.full_like(zero, config.score_init), zero)
    p0 = config.confidence_threshold * config.p_init_scale
    p = torch.where(valid, torch.full_like(zero, p0), zero)
    remaining = torch.arange(config.max_targets, device=device) < int(n_targets)
    # float32 product, truncated, as the reference computes it
    budget = min(
        config.budget_cap,
        int(np.float32(n_valid) * np.float32(config.search_budget)),
    )
    return SearchState(
        scores=scores,
        visited=~valid,
        P=p,
        remaining=remaining,
        budget=budget,
        n_valid=n_valid,
        iteration=0,
        rng=rng,
    )


@dataclasses.dataclass
class BatchedState:
    scores: torch.Tensor     # (B, N_pad) f32
    visited: torch.Tensor    # (B, N_pad) bool
    P: torch.Tensor          # (B, N_pad) f32
    remaining: torch.Tensor  # (B, T_max) bool
    budget: torch.Tensor     # (B,) int64 scored-frame budget left
    n_valid: torch.Tensor    # (B,) int64 true lengths
    iteration: torch.Tensor  # (B,) int64 completed iterations
    rngs: List[Any]          # B noise sources, one per video

    @property
    def valid(self) -> torch.Tensor:
        n_pad = self.scores.shape[-1]
        return torch.arange(n_pad, device=self.scores.device) < self.n_valid[:, None]

    def replace(self, **changes) -> "BatchedState":
        return dataclasses.replace(self, **changes)


def stack_states(states: Sequence[SearchState]) -> BatchedState:
    """Stack single-video states of one padded length on a leading video
    axis; the noise sources stay per video."""
    if len({s.scores.shape for s in states}) != 1:
        raise ValueError("stacked states must share one padded length")
    device = states[0].scores.device

    def ints(name):
        return torch.tensor([getattr(s, name) for s in states], dtype=torch.int64, device=device)

    return BatchedState(
        scores=torch.stack([s.scores for s in states]),
        visited=torch.stack([s.visited for s in states]),
        P=torch.stack([s.P for s in states]),
        remaining=torch.stack([s.remaining for s in states]),
        budget=ints("budget"),
        n_valid=ints("n_valid"),
        iteration=ints("iteration"),
        rngs=[s.rng for s in states],
    )
