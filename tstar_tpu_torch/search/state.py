"""Search state (port of ``tstar_tpu/search/state.py``).

The per-second arrays live on the search's device as tensors.  The scalars
the host already knows exactly (video length, budget left, iteration count)
are plain ints: the budget drops by K every step whatever the scores say, so
keeping it on the device would only cost a read per step.  ``rng`` is the
noise source of ``ops/sampling.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

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
