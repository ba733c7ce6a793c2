"""Scorer protocol: how the search engine asks a detector about frames (port
of ``tstar_tpu/search/scorers.py``).

    score_grid(secs)   -> (conf (K,), presence (K, C) bool)   # grid pass
    score_verify(secs) -> (conf (K,), presence (K, C) bool)   # 1x1 rescore
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple

import torch


class Scorer(Protocol):
    num_classes: int

    def score_grid(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]: ...

    def score_verify(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]: ...


@dataclasses.dataclass
class TableScorer:
    """Deterministic scorer backed by precomputed per-second tables."""

    grid_conf: torch.Tensor        # (N_pad,)
    grid_presence: torch.Tensor    # (N_pad, C) bool
    verify_conf: torch.Tensor      # (N_pad,)
    verify_presence: torch.Tensor  # (N_pad, C) bool

    @property
    def num_classes(self) -> int:
        return self.grid_presence.shape[-1]

    def score_grid(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.grid_conf[secs], self.grid_presence[secs]

    def score_verify(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.verify_conf[secs], self.verify_presence[secs]
