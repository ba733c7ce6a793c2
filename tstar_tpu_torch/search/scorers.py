"""Scorer protocol: how the search engine asks a detector about frames (port
of ``tstar_tpu/search/scorers.py``).

    score_grid(secs)   -> (conf (K,), presence (K, C) bool)   # grid pass
    score_verify(secs) -> (conf (K,), presence (K, C) bool)   # 1x1 rescore

A scorer stacked over B videos (``parallel/batched.stack_scorers``) scores
with ``score_grid_batch`` ((B, K) seconds), ``score_verify_batch`` ((B, T)
seconds) and ``score_verify_flat`` ((W,) video indices, (W,) seconds).
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


@dataclasses.dataclass
class BatchedTableScorer:
    """B videos' tables stacked on a leading axis.  A lookup does not depend
    on what else is looked up, so the batched search's flat steps give each
    video what its own table search gives (the reference vmaps the
    single-video step over table scorers)."""

    grid_conf: torch.Tensor        # (B, N_pad)
    grid_presence: torch.Tensor    # (B, N_pad, C) bool
    verify_conf: torch.Tensor      # (B, N_pad)
    verify_presence: torch.Tensor  # (B, N_pad, C) bool

    @property
    def num_classes(self) -> int:
        return self.grid_presence.shape[-1]

    @staticmethod
    def _lookup(conf, presence, video_idx, secs):
        return conf[video_idx, secs], presence[video_idx, secs]

    def score_grid_batch(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        rows = torch.arange(secs.shape[0], device=secs.device)[:, None]
        return self._lookup(self.grid_conf, self.grid_presence, rows, secs)

    def score_verify_batch(self, secs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        rows = torch.arange(secs.shape[0], device=secs.device)[:, None]
        return self._lookup(self.verify_conf, self.verify_presence, rows, secs)

    def score_verify_flat(
        self, video_idx: torch.Tensor, secs: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._lookup(self.verify_conf, self.verify_presence, video_idx, secs)
