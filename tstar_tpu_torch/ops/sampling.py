"""Frame-index sampling for the T* search loop (port of ``tstar_tpu/ops/sampling.py``).

Sampling without replacement from a categorical distribution is the
Gumbel-top-k trick: add i.i.d. Gumbel noise to the log-weights and take the
k largest.  The noise comes from a source the caller passes in:

* a ``torch.Generator`` (the main path; it draws on the generator's device);
* an iterator of replayed noise vectors (tests feed the JAX key schedule's
  draws, so the port and the reference sample the same seconds).

Top-k breaks ties by the lowest index, as ``lax.top_k`` does: ties are common
because every unvisited second starts at ``score_init``.
"""

from __future__ import annotations

from typing import Iterator, Tuple, Union

import numpy as np
import torch

NoiseSource = Union[torch.Generator, Iterator]


def uniform_stride_indices(total_frames, k: int, device=None) -> torch.Tensor:
    """First-iteration uniform sampling: ``arange(K) * (N // K)``; (K,) for
    an int ``total_frames``, (B, K) for a (B,) tensor of lengths."""
    if isinstance(total_frames, torch.Tensor):
        stride = torch.div(total_frames, k, rounding_mode="floor")
        return torch.arange(k, dtype=torch.int64, device=total_frames.device) * stride[:, None]
    return torch.arange(k, dtype=torch.int64, device=device) * (int(total_frames) // k)


def draw_gumbel(noise: NoiseSource, n: int, device) -> torch.Tensor:
    """(n,) float32 standard Gumbel noise from ``noise``.

    A generator draws ``-log(-log(u))`` with ``u`` uniform on [tiny, 1), the
    formula of ``jax.random.gumbel``; a replay iterator yields the next
    recorded vector.
    """
    if isinstance(noise, torch.Generator):
        u = torch.rand(n, generator=noise, device=noise.device, dtype=torch.float32)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).to(device)
    g = torch.tensor(np.asarray(next(noise), np.float32), device=device)
    if g.shape != (n,):
        raise ValueError(f"replayed noise has shape {tuple(g.shape)}, want ({n},)")
    return g


def _topk_lowest_index(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest keys along the last axis, ties broken by the
    lowest index."""
    return torch.sort(keys, dim=-1, descending=True, stable=True).indices[..., :k]


def gumbel_topk_from_noise(
    gumbel: torch.Tensor, weights: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gumbel_topk_without_replacement`` with the noise already drawn
    (same shape as ``weights``; rows of a (B, N) batch sample apart)."""
    logw = torch.where(
        weights > 0, torch.log(weights), torch.full_like(weights, -float("inf"))
    )
    keys = logw + gumbel
    return _topk_lowest_index(keys, k), keys


def gumbel_topk_without_replacement(
    noise: NoiseSource, weights: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``k`` distinct indices ~ categorical(weights) without replacement.

    Returns (indices in decreasing perturbed-key order, the perturbed keys).
    Zero-weight entries get key -inf and are never chosen while at least
    ``k`` entries have positive weight.
    """
    return gumbel_topk_from_noise(
        draw_gumbel(noise, weights.shape[0], weights.device), weights, k
    )


def topk_indices(weights: torch.Tensor, k: int) -> torch.Tensor:
    """Deterministic alternative: the k highest-weight indices."""
    return _topk_lowest_index(weights, k)
