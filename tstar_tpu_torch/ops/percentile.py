"""Masked percentile with NumPy 'linear' interpolation (port of
``tstar_tpu/ops/percentile.py``): the percentile of the valid prefix of a
padded vector, by an explicit sort."""

from __future__ import annotations

import torch


def masked_percentile(x: torch.Tensor, q: float, valid: torch.Tensor) -> torch.Tensor:
    """Percentile of ``x[valid]`` along the last axis matching
    ``np.percentile(x, q)``: a 0-d tensor for a vector, (B,) for (B, N) rows.

    Runs on the device with no host read: invalid entries sort to the end as
    +inf and the interpolation position comes from the valid count.
    """
    sorted_x = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf")))).values
    n = valid.sum(dim=-1)
    pos = (n - 1).to(x.dtype) * (q / 100.0)
    last = x.shape[-1] - 1
    lo = torch.floor(pos).to(torch.int64).clamp(0, last)
    hi = torch.ceil(pos).to(torch.int64).clamp(0, last)
    frac = pos - lo.to(x.dtype)

    def at(i):
        return sorted_x.gather(-1, i.unsqueeze(-1)).squeeze(-1)

    return at(lo) * (1.0 - frac) + at(hi) * frac
