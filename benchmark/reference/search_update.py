"""The T* search's distribution update, written from its description
(Ye et al. 2025, "Re-thinking Temporal Search for Long-Form Video
Understanding", and the reference's ``interface_searcher.py``).

After a step scores its K sampled seconds:
  * each sampled second takes its confidence and counts as visited;
  * the seconds whose confidence is in the step's top quartile
    (``np.percentile``, linear) spread it, in the order sampled, to the
    seconds within ``window`` of them with weight 1 / (|offset| + 1),
    keeping the larger value; a second's spread reads its score as the
    earlier spreads left it;
  * a smoothing spline is fitted to the visited seconds' scores: of
    ``lam`` = 10^e, e = -5 ... 5 in 145 even steps, the largest whose
    weighted residual sum((f - y)^2 over visited seconds) stays within
    ``smoothing`` (the smallest if none does), the fit minimising
    sum_visited (f - y)^2 + lam * sum (second differences of f)^2 over the
    video's seconds;
  * P = sigmoid(max(fit, 1 / N)) over the video's N seconds, normalised;
    uniform while fewer than two seconds are visited.

The spline's normal equations are pentadiagonal; they are solved here by a
plain LDL^T elimination, row by row, for every lam and step at once, in the
dtype asked for (float64 for the reference; the control asks for bfloat16).
Plain ``torch`` on the host.
"""

from __future__ import annotations

import numpy as np
import torch

LOG_LAM_LO, LOG_LAM_HI, SWEEP = -5.0, 5.0, 145


def splat(scores: np.ndarray, secs: np.ndarray, conf: np.ndarray, n_valid: int,
          window: int, top_percentile: float) -> np.ndarray:
    """One step's raw writes and windowed spread, sequentially (float64)."""
    out = np.array(scores, np.float64)
    out[secs] = conf
    thr = np.percentile(np.asarray(conf, np.float64), top_percentile)
    for s, c in zip(secs, conf):
        if c < thr:
            continue
        centre = out[s]
        for off in range(-window, window + 1):
            i = s + off
            if 0 <= i < n_valid:
                out[i] = max(out[i], centre / (abs(off) + 1.0))
    return out


def _second_difference_bands(n: int):
    """The three bands (main, first, second) of D^T D, D the (n-2, n)
    second-difference matrix with rows [1, -2, 1]."""
    d0, d1, d2 = np.zeros(n), np.zeros(n - 1), np.zeros(n - 2)
    r = np.arange(n - 2)
    np.add.at(d0, r, 1.0)
    np.add.at(d0, r + 1, 4.0)
    np.add.at(d0, r + 2, 1.0)
    np.add.at(d1, r, -2.0)
    np.add.at(d1, r + 1, -2.0)
    np.add.at(d2, r, 1.0)
    return d0, d1, d2


def _solve_pentadiagonal(a0, a1, a2, b):
    """Solve the symmetric systems with bands a0 (n, C), a1 (n-1, C), a2
    (n-2, C) for right-hand sides b (n, C), column by column, by LDL^T."""
    n = a0.shape[0]
    d = [None] * n
    l1 = [None] * (n - 1)
    l2 = [None] * (n - 2)
    d[0] = a0[0]
    l1[0] = a1[0] / d[0]
    d[1] = a0[1] - l1[0] * l1[0] * d[0]
    for i in range(2, n):
        l2[i - 2] = a2[i - 2] / d[i - 2]
        if i - 1 < n - 1:
            l1[i - 1] = (a1[i - 1] - l2[i - 2] * l1[i - 2] * d[i - 2]) / d[i - 1]
        d[i] = a0[i] - l1[i - 1] * l1[i - 1] * d[i - 1] - l2[i - 2] * l2[i - 2] * d[i - 2]
    z = [None] * n
    z[0] = b[0]
    z[1] = b[1] - l1[0] * z[0]
    for i in range(2, n):
        z[i] = b[i] - l1[i - 1] * z[i - 1] - l2[i - 2] * z[i - 2]
    x = [None] * n
    x[n - 1] = z[n - 1] / d[n - 1]
    x[n - 2] = z[n - 2] / d[n - 2] - l1[n - 2] * x[n - 1]
    for i in range(n - 3, -1, -1):
        x[i] = z[i] / d[i] - l1[i] * x[i + 1] - l2[i] * x[i + 2]
    return torch.stack(x)


def distribution(scores: np.ndarray, visited: np.ndarray, n_valid: int, smoothing: float,
                 dtype=torch.float64) -> np.ndarray:
    """-> (P (T, n_valid), log10 of each step's lam (T,)) for T steps'
    scores and visited masks (T, >= n_valid)."""
    n = n_valid
    y = torch.as_tensor(np.asarray(scores)[:, :n], dtype=torch.float64)
    w = torch.as_tensor(np.asarray(visited)[:, :n], dtype=torch.float64)
    steps = y.shape[0]
    lams = torch.pow(10.0, torch.linspace(LOG_LAM_LO, LOG_LAM_HI, SWEEP, dtype=torch.float64))
    p0, p1, p2 = (torch.as_tensor(b) for b in _second_difference_bands(n))
    cast = (lambda t: t.to(dtype))                                       # noqa: E731
    lam = cast(lams)[None, :]                                            # (1, L)
    wt = cast(w).T[:, :, None]                                           # (n, T, 1)
    yt = cast(y).T[:, :, None]
    a0 = (wt + lam * cast(p0)[:, None, None]).reshape(n, -1)
    a1 = (lam * cast(p1)[:, None, None]).expand(n - 1, steps, SWEEP).reshape(n - 1, -1)
    a2 = (lam * cast(p2)[:, None, None]).expand(n - 2, steps, SWEEP).reshape(n - 2, -1)
    b = (wt * yt).expand(n, steps, SWEEP).reshape(n, -1)
    fits = _solve_pentadiagonal(a0, a1, a2, b).reshape(n, steps, SWEEP)
    resid = (wt * (fits - yt) ** 2).sum(dim=0)                           # (T, L)
    ok = resid <= smoothing
    idx = torch.where(ok, torch.arange(SWEEP), torch.full_like(ok, -1, dtype=torch.long))
    idx = idx.amax(dim=1).clamp_min(0)
    fit = fits.permute(1, 2, 0)[torch.arange(steps), idx].double()      # (T, n)
    p = torch.sigmoid(torch.clamp_min(fit, 1.0 / n))
    p = p / p.sum(dim=1, keepdim=True)
    uniform = torch.full_like(p, 1.0 / n)
    p = torch.where(w.sum(dim=1, keepdim=True) < 2, uniform, p).numpy()
    return p, torch.log10(lams)[idx].numpy()
