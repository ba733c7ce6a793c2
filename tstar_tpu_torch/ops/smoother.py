"""Residual-targeted smoothing of the per-second score distribution (port of
``tstar_tpu/ops/smoother.py``).

A weighted discrete smoothing spline (Whittaker-Eilers, second differences)

    minimize   sum_i w_i (f_i - y_i)^2  +  lam * sum_i (f_i - 2 f_{i+1} + f_{i+2})^2

with w_i = 1 on visited seconds, solved for a log-spaced sweep of ``lam`` at
once; the largest ``lam`` whose weighted residual stays within the target
``s`` wins (FITPACK's residual-targeting rule).  The normal equations are a
symmetric positive-definite pentadiagonal system, solved by 2x2 block
cyclic reduction: ~2*log2(N/2) levels of batched elementwise math, with no
host read anywhere.

Rounding.  At the large-lam end the system is badly conditioned (D^T D's
smallest eigenvalues are ~(pi/N)^4), so float32 rounding decides the fit to
~1e-2 and two correct solvers that round differently pick different frames.
The port therefore rounds as the reference's compiled float32 solve does:
every ``a*b + c`` of the elimination rounds ONCE, as a fused multiply-add
(``torch.addcmul``, one kernel that rounds once on the CPU and the GPU); the
lam values are float64 powers rounded to float32; and the log10(lam) grid is
float32 ``jnp.linspace`` as the reference's compiler folds it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

_LOG_LAM_LO, _LOG_LAM_HI, _SWEEP = -5.0, 5.0, 145  # resolution 10/144 decades
_LAM_CACHE: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _log_lam_grid() -> torch.Tensor:
    """float32 ``jnp.linspace(-5, 5, 145)`` as the reference's compiler
    evaluates it: ``lo * (1 - i * f32(1/div)) + i * f32(hi/div)``, each op
    rounded to float32, then ``hi``.  (97 of its 145 values differ from the
    correctly rounded grid by an ulp, which moves badly conditioned fits by
    up to ~0.3.)"""
    div = _SWEEP - 1
    i = torch.arange(div, dtype=torch.float32)
    inv, step = np.float32(1.0 / div), np.float32(_LOG_LAM_HI / div)
    out = _LOG_LAM_LO * (1.0 - i * float(inv)) + i * float(step)
    return torch.cat([out, torch.tensor([_LOG_LAM_HI], dtype=torch.float32)])


def _lam_sweep(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log10 lam grid, lam) on ``device``, float32; built once per device."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device not in _LAM_CACHE:
        grid = _log_lam_grid()
        lams = torch.pow(10.0, grid.double()).float()
        _LAM_CACHE[device] = (grid.to(device), lams.to(device))
    return _LAM_CACHE[device]


def _penta_diagonals(n_pad: int, n_valid, dtype, device) -> Tuple[torch.Tensor, ...]:
    """Diagonals of D^T D for the second-difference matrix on the valid prefix:
    (N_pad,) each for an int ``n_valid``, (B, N_pad) for a (B, 1) tensor."""
    i = torch.arange(n_pad, device=device)
    nv = n_valid
    d0 = (
        (i <= nv - 3).to(dtype)
        + 4.0 * ((i >= 1) & (i <= nv - 2)).to(dtype)
        + ((i >= 2) & (i <= nv - 1)).to(dtype)
    )
    zero = torch.zeros((), dtype=dtype, device=device)
    d1 = torch.where(
        (i == 0) | (i == nv - 2),
        torch.full_like(zero, -2.0),
        torch.where((i >= 1) & (i <= nv - 3), torch.full_like(zero, -4.0), zero),
    )
    d1 = torch.where(i <= nv - 2, d1, zero)
    d2 = (i <= nv - 3).to(dtype)
    return d0, d1, d2


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c rounded once (a fused multiply-add), broadcasting."""
    return torch.addcmul(c, a, b)


def _inv2x2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a batch of 2x2 matrices (..., 2, 2)."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    det = _fma(a, d, -(b * c))
    inv = torch.stack(
        [torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2
    )
    return inv / det[..., None, None]


def _mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched 2x2 @ 2x2: entry (i, j) = fma(x_i0, y_0j, x_i1 * y_1j)."""
    return _fma(x[..., :, 0:1], y[..., 0:1, :], x[..., :, 1:2] * y[..., 1:2, :])


def _mv(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched 2x2 @ 2-vector: entry i = fma(x_i0, v_0, x_i1 * v_1)."""
    return _fma(x[..., 0], v[..., 0:1], x[..., 1] * v[..., 1:2])


def _mt(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _penta_solve_cr(
    d0: torch.Tensor,  # (N, L) main diagonal
    d1: torch.Tensor,  # (N, L) first superdiagonal  (d1[i] = A[i, i+1])
    d2: torch.Tensor,  # (N, L) second superdiagonal (d2[i] = A[i, i+2])
    b: torch.Tensor,   # (N, L) right-hand side
) -> torch.Tensor:
    """Solve A x = b (symmetric pentadiagonal SPD, batched over L) by 2x2
    block cyclic reduction.

    Pairs ``(x_{2i}, x_{2i+1})`` form blocks; A is block-tridiagonal

        B^T_{i-1} x_{i-1} + C_i x_i + B_i x_{i+1} = rhs_i

    with C_i = [[d0_2i, d1_2i], [d1_2i, d0_2i+1]] and
    B_i = [[d2_2i, 0], [d1_2i+1, d2_2i+1]].  Each level eliminates the odd
    blocks; back-substitution walks the levels in reverse.  The block count
    pads to a power of two with identity blocks.
    """
    n, batch = b.shape
    if n % 2:
        raise ValueError("pentadiagonal CR needs an even (padded) length")
    m = n // 2
    dtype, device = b.dtype, b.device
    c_blk = torch.stack(
        [
            torch.stack([d0[0::2], d1[0::2]], dim=-1),
            torch.stack([d1[0::2], d0[1::2]], dim=-1),
        ],
        dim=-2,
    )                                                   # (m, L, 2, 2)
    zeros = torch.zeros_like(d2[0::2])
    b_blk = torch.stack(
        [
            torch.stack([d2[0::2], zeros], dim=-1),
            torch.stack([d1[1::2], d2[1::2]], dim=-1),
        ],
        dim=-2,
    )
    b_blk[-1] = 0.0                                     # last block has no successor
    rhs = torch.stack([b[0::2], b[1::2]], dim=-1)       # (m, L, 2)

    eye = torch.eye(2, dtype=dtype, device=device)
    m_pow = 1 << (m - 1).bit_length()
    if m_pow != m:
        c_blk = torch.cat([c_blk, eye.expand(m_pow - m, batch, 2, 2)], dim=0)
        b_blk = torch.cat(
            [b_blk, torch.zeros(m_pow - m, batch, 2, 2, dtype=dtype, device=device)]
        )
        rhs = torch.cat([rhs, torch.zeros(m_pow - m, batch, 2, dtype=dtype, device=device)])

    levels: List[Tuple[torch.Tensor, ...]] = []
    while c_blk.shape[0] > 1:
        c_odd_inv = _inv2x2(c_blk[1::2])
        b_even = b_blk[0::2]
        b_odd = b_blk[1::2]
        rhs_odd = rhs[1::2]
        # B_{i-1}, C^-1_{i-1}, r_{i-1} for even i: the odd arrays shifted down
        # one slot (identity / zero placeholders at i = 0).
        b_prev = torch.cat([torch.zeros_like(b_odd[:1]), b_odd[:-1]])
        c_prev_inv = torch.cat([eye.expand_as(c_odd_inv[:1]), c_odd_inv[:-1]])
        rhs_prev = torch.cat([torch.zeros_like(rhs_odd[:1]), rhs_odd[:-1]])

        left = _mm(_mt(b_prev), c_prev_inv)
        right = _mm(b_even, c_odd_inv)
        c_new = c_blk[0::2] - _mm(left, b_prev) - _mm(right, _mt(b_even))
        b_new = -_mm(right, b_odd)
        rhs_new = rhs[0::2] - _mv(left, rhs_prev) - _mv(right, rhs_odd)

        levels.append((c_odd_inv, rhs_odd, b_even, b_odd))
        c_blk, b_blk, rhs = c_new, b_new, rhs_new

    x = _mv(_inv2x2(c_blk), rhs)                        # (1, L, 2)
    for c_odd_inv, rhs_odd, b_even, b_odd in reversed(levels):
        x_next = torch.cat([x[1:], torch.zeros_like(x[:1])])
        x_odd = _mv(c_odd_inv, rhs_odd - _mv(_mt(b_even), x) - _mv(b_odd, x_next))
        x = torch.stack([x, x_odd], dim=1).reshape(-1, *x.shape[1:])

    x = x[:m]
    return x.permute(0, 2, 1).reshape(n, batch)


def _sweep(
    y: torch.Tensor,
    weights: torch.Tensor,
    pent: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    lams: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the smoother of each (B, N) row for each lam: (solutions
    (B, L, N), residuals (B, L)).  The B x L systems are one batched solve;
    each row's residual is summed on its own, as a single row's would be."""
    p0, p1, p2 = pent
    lams = lams.to(y.dtype)
    # Rows with zero weight AND zero curvature get identity equations.
    inactive = (weights == 0) & (p0 == 0)
    d0 = _fma(lams, p0[..., None], weights[..., None])            # (B, N, L)
    d0 = torch.where(inactive[..., None], torch.ones_like(d0), d0)
    d1 = lams * p1[..., None]
    d2 = lams * p2[..., None]
    b = (weights * y)[..., None] * torch.ones_like(lams)
    rows, n, n_lam = d0.shape

    def columns(t):                                                # (N, B*L)
        return t.permute(1, 0, 2).reshape(n, rows * n_lam)

    x = _penta_solve_cr(columns(d0), columns(d1), columns(d2), columns(b))
    x = x.reshape(n, rows, n_lam)
    resid = torch.stack([
        torch.sum(weights[r][:, None] * (x[:, r] - y[r][:, None]) ** 2, dim=0)
        for r in range(rows)
    ])
    return x.permute(1, 2, 0), resid


def fit_smoother(
    y: torch.Tensor,        # (N_pad,) or (B, N_pad) observed scores
    weights: torch.Tensor,  # same shape: 1.0 on visited-and-valid seconds
    n_valid,                # int, or (B,) tensor of lengths
    smoothing: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the residual-targeted smoother: (fitted, log10 lam), one fit per
    row of a (B, N_pad) batch."""
    if y.ndim == 1:
        fit, lam = fit_smoother(y[None], weights[None], n_valid, smoothing)
        return fit[0], lam[0]
    nv = n_valid[:, None] if isinstance(n_valid, torch.Tensor) else n_valid
    pent = tuple(
        p.expand_as(y) for p in _penta_diagonals(y.shape[-1], nv, y.dtype, y.device)
    )
    grid, lams = _lam_sweep(y.device)
    xs, resids = _sweep(y, weights, pent, lams)
    # Largest lam whose residual stays within the target; index 0 if none.
    ok = resids <= smoothing
    idx = torch.where(ok, torch.arange(grid.shape[0], device=y.device), -1).amax(dim=-1)
    idx = idx.clamp_min(0)
    fit = xs.gather(1, idx[:, None, None].expand(-1, 1, xs.shape[-1]))[:, 0]
    return fit, grid[idx]


def smoothing_spline_distribution(
    score_distribution: torch.Tensor,  # (N_pad,) or (B, N_pad)
    visited: torch.Tensor,             # same shape, bool
    valid: torch.Tensor,               # same shape, bool
    n_valid,                           # int, or (B,) tensor of lengths
    smoothing: float = 0.5,
) -> torch.Tensor:
    """smooth(visited scores) -> max(1/N, .) -> sigmoid -> normalize; uniform
    when fewer than 2 seconds are visited.  Rows of a batch are apart."""
    dtype = score_distribution.dtype
    w = (visited & valid).to(dtype)
    fitted, _ = fit_smoother(score_distribution, w, n_valid, smoothing=smoothing)

    if isinstance(n_valid, torch.Tensor):
        nv = n_valid.to(dtype)[:, None]
        floor = torch.div(torch.ones_like(nv), nv)       # float32 1/N, as below
    else:
        nv = float(np.float32(n_valid))
        floor = float(np.float32(1.0) / np.float32(n_valid))
    adjusted = torch.clamp_min(fitted, floor)
    p = torch.sigmoid(adjusted) * valid.to(dtype)
    p = p / torch.sum(p, dim=-1, keepdim=True)

    uniform = valid.to(dtype) / nv
    return torch.where(torch.sum(w, dim=-1, keepdim=True) < 2, uniform, p)
