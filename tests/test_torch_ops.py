"""The port's search ops (tstar_tpu_torch/ops) against the reference's
(tstar_tpu/ops) on the same numpy inputs, float32 on the CPU.

Index outputs (sampling, top-k) must be equal.  Element-wise float outputs
differ only by operation order and libm: 1e-6 relative.

The smoother solves lam*D^T D + W, which is badly conditioned where few
seconds are visited (D^T D's smallest eigenvalues are ~(pi/N)^4), so float32
rounding decides its fit to ~1e-2.  The port rounds its multiply-adds as the
reference's compiled solve does (fused, once) and sweeps the reference's lam
grid bit for bit, so both land within ~4e-4 on the fit (5e-4 asserted),
~7e-5 relative on the distribution (1e-3 asserted), and pick the same lam.
The cyclic-reduction solve is compared against the reference jitted (its
compiler fuses the multiply-adds only under jit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu.ops import percentile as jpct
from tstar_tpu.ops import sampling as jsamp
from tstar_tpu.ops import smoother as jsm
from tstar_tpu.ops import splat as jsplat
from tstar_tpu_torch.ops import percentile as tpct
from tstar_tpu_torch.ops import sampling as tsamp
from tstar_tpu_torch.ops import smoother as tsm
from tstar_tpu_torch.ops import splat as tsplat


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_uniform_stride_matches():
    for n, k in [(600, 16), (17, 16), (1000, 8)]:
        np.testing.assert_array_equal(
            tsamp.uniform_stride_indices(n, k).numpy(),
            np.asarray(jsamp.uniform_stride_indices(n, k)),
        )


def test_gumbel_topk_with_replayed_noise_matches():
    rng = np.random.default_rng(0)
    w = rng.random(256).astype(np.float32)
    w[rng.random(256) < 0.3] = 0.0               # zero-weight entries
    key = jax.random.key(7)
    want_idx, want_keys = jsamp.gumbel_topk_without_replacement(key, jnp.asarray(w), 16)
    noise = iter([np.asarray(jax.random.gumbel(key, (256,), jnp.float32))])
    got_idx, got_keys = tsamp.gumbel_topk_without_replacement(noise, _t(w), 16)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_keys.numpy(), np.asarray(want_keys), rtol=1e-6)


def test_topk_ties_break_by_lowest_index():
    """Unvisited seconds all carry score_init: ties are the common case."""
    w = np.full(128, 1e-6, np.float32)
    w[[5, 90]] = 0.5
    want = np.asarray(jsamp.topk_indices(jnp.asarray(w), 8))
    got = tsamp.topk_indices(_t(w), 8).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [5, 90, 0, 1, 2, 3, 4, 6])


def test_generator_sampler_matches_sequential_choice_distribution():
    """Gumbel-top-k from a torch.Generator draws like np.random.choice
    without replacement: first-draw frequencies match p within 4 sigma."""
    p = np.array([0.5, 0.25, 0.15, 0.1], np.float32)
    gen = torch.Generator().manual_seed(0)
    n = 4000
    counts = np.zeros(4)
    for _ in range(n):
        idx, _ = tsamp.gumbel_topk_without_replacement(gen, _t(p), 2)
        counts[idx[0].item()] += 1
    sigma = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(counts / n - p) < 4 * sigma)


@pytest.mark.parametrize("n_valid", [1, 7, 100, 128])
def test_masked_percentile_matches(n_valid):
    rng = np.random.default_rng(n_valid)
    x = rng.random(128).astype(np.float32)
    valid = np.arange(128) < n_valid
    want = jpct.masked_percentile(jnp.asarray(x), 75.0, jnp.asarray(valid))
    got = tpct.masked_percentile(_t(x), 75.0, _t(valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_window_splat_matches_reference_recurrence():
    rng = np.random.default_rng(1)
    n_pad, n_valid = 256, 230
    scores = (rng.random(n_pad) * 0.2).astype(np.float32)
    # clustered seconds: splats overlap and raise each other's centers
    secs = np.array([3, 5, 8, 9, 100, 104, 226, 229, 50, 52, 54, 56, 180, 0, 1, 2])
    scores[secs] = rng.random(16).astype(np.float32)
    is_top = rng.random(16) < 0.5
    want = jsplat.window_splat(
        jnp.asarray(scores), jnp.asarray(secs), jnp.asarray(is_top), jnp.asarray(n_valid), 5
    )
    got = tsplat.window_splat(_t(scores), _t(secs), _t(is_top), n_valid, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_splat_detections_to_cells_matches():
    rng = np.random.default_rng(2)
    q, c = 64, 16
    xy = rng.random((q, 2)) * 700
    boxes = np.concatenate([xy, xy + rng.random((q, 2)) * 90], 1).astype(np.float32)
    scores = rng.random(q).astype(np.float32)
    cls = rng.integers(0, c, q).astype(np.int32)
    keep = scores > 0.3
    weights = np.where(np.arange(c) < 2, 1.0, 0.5).astype(np.float32)
    want = jsplat.splat_detections_to_cells(
        *map(jnp.asarray, (boxes, scores, cls, keep, weights)),
        grid_shape=(4, 4), image_hw=(768, 768), num_classes=c,
    )
    got = tsplat.splat_detections_to_cells(
        *map(_t, (boxes, scores, cls, keep, weights)),
        grid_shape=(4, 4), image_hw=(768, 768), num_classes=c,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_penta_solve_cr_matches():
    rng = np.random.default_rng(3)
    n, lam = 200, 4
    p0, p1, p2 = (np.asarray(a) for a in jsm._penta_diagonals(n, jnp.asarray(190), jnp.float32))
    w = (rng.random(n) < 0.3).astype(np.float32)
    lams = np.array([1e-2, 1.0, 10.0, 1e3], np.float32)
    d0 = w[:, None] + lams * p0[:, None]
    d0 = np.where(((w == 0) & (p0 == 0))[:, None], 1.0, d0).astype(np.float32)
    d1 = (lams * p1[:, None]).astype(np.float32)
    d2 = (lams * p2[:, None]).astype(np.float32)
    b = (rng.random((n, lam)) * w[:, None]).astype(np.float32)
    want = jax.jit(jsm._penta_solve_cr)(*map(jnp.asarray, (d0, d1, d2, b)))
    got = tsm._penta_solve_cr(*map(_t, (d0, d1, d2, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_penta_diagonals_and_lam_grid_match():
    for n_valid in (3, 100, 640):
        for want, got in zip(
            jsm._penta_diagonals(640, jnp.asarray(n_valid), jnp.float32),
            tsm._penta_diagonals(640, n_valid, torch.float32, None),
        ):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # bit-equal to the grid the reference's jitted fit_smoother sweeps
    np.testing.assert_array_equal(
        tsm._log_lam_grid().numpy(),
        np.asarray(jax.jit(lambda: jnp.linspace(jsm._LOG_LAM_LO, jsm._LOG_LAM_HI, jsm._SWEEP))()),
    )


def test_fma_rounds_once():
    """The solver's a*b + c is one fused multiply-add (torch.addcmul): equal
    to the product and sum taken exactly in float64 and rounded once, where
    the unfused float32 a*b + c differs on a large share of inputs."""
    g = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(4096, 2, 2, generator=g) for _ in range(3))
    exact = (a.double() * b.double() + c.double()).float()
    np.testing.assert_array_equal(tsm._fma(a, b, c).numpy(), exact.numpy())
    np.testing.assert_array_equal(
        tsm._fma(a[:, :, 0:1], b[:, 0:1, :], c).numpy(),
        (a[:, :, 0:1].double() * b[:, 0:1, :].double() + c.double()).float().numpy(),
    )
    assert (a * b + c != exact).any()


@pytest.mark.parametrize("n_visit", [0, 1, 24, 120])
def test_smoothing_spline_distribution_matches(n_visit):
    rng = np.random.default_rng(4 + n_visit)
    n_pad, n_valid = 256, 241
    scores = np.zeros(n_pad, np.float32)
    scores[:n_valid] = 1e-6
    visited = np.ones(n_pad, bool)
    visited[:n_valid] = False
    secs = rng.choice(n_valid, n_visit, replace=False)
    visited[secs] = True
    scores[secs] = rng.random(n_visit).astype(np.float32)
    valid = np.arange(n_pad) < n_valid
    want = jsm.smoothing_spline_distribution(
        jnp.asarray(scores), jnp.asarray(visited), jnp.asarray(valid), jnp.asarray(n_valid)
    )
    got = tsm.smoothing_spline_distribution(_t(scores), _t(visited), _t(valid), n_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-7)
    if n_visit < 2:
        return  # the distribution is uniform; the fit has no data to match
    w = jnp.asarray((visited & valid).astype(np.float32))
    want_fit, want_lam = jsm.fit_smoother(jnp.asarray(scores), w, jnp.asarray(n_valid))
    got_fit, got_lam = tsm.fit_smoother(_t(scores), _t(np.asarray(w)), n_valid)
    np.testing.assert_allclose(got_lam.item(), float(want_lam), atol=1e-6)
    np.testing.assert_allclose(got_fit.numpy(), np.asarray(want_fit), atol=5e-4)
