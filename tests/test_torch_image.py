"""The port's detector preprocessing (tstar_tpu_torch/kernels/image.py)
against the reference's (tstar_tpu/kernels/image.py), float32 on the CPU.

The interpolation matrices are the same numpy code (exact).  The resize is
two float32 matmuls of up to 384-term sums over [0, 255] pixels: the two
frameworks sum in different orders, so outputs agree to ~1e-4 absolute at
pixel scale, ~2e-6 after CLIP normalization (/255/std).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu.kernels import image as jimg
from tstar_tpu_torch.kernels import image as timg


@pytest.mark.parametrize("n_in,n_out", [(192, 192), (384, 192), (20, 64), (192, 768)])
def test_interp_matrix_identical(n_in, n_out):
    np.testing.assert_array_equal(timg._interp_matrix(n_in, n_out), jimg._interp_matrix(n_in, n_out))


def _frames(k=16, hw=(20, 40), seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(k, *hw, 3), dtype=np.uint8)


def test_bilinear_resize_and_normalize_match():
    fr = _frames()
    want = jimg.normalize_clip(jimg.bilinear_resize(jnp.asarray(fr), (48, 56)))
    got = timg.normalize_clip(timg.bilinear_resize(torch.from_numpy(fr), (48, 56)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_pack_grid_matches():
    cells = np.random.default_rng(1).random((16, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        timg.pack_grid(torch.from_numpy(cells), 4, 4).numpy(),
        np.asarray(jimg.pack_grid(jnp.asarray(cells), 4, 4)),
    )


def test_detector_grid_and_verify_batch_match():
    cache = _frames(k=40, seed=2)
    secs = np.array([0, 3, 5, 39, 7, 8, 11, 2, 13, 17, 19, 23, 29, 31, 37, 1], np.int32)
    want = jimg.build_detector_grid(jnp.asarray(cache), jnp.asarray(secs), (4, 4), 64, jnp.float32)
    got = timg.build_detector_grid(
        torch.from_numpy(cache), torch.from_numpy(secs), (4, 4), 64, torch.float32
    )
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    want = jimg.build_verify_batch(jnp.asarray(cache), jnp.asarray(secs[:8]), 64, jnp.float32)
    got = timg.build_verify_batch(
        torch.from_numpy(cache), torch.from_numpy(secs[:8]), 64, torch.float32
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
