"""The reference-architecture baseline (``bench/reference_style.py``)
against the reference's ``tstar_tpu.bench.reference_style`` on the CPU.

  * The host loop: every second's frame is one uniform colour, so cv2's
    resize and the port's host bilinear give the same cells exactly; a
    deterministic numpy stand-in for the detector reads each grid cell's
    colour back to its second and returns that second's row of a seeded
    detection table.  Both packages must send the same seconds to the
    detector in the same order (their numpy sampling, splat and scipy spline
    are the same code on the same numbers) and score the same frames.
  * The host grid: on random frames, the port's cells lie within one level
    of cv2's INTER_LINEAR (cv2 rounds through fixed point, the port once).
"""

import cv2
import numpy as np
import pytest
import torch

from tstar_tpu.bench.reference_style import reference_style_search as jref_style
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu_torch.bench.reference_style import host_grid, reference_style_search
from tstar_tpu_torch.kernels.image import CLIP_MEAN, CLIP_STD
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig

SIZE = 128          # detector input: a 4 x 4 grid of 32 x 32 cells
CONFIG = dict(search_budget=0.5)


def _colour_cache(n, hw=(16, 24)):
    """Frame s is one colour: (s % 256, s // 256, 77)."""
    s = np.arange(n)
    colours = np.stack([s % 256, s // 256, np.full(n, 77)], -1).astype(np.uint8)
    return np.broadcast_to(colours[:, None, None, :], (n, *hw, 3)).copy()


class FakeDetector:
    """Reads each cell's centre back to its second; returns one detection a
    cell, centred in it, with that second's score and class."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.score = (rng.random(n) ** 2).astype(np.float32)
        self.cls = rng.integers(0, 3, n)
        self.seen = []

    def __call__(self, pixels):
        px = np.asarray(pixels, np.float32)[0]
        levels = np.rint((px * CLIP_STD + CLIP_MEAN) * 255.0)
        cell = SIZE // 4
        centres = [(r * cell + cell // 2, c * cell + cell // 2) for r in range(4) for c in range(4)]
        secs = [int(levels[y, x, 0] + 256 * levels[y, x, 1]) for y, x in centres]
        self.seen.append(secs)
        boxes = np.array([[x - 4, y - 4, x + 4, y + 4] for y, x in centres], np.float32)
        return (self.score[secs][None], self.cls[secs][None], boxes[None])


@pytest.mark.parametrize("n_valid,seed", [(200, 0), (333, 5)])
def test_host_loop_matches_reference(n_valid, seed):
    cache = _colour_cache(n_valid)
    weights = np.array([1.0, 0.5, 0.5], np.float32)
    jdet, tdet = FakeDetector(n_valid, seed), FakeDetector(n_valid, seed)
    want, _ = jref_style(jdet, cache, n_valid, weights, 1, JSearchConfig(**CONFIG),
                         detector_size=SIZE, rng=np.random.default_rng(seed))

    def port_forward(pixels):
        assert isinstance(pixels, torch.Tensor) and pixels.shape == (1, SIZE, SIZE, 3)
        return tuple(torch.from_numpy(a) for a in tdet(pixels.numpy()))

    got, wall = reference_style_search(port_forward, cache, n_valid, weights, 1,
                                       TSearchConfig(**CONFIG), detector_size=SIZE,
                                       rng=np.random.default_rng(seed), device="cpu")
    assert got == want == len(jdet.seen) * 16 and wall > 0
    assert tdet.seen == jdet.seen
    assert tdet.seen[0] == list(np.arange(16) * (n_valid // 16))    # the stride
    assert len({s for grid in tdet.seen for s in grid}) > 16        # it sampled


@pytest.mark.parametrize("hw,size", [((16, 24), 128), ((96, 160), 128), ((45, 80), 192)])
def test_host_grid_within_one_level_of_cv2(hw, size):
    rng = np.random.default_rng(hw[0])
    cache = rng.integers(0, 256, (20, *hw, 3), dtype=np.uint8)
    secs = rng.permutation(20)[:16]
    cell = size // 4
    cells = [cv2.resize(cache[s], (cell, cell), interpolation=cv2.INTER_LINEAR) for s in secs]
    want = np.vstack([np.hstack(cells[r * 4:(r + 1) * 4]) for r in range(4)])
    got = host_grid(cache, secs, 4, 4, size)
    assert got.shape == want.shape == (size, size, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
