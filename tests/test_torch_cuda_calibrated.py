"""The calibrated detector and the Qwen2.5-VL tower on the card.  Every test
here needs a CUDA device and skips without one; this file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_calibrated.py

A calibrated search steps through CUDA graphs that read the calibrated
queries (``build_scorer`` replaces the scorer's query tensors; graphs are
captured per run, so nothing keys on the base scorer's): its detector is
the knob A/B's lottery winner, a working one, and the search replays its
graphs over several steps; the knob A/B's int8 tower plans its matmuls,
whose shapes K4 does not take, in plain tensor ops on the card; the
Qwen2.5-VL tower in f32 on the card equals the CPU's.  ``chip_smoke.py``
phase 13 runs all of it at full width.
"""

import dataclasses

import pytest
import torch

from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
from tstar_tpu_torch.models.owlvit_quant import route_counts
from tstar_tpu_torch.models.qwen25_vision import Qwen25VisionConfig, Qwen25VisionTower
from tstar_tpu_torch.models.qwen2vl import init_random_
from tstar_tpu_torch.search.searcher import KeyframeSearcher
from tstar_tpu_torch.tools import ab_knob_recall
from tstar_tpu_torch.utils.config import SearchConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def lottery():
    """The knob A/B's seed lottery on the card (it refuses a best smaller
    margin of 0.02 or less) -> (calibrated heuristic, its seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    heur, seed, _ = ab_knob_recall.pick_calibrated_heuristic(
        SearchConfig(search_budget=1.0), 32, torch.device("cuda"))
    return heur, seed


def _searcher(heur, cfg, seed=0):
    make_decoder, _ = ab_knob_recall.make_scenes(1)[0]
    return KeyframeSearcher("mem://scene", heur, ["couch"], [], config=cfg, seed=seed,
                            search_budget=cfg.search_budget,
                            confidence_threshold=cfg.confidence_threshold, decoder=make_decoder())


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8"])
def test_calibrated_search_graphs_equal_eager(cuda, lottery, quant):
    heur, _ = lottery
    base = SearchConfig(search_budget=1.0)
    cfg = dataclasses.replace(base, detector_quant=quant,
                              detector_threshold=heur.suggested_detector_threshold,
                              confidence_threshold=heur.suggested_confidence_threshold)
    s = _searcher(heur, cfg)
    assert bool(s.scorer.query_mask[0]) and not bool(s.scorer.query_mask[1:].any())
    reset_launch_counts()
    _, graphed = s.search()
    counts = launch_counts()
    assert int(s._final_state.iteration) > 1
    assert s.step_stats.replays > 0            # graph replays read the calibrated queries
    _, eager = _searcher(heur, cfg).search(graphs=False)
    assert graphed == eager
    assert counts["w8a8_matmul"] == 0          # K = 64: the plan's plain int8 math
    if quant == "int8":
        assert route_counts(s.scorer.qvision) == {"plain": 12}


@pytest.mark.cuda
def test_qwen25_tower_card_equals_cpu(cuda):
    cfg = Qwen25VisionConfig(depth=3, embed_dim=32, num_heads=2, intermediate_size=64,
                             patch_size=2, temporal_patch_size=1, hidden_size=48, window_size=8,
                             fullatt_block_indexes=(1,))
    tower = init_random_(Qwen25VisionTower(cfg), torch.Generator().manual_seed(0)).eval()
    patches = torch.randn(2, 60, cfg.patch_dim, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = tower(patches, (6, 10))
        got = tower.to(cuda)(patches.to(cuda), (6, 10)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
