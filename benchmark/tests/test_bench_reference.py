"""The plain references against the program's CPU path, at tiny sizes: the
detector and its per-cell confidences in float32, the prompt batch, and the
distribution update in float64 (where the program's solve is exact too)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import owlvit as ref
from benchmark.reference import search_update
from benchmark.reference.prompts import prompt_batch
from benchmark.weights import seeded_weights

CFG = {
    "projection_dim": 64,
    "vision_config": {"hidden_size": 128, "intermediate_size": 256, "num_attention_heads": 2,
                      "num_hidden_layers": 2, "image_size": 128, "patch_size": 32,
                      "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5},
    "text_config": {"vocab_size": 1000, "hidden_size": 64, "intermediate_size": 128,
                    "num_attention_heads": 2, "num_hidden_layers": 2,
                    "max_position_embeddings": 16, "hidden_act": "quick_gelu",
                    "layer_norm_eps": 1e-5},
}


def _program_detector(seed):
    from tstar_tpu_torch.models.owlvit import (OwlViTConfig, OwlViTDetector, TextConfig,
                                               VisionConfig)

    v, t = CFG["vision_config"], CFG["text_config"]
    model = OwlViTDetector(OwlViTConfig(
        vision=VisionConfig(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                            patch_size=32, image_size=128),
        text=TextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
                        intermediate_size=128, max_length=16),
        projection_dim=64))
    shapes = [(k, tuple(p.shape)) for k, p in model.state_dict().items()]
    weights = seeded_weights(shapes, seed, "cpu", torch.float32)
    model.load_state_dict(weights)
    assert v["hidden_size"] == 128 and t["hidden_size"] == 64
    return model.eval(), weights


def test_prompt_batch_is_the_programs():
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer
    from tstar_tpu_torch.search.detector_scorer import build_prompt_batch

    cfg = SearchConfig()
    ids, mask, weights = build_prompt_batch(["couch", "floor lamp"], ["tv"],
                                            HashTokenizer(49408, 16), cfg)
    r_ids, r_mask, r_qmask, r_weights = prompt_batch(["couch", "floor lamp"], ["tv"], 49408, 16,
                                                     cfg.max_objects, 1.0, 0.5)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(mask, r_mask)
    np.testing.assert_array_equal(weights, r_weights)
    np.testing.assert_array_equal(ids[:, 0] > 0, r_qmask)


@pytest.mark.parametrize("seed", [0, 1])
def test_detector_confidences_are_the_programs(seed):
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer
    from tstar_tpu_torch.search.detector_scorer import make_owlvit_scorer

    model, weights = _program_detector(seed)
    cfg = SearchConfig(cache_hw=(32, 64), detector_threshold=0.005)
    gen = torch.Generator().manual_seed(seed)
    cache = torch.randint(0, 256, (128, 32, 64, 3), generator=gen, dtype=torch.uint8)
    scorer = make_owlvit_scorer(model, cache, ["couch", "lamp"], ["tv"], HashTokenizer(1000, 16),
                                cfg)
    secs = torch.randperm(128, generator=gen)[:16]
    conf, _ = scorer.score_grid(secs)
    vconf, _ = scorer.score_verify(secs[:4])

    ids, mask, qmask, cw = prompt_batch(["couch", "lamp"], ["tv"], 1000, 16, cfg.max_objects,
                                        1.0, 0.5)
    queries = ref.text_queries(torch.as_tensor(ids), torch.as_tensor(mask), weights, CFG)
    canvas = ref.grid_canvas(cache[secs], 4, 4, 128)
    feats = ref.image_features(canvas, weights, CFG)
    logits, centres = ref.detect(feats, queries, torch.as_tensor(qmask), weights, 128, 32)
    lo, hi = ref.cell_confidence_bounds(logits, centres, torch.as_tensor(cw), 0.005, 4, 4, 128,
                                        0.0, 0.0)
    torch.testing.assert_close(lo, hi)
    torch.testing.assert_close(lo[0], conf.float(), atol=2e-5, rtol=0)
    images = ref.clip_normalise(ref.resize_bilinear(cache[secs[:4]], (128, 128)))
    logits, centres = ref.detect(ref.image_features(images, weights, CFG), queries,
                                 torch.as_tensor(qmask), weights, 128, 32)
    lo, _ = ref.cell_confidence_bounds(logits, centres, torch.as_tensor(cw), 0.005, 1, 1, 128,
                                       0.0, 0.0)
    torch.testing.assert_close(lo[:, 0], vconf.float(), atol=2e-5, rtol=0)
    # the tolerance widens the bounds around the exact confidence
    lo2, hi2 = ref.cell_confidence_bounds(logits, centres, torch.as_tensor(cw), 0.005, 1, 1,
                                          128, 0.05, 4.0)
    assert bool((lo2 <= lo).all()) and bool((hi2 >= lo).all())


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = (ref.fp8_e4m3(x) - x).abs().max()
    e16 = (x.bfloat16().float() - x).abs().max()
    assert e8 > 4 * e16 and e8 < 0.1 * x.abs().max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_is_the_programs_in_float64(seed):
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.search.engine import apply_grid_scores

    cfg = SearchConfig()
    n, n_pad = 600, 640
    rng = np.random.default_rng(seed)
    scores = np.full(n_pad, cfg.score_init)
    scores[n:] = 0
    visited = np.arange(n_pad) >= n
    for _ in range(6):
        secs = rng.choice(n, 16, replace=False)
        conf = rng.random(16) * 0.6 + 0.3
        s, v, p = apply_grid_scores(
            torch.tensor(scores)[None], torch.tensor(visited)[None],
            (torch.arange(n_pad) < n)[None], torch.tensor([n]), torch.tensor(secs)[None],
            torch.tensor(conf)[None], cfg)
        want_s = search_update.splat(scores[:n], secs, conf, n, cfg.window_size,
                                     cfg.top_percentile)
        vis = visited[:n].copy()
        vis[secs] = True
        want_p, _ = search_update.distribution(want_s[None], vis[None], n, cfg.spline_smoothing)
        np.testing.assert_allclose(s[0, :n].numpy(), want_s, rtol=0, atol=1e-12)
        np.testing.assert_allclose(p[0, :n].numpy(), want_p[0], rtol=1e-6, atol=0)
        scores, visited = s[0].numpy(), v[0].numpy()
