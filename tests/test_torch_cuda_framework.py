"""The history driver and the pipeline on the card: a history search steps
through the same CUDA graphs as ``search()`` and returns its keyframes, with
two host reads a step and one capture per phase per run; the batched history
likewise; ``TStarFramework.run()`` on the card returns the CPU's result.
Every test here needs a CUDA device and skips without one.  This file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_framework.py

The detector is a tiny OWL-ViT (2 layers, 32 wide, 64^2 images, f32, TF32
off) with seeded random weights over synthetic 300 s videos;
``chip_smoke.py`` phase 11 runs the pipeline at full width.
"""

import pytest
import torch

from tstar_tpu_torch.framework.framework import TStarFramework
from tstar_tpu_torch.framework.heuristics import initialize_heuristic
from tstar_tpu_torch.grounding.fake import FakeGrounder
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.parallel.multi_video import VideoTask, search_videos
from tstar_tpu_torch.search.engine import run_search, run_search_with_history
from tstar_tpu_torch.search.searcher import KeyframeSearcher
from tstar_tpu_torch.search.snapshot import load_state, save_state
from tstar_tpu_torch.search.state import init_state
from tstar_tpu_torch.search.step_graphs import StepStats
from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.video.cache import build_frame_cache
from tstar_tpu_torch.video.synthetic import scene_variant

CFG = SearchConfig(search_budget=0.5, cache_hw=(32, 64))
TARGETS, CUES = ["couch", "lamp"], ["tv"]


def tiny():
    v = tow.VisionConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                         patch_size=16, image_size=64)
    t = tow.TextConfig(vocab_size=100, hidden_size=24, num_layers=2, num_heads=4,
                       intermediate_size=48, max_length=8)
    return tow.OwlViTConfig(vision=v, text=t, projection_dim=24)


def _heur(device):
    return initialize_heuristic("owl-vit-random", device=device, dtype=torch.float32,
                                model_config=tiny(), seed=1)


@pytest.fixture
def heur():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return _heur("cuda")


def _state(cache, seed=0):
    return init_state(cache.n_valid, 2, CFG, torch.Generator(device="cuda").manual_seed(seed),
                      n_pad=cache.n_pad, device="cuda")


@pytest.mark.cuda
def test_snapshot_generator_round_trips_on_the_card(tmp_path):
    """A card search's snapshot holds a CUDA generator's state: ``load_state``
    (default device "cuda") puts the state and a CUDA generator in that
    state back on the card, and its next draws are the saved generator's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = torch.Generator(device="cuda").manual_seed(7)
    torch.rand(100, generator=rng, device="cuda")
    state = init_state(200, 1, CFG, rng, n_pad=256, device="cuda")
    loaded = load_state(save_state(state, str(tmp_path / "card.npz")))
    assert loaded.rng.device.type == "cuda" and loaded.P.device.type == "cuda"
    assert torch.equal(torch.rand(64, generator=loaded.rng, device="cuda"),
                       torch.rand(64, generator=rng, device="cuda"))


@pytest.mark.cuda
def test_history_keyframes_equal_search_with_graphs(heur):
    cache = build_frame_cache("mem://v", CFG, device="cuda", decoder=scene_variant(1, 300.0))
    scorer = heur.build_scorer(cache.frames, TARGETS, CUES, CFG)
    plain, hist = StepStats(record=True), StepStats(record=True)
    final, secs = run_search(_state(cache), scorer, CFG, graphs=True, stats=plain)
    h_final, h_secs, history = run_search_with_history(_state(cache), scorer, CFG, graphs=True,
                                                       stats=hist)
    assert h_secs.tolist() == secs.tolist()
    assert h_final.iteration == final.iteration == len(history) == hist.steps >= 3
    assert torch.equal(h_final.scores, final.scores)
    assert [e["secs"][0].tolist() for e in plain.trace] == [h["secs"].tolist() for h in history]
    assert [e["conf"][0].tolist() for e in plain.trace] == [h["conf"].tolist() for h in history]
    # two host reads a step, graphs replayed, one capture per phase per run
    assert hist.host_reads == 2 * hist.steps and hist.replays > 0
    assert hist.captures == plain.captures <= 4
    assert "detections" in history[0] and history[0]["detections"]["valid"].any()
    torch.testing.assert_close(torch.from_numpy(history[-1]["P"]), final.P.cpu())


@pytest.mark.cuda
def test_searcher_visualization_equals_search(heur):
    runs = []
    for visual in (False, True):
        s = KeyframeSearcher("mem://v", heur, TARGETS, CUES, config=CFG, seed=3,
                             decoder=scene_variant(2, 300.0))
        _, stamps = s.search_with_visualization() if visual else s.search()
        runs.append((stamps, s))
    (stamps, plain), (v_stamps, visual) = runs
    assert v_stamps == stamps
    st = visual.step_stats
    assert len(visual.P_history) == st.steps and st.host_reads == 2 * st.steps
    assert st.captures == plain.step_stats.captures


@pytest.mark.cuda
def test_batched_history_equals_plain_with_graphs(heur):
    def tasks():
        return [VideoTask(f"mem://v{i}", TARGETS, CUES, seed=i, decoder=scene_variant(i, 300.0))
                for i in range(3)]

    plain_stats, hist_stats = StepStats(), StepStats()
    plain = search_videos(tasks(), heur, CFG, graphs=True, stats=plain_stats)
    hist = search_videos(tasks(), heur, CFG, graphs=True, stats=hist_stats, collect_history=True)
    for p, h in zip(plain, hist):
        assert h["keyframe_secs"] == p["keyframe_secs"] and h["iterations"] == p["iterations"]
        assert len(h["sampled_history"]) == len(h["P_history"]) == h["iterations"]
    assert hist_stats.host_reads == 2 * hist_stats.steps and hist_stats.replays > 0
    assert hist_stats.captures == plain_stats.captures


@pytest.mark.cuda
def test_framework_run_card_equals_cpu(heur, tmp_path, monkeypatch):
    """The fake grounder and the tiny detector in f32: ``run()`` on the card
    returns the CPU's grounding objects, timestamps and answer, with the
    four stages timed.  A CUDA generator draws other numbers than a CPU one
    from the same seed, so both searches replay noise drawn on the CPU (and
    step eagerly: a replayed source is no generator a graph can register)."""
    from tstar_tpu_torch.ops.sampling import draw_gumbel
    from tstar_tpu_torch.search import searcher as tsearcher

    g = torch.Generator().manual_seed(4)
    noise = [draw_gumbel(g, CFG.padded_frames(300), "cpu").numpy() for _ in range(12)]
    real_init, real_history = tsearcher.init_state, tsearcher.run_search_with_history
    monkeypatch.setattr(tsearcher, "init_state",
                        lambda *a, **k: real_init(*a, **k).replace(rng=iter(noise)))
    monkeypatch.setattr(tsearcher, "run_search_with_history",
                        lambda st, sc, c, graphs=None, stats=None: real_history(st, sc, c, False,
                                                                                 stats))
    out = {}
    for device in ("cuda", "cpu"):
        fw = TStarFramework("mem://v", _heur(device), FakeGrounder(["couch", "lamp"], ["tv"]),
                            "Where is the couch?", "A) x\nB) y", search_budget=0.5,
                            config=SearchConfig(cache_hw=(32, 64)), output_dir=str(tmp_path),
                            save_artifacts=False, decoder=scene_variant(0, 300.0),
                            device=device)
        out[device] = fw.run()
        assert set(fw.results["Timings"]) == {"grounding", "decode_and_setup", "search", "qa"}
        assert fw.video_searcher.step_stats.steps >= 3
    assert out["cuda"] == out["cpu"]
