"""The graph-stepped search drivers on the card: a search stepped through
CUDA graphs gives the eager search's results exactly, for one video and for
a batch of three and over two length buckets prefetched on a side stream;
the step's phases synchronize nothing; a phase that cannot be captured
raises.  Every test here needs a CUDA device and skips without
one.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

The detector is a tiny OWL-ViT (2 layers, 32 wide, 64^2 images, f32) with
seeded random weights over synthetic 300 s videos, so the tests take
seconds; ``chip_smoke.py`` phase 8 runs the same checks at full width.
"""

import dataclasses

import pytest
import torch

from tstar_tpu_torch.framework.heuristics import initialize_heuristic
from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.parallel.multi_video import VideoTask, search_videos
from tstar_tpu_torch.search.engine import run_search
from tstar_tpu_torch.search.state import init_state
from tstar_tpu_torch.search.step_graphs import GraphCaptureError, Stepper, StepStats
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


@pytest.fixture
def heur():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.float32,
                                model_config=tiny(), seed=1)


def _single(heur, graphs, seed=0, scorer_wrap=None):
    cache = build_frame_cache("mem://v", CFG, device="cuda", decoder=scene_variant(1, 300.0))
    scorer = heur.build_scorer(cache.frames, TARGETS, CUES, CFG)
    if scorer_wrap is not None:
        scorer = scorer_wrap(scorer)
    state = init_state(cache.n_valid, 2, CFG, torch.Generator(device="cuda").manual_seed(seed),
                       n_pad=cache.n_pad, device="cuda")
    stats = StepStats(record=True)
    final, secs = run_search(state, scorer, CFG, graphs=graphs, stats=stats)
    return final, secs.tolist(), stats


def _seconds(stats, i=0):
    return [e["secs"][i].tolist() for e in stats.trace if e["active"][i]]


@pytest.mark.cuda
def test_single_video_graphs_equal_eager(heur):
    reset_launch_counts()
    g_final, g_secs, g = _single(heur, True)
    counts = launch_counts()
    e_final, e_secs, e = _single(heur, False)
    assert g.steps >= 3 and g.replays > 0 and g.captures >= 2 and e.replays == 0
    assert g.host_reads == 2 * g.steps and e.host_reads == 2 * e.steps
    assert _seconds(g) == _seconds(e) and g_secs == e_secs
    assert g_final.iteration == e_final.iteration
    assert torch.equal(g_final.remaining, e_final.remaining)
    assert torch.equal(g_final.scores, e_final.scores)
    # replays count their captured launches: K2 once a forward
    assert counts["patch_embed_matmul"] == g.steps + len(g.verify_widths)


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [{}, {"verify_flat": False}, {"verify_batch": None}])
def test_batch_of_three_graphs_equal_eager(heur, overrides):
    """Global-flat verification rounds, per-video rounds, and one wide
    rescore of every sampled frame: each its own captured phase."""
    cfg = dataclasses.replace(CFG, **overrides)
    out = {}
    for graphs in (True, False):
        tasks = [VideoTask(f"mem://{i}", TARGETS, CUES, seed=i,
                           decoder=scene_variant(i, 300.0)) for i in range(3)]
        stats = StepStats(record=True)
        out[graphs] = (search_videos(tasks, heur, cfg, graphs=graphs, stats=stats), stats)
    (rg, g), (re, e) = out[True], out[False]
    assert g.replays > 0 and e.replays == 0 and g.host_reads == 2 * g.steps
    assert g.verify_widths == e.verify_widths and g.verify_widths
    for i in range(3):
        assert _seconds(g, i) == _seconds(e, i)
        for key in ("keyframe_secs", "iterations", "remaining_targets", "keyframe_distribution"):
            assert rg[i][key] == re[i][key], (i, key)


@pytest.mark.cuda
def test_two_buckets_prefetched_graphs_equal_eager(heur):
    """Two length buckets (300 s and 200 s videos): the second bucket's
    caches decode and upload from pinned memory on the side stream while
    the first searches (and captures its graphs); both forms agree."""
    out = {}
    for graphs in (True, False):
        tasks = [VideoTask(f"mem://{i}", TARGETS, CUES, seed=i,
                           decoder=scene_variant(i, 300.0 if i % 2 else 200.0))
                 for i in range(4)]
        out[graphs] = search_videos(tasks, heur, CFG, graphs=graphs, decode_workers=2)
    for g, e in zip(out[True], out[False]):
        for key in ("keyframe_secs", "iterations", "remaining_targets", "keyframe_distribution"):
            assert g[key] == e[key], key


@pytest.mark.cuda
def test_step_phases_do_not_synchronize(heur):
    """An eager grid step (at iteration 0 and then sampling), its
    verification round and wide rescore, and the commit raise nothing under
    ``set_sync_debug_mode("error")``; only the driver's reads synchronize."""
    cache = build_frame_cache("mem://v", CFG, device="cuda", decoder=scene_variant(2, 300.0))
    scorer = heur.build_scorer(cache.frames, TARGETS, CUES, CFG)
    state = init_state(cache.n_valid, 2, CFG, torch.Generator(device="cuda").manual_seed(0),
                       n_pad=cache.n_pad, device="cuda")
    with torch.no_grad():
        for checked in (False, True):     # the first pass builds the per-device constants
            stepper = Stepper.single(state, scorer, CFG, graphs=False)
            torch.cuda.synchronize()
            for it in range(2):
                torch.cuda.set_sync_debug_mode("error" if checked else "default")
                try:
                    stepper._phase_a(stepper.iteration == 0 if it == 0 else None, [it > 0])
                    stepper._phase_round()
                    stepper._phase_wide()
                    stepper._phase_c()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        torch.cuda.set_sync_debug_mode("error")
        try:
            stepper.n_cand.item()
        finally:
            torch.cuda.set_sync_debug_mode("default")


@dataclasses.dataclass
class _Syncing:
    """A scorer whose grid forward reads the device: it runs eagerly, and
    cannot be captured."""

    inner: object

    def score_grid(self, secs):
        conf, presence = self.inner.score_grid(secs)
        conf = conf + 0.0 * conf.sum().item()
        return conf, presence

    def score_verify(self, secs):
        return self.inner.score_verify(secs)


@pytest.mark.cuda
def test_capture_failure_raises(heur):
    """The step's first use runs eagerly; its capture fails on the read and
    raises: the driver never falls back to eager steps."""
    with pytest.raises(GraphCaptureError, match="phase 'a'"):
        _single(heur, True, scorer_wrap=_Syncing)
    final, _, stats = _single(heur, False, scorer_wrap=_Syncing)
    assert stats.steps >= 3 and stats.replays == 0
    # the failed capture left no generator in capture mode
    assert torch.isfinite(torch.randn(4, device="cuda")).all()
