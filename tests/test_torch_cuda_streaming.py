"""The streaming search and the reference-fidelity verification on the card:
stepped through CUDA graphs they give the eager runs' results exactly, and
the streaming search gives the resident one's; each step copies the decoded
frames of its sampled seconds into the scorer's static step buffer.  Every
test here needs a CUDA device and skips without one.  This file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_streaming.py

The detector is a tiny OWL-ViT (2 layers, 32 wide, 64^2 images, f32) with
seeded random weights over synthetic 300 s videos served from memory, so
the tests take seconds; ``chip_smoke.py`` phase 12 runs the same checks at
full width.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tstar_tpu_torch.framework.heuristics import initialize_heuristic
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.search import reference_verify as trv
from tstar_tpu_torch.search.engine import run_search, run_search_streaming
from tstar_tpu_torch.search.state import init_state
from tstar_tpu_torch.search.step_graphs import Stepper, StepStats
from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.video.cache import StreamingFrameCache, build_frame_cache
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


def _search(heur, mode, graphs, seed=0):
    cfg = dataclasses.replace(CFG, cache_mode=mode)
    cache = build_frame_cache("mem://v", cfg, device="cuda", decoder=scene_variant(1, 300.0))
    scorer = heur.build_scorer(cache.frames, TARGETS, CUES, cfg)
    state = init_state(cache.n_valid, 2, cfg, torch.Generator(device="cuda").manual_seed(seed),
                       n_pad=cache.n_pad, device="cuda")
    stats = StepStats(record=True)
    if isinstance(cache, StreamingFrameCache):
        final, secs = run_search_streaming(state, scorer, cache, cfg, graphs=graphs, stats=stats)
    else:
        final, secs = run_search(state, scorer, cfg, graphs=graphs, stats=stats)
    return final, secs.cpu(), [t["secs"][0].cpu() for t in stats.trace], stats


@pytest.mark.cuda
def test_graphed_streaming_equals_eager_and_resident(heur):
    g_final, g_secs, g_trace, g_stats = _search(heur, "streaming", None)
    e_final, e_secs, e_trace, e_stats = _search(heur, "streaming", False)
    r_final, r_secs, r_trace, _ = _search(heur, "resident", None)
    assert g_stats.replays > 0 and g_stats.captures >= 3 and e_stats.replays == 0
    assert g_stats.host_reads == 3 * g_stats.steps and e_stats.host_reads == 3 * e_stats.steps
    for other_secs, other_trace, other in ((e_secs, e_trace, e_final), (r_secs, r_trace, r_final)):
        assert torch.equal(g_secs, other_secs)
        assert len(g_trace) == len(other_trace)
        assert all(torch.equal(a, b) for a, b in zip(g_trace, other_trace))
        assert torch.equal(g_final.P, other.P) and torch.equal(g_final.scores, other.scores)
        assert torch.equal(g_final.remaining, other.remaining)
    assert g_stats.stream_seconds > 0


@pytest.mark.cuda
def test_step_buffer_holds_the_steps_frames(heur):
    """After a graphed step, the static step buffer holds the host-decoded
    frames of the step's sampled seconds, and ``step_secs`` those seconds."""
    cfg = dataclasses.replace(CFG, cache_mode="streaming")
    stream = build_frame_cache("mem://v", cfg, device="cuda", decoder=scene_variant(2, 300.0))
    scorer = heur.build_scorer(stream.frames, TARGETS, CUES, cfg)
    state = init_state(stream.n_valid, 2, cfg, torch.Generator(device="cuda").manual_seed(4),
                       n_pad=stream.n_pad, device="cuda")
    stepper = Stepper.single(state, scorer, cfg, graphs=True, paged=stream)
    buf = stepper.scorer.step_frames
    assert buf.device.type == "cuda" and tuple(buf.shape) == (16, 32, 64, 3)
    assert stepper.scorer.cache.shape == (1, 32, 64, 3)
    active = stepper.setup()
    for _ in range(3):
        if not any(active):
            break
        active = stepper.step(active)
        secs = stepper.secs[0].cpu().tolist()
        assert stepper.scorer.step_frames.data_ptr() == buf.data_ptr()     # static
        np.testing.assert_array_equal(buf.cpu().numpy(), stream.gather_host(secs))
        assert stepper.scorer.step_secs.cpu().tolist() == secs


@pytest.mark.cuda
def test_reference_verify_graphed_equals_eager(heur):
    cache = build_frame_cache("mem://v", CFG, device="cuda", decoder=scene_variant(1, 300.0))
    scorer = heur.build_scorer(cache.frames, TARGETS, CUES, CFG)
    source = trv.make_raw_frame_source("mem://v", CFG, decoder=scene_variant(1, 300.0))
    runs = []
    for graphs in (None, False):
        state = init_state(cache.n_valid, 2, CFG, torch.Generator(device="cuda").manual_seed(2),
                           n_pad=cache.n_pad, device="cuda")
        stats = StepStats()
        final, secs, decisions = trv.run_search_reference_verify(
            state, scorer, CFG, source, collect_decisions=True, graphs=graphs, stats=stats)
        runs.append((final, secs.cpu(), decisions, stats))
    (gf, gs, gd, gst), (ef, es, ed, est) = runs
    assert gst.replays > 0 and est.replays == 0
    assert gd == ed and torch.equal(gs, es) and torch.equal(gf.remaining, ef.remaining)


@pytest.mark.cuda
def test_searches_share_one_capture_stream(heur):
    """Every graphed search on a device in one thread captures on one side
    stream (cuBLAS keeps a workspace for each stream it runs on); a search
    in another thread gets a stream of its own."""
    import threading

    cache = build_frame_cache("mem://v", CFG, device="cuda", decoder=scene_variant(1, 300.0))
    scorer = heur.build_scorer(cache.frames, TARGETS, CUES, CFG)

    def stepper(seed):
        state = init_state(cache.n_valid, 2, CFG,
                           torch.Generator(device="cuda").manual_seed(seed),
                           n_pad=cache.n_pad, device="cuda")
        return Stepper.single(state, scorer, CFG, graphs=True)

    first, second = stepper(0), stepper(1)
    assert first._stream == second._stream
    other = []
    thread = threading.Thread(target=lambda: other.append(stepper(2)))
    thread.start()
    thread.join()
    assert other and other[0]._stream != first._stream
