"""The port's streaming (host-paged) search against its resident search and
the JAX package's ``run_search_streaming``, on the CPU.

On a 60 s mp4 that the reference's ``write_synthetic_video`` writes
(96x160, a planted couch), read by each package's own decoder:

  * ``StreamingFrameCache.gather_host`` gives the resident cache's rows and
    the reference's ``gather_host``'s, byte for byte;
  * ``build_frame_cache``'s policy (auto under and over the budget,
    streaming, resident over the budget, downscale) as the reference's;
  * the streaming search on the tiny OWL-ViT (the reference's weights,
    ``params_from_jax``) with the reference's Gumbel draws replayed
    (``jax_noise``) samples the same seconds every step as the reference's
    streaming search and the port's resident one, and pops the same
    keyframes; ``P`` agrees with the reference's within the history tests'
    1e-5 and equals the port's resident ``P`` exactly;
  * ``search_videos`` streams the videos the reference's streams;
  * a streaming cache refuses ``search_with_visualization`` and a scorer
    without a step buffer, with the reference's errors.

Runs only where cv2 imports (it writes the video).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_noise
from tests.test_torch_owlvit import tiny_pair
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models.clip_tokenizer import HashTokenizer as JHash
from tstar_tpu.parallel import multi_video as jmv
from tstar_tpu.search import detector_scorer as jds
from tstar_tpu.search import engine as jeng
from tstar_tpu.search.state import init_state as jinit
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu.video import cache as jcache
from tstar_tpu.video.synthetic import PlantedObject, write_synthetic_video
from tstar_tpu_torch.framework.heuristics import OwlVitHeuristic
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THash
from tstar_tpu_torch.parallel import multi_video as tmv
from tstar_tpu_torch.search import detector_scorer as tds
from tstar_tpu_torch.search import engine as teng
from tstar_tpu_torch.search.scorers import TableScorer
from tstar_tpu_torch.search.searcher import KeyframeSearcher
from tstar_tpu_torch.search.state import init_state as tinit
from tstar_tpu_torch.search.step_graphs import StepStats
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig
from tstar_tpu_torch.video import cache as tcache

cv2 = pytest.importorskip("cv2")

BASE = dict(cache_hw=(48, 80), search_budget=0.5, confidence_threshold=0.2)
TARGETS, CUES = ["couch", "lamp"], ["tv"]
TOL = 1e-5
SMALL = 100_000          # bytes: under a 60 s cache at 48x80 (128 padded x 11,520)


def configs(**overrides):
    kw = {**BASE, **overrides}
    return JSearchConfig(**kw), TSearchConfig(**kw)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    path = str(d / "scene.mp4")
    write_synthetic_video(path, duration_sec=60.0, fps=10.0, hw=(96, 160), objects=[
        PlantedObject("couch", (30.0, 36.0), (200, 40, 40), (0.5, 0.5), 0.5),
        PlantedObject("tv", (10.0, 40.0), (40, 40, 200), (0.3, 0.75), 0.25)])
    longer = str(d / "longer.mp4")
    write_synthetic_video(longer, duration_sec=130.0, fps=10.0, hw=(48, 64))
    return path, longer


@pytest.fixture(scope="module")
def owl():
    jmodel = jow.OwlViTDetector(tiny_pair(jow), dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32))
    theur = OwlVitHeuristic(device="cpu", dtype=torch.float32, model_config=tiny_pair(tow))
    theur.model.load_state_dict(tow.params_from_jax(variables), strict=True)
    theur.tokenizer = THash(100, 8)
    return jmodel, variables, theur


class Recording:
    """A stream that records the seconds each step asks for."""

    def __init__(self, stream):
        self.stream, self.asked = stream, []

    def __getattr__(self, name):
        return getattr(self.stream, name)

    def gather_host(self, secs):
        self.asked.append([int(s) for s in secs])
        return self.stream.gather_host(secs)


@pytest.fixture(scope="module")
def reference_run(video, owl):
    """The reference's streaming search on the video: (final state, keyframe
    seconds, each step's seconds)."""
    jmodel, variables, _ = owl
    jcfg, _ = configs()
    stream = jcache.build_frame_cache(video[0], jcfg, hbm_budget_bytes=SMALL)
    assert isinstance(stream, jcache.StreamingFrameCache)
    scorer = jds.make_owlvit_scorer(jmodel, variables, stream.frames, TARGETS, CUES,
                                    JHash(100, 8), jcfg)
    rec = Recording(stream)
    s0 = jinit(stream.n_valid, 2, jcfg, jax.random.key(4), n_pad=stream.n_pad)
    final, secs = jeng.run_search_streaming(s0, scorer, rec, jcfg)
    stream.close()
    return final, np.asarray(secs), rec.asked


def test_gather_host_rows_equal_resident_and_reference(video):
    jcfg, tcfg = configs()
    resident = tcache.build_frame_cache(video[0], tcfg, device="cpu")
    stream = tcache.build_frame_cache(video[0], tcfg, device="cpu", budget_bytes=SMALL)
    ref = jcache.build_frame_cache(video[0], jcfg, hbm_budget_bytes=SMALL)
    assert isinstance(stream, tcache.StreamingFrameCache)
    secs = [0, 7, 13, 31, 59, 2, 30]
    got = stream.gather_host(secs)
    np.testing.assert_array_equal(got, resident.frames.numpy()[secs])
    np.testing.assert_array_equal(got, ref.gather_host(np.asarray(secs)))
    assert tuple(stream.frames.shape) == (1, 48, 80, 3) and stream.frames.dtype == torch.uint8
    stream.close()
    ref.close()


@pytest.mark.parametrize("mode, budget", [
    ("auto", 10 ** 9), ("auto", SMALL), ("streaming", 10 ** 9), ("resident", SMALL),
    ("downscale", SMALL),
])
def test_cache_policy_matches_reference(video, mode, budget):
    jcfg, tcfg = configs(cache_mode=mode)
    try:
        want = jcache.build_frame_cache(video[0], jcfg, hbm_budget_bytes=budget)
    except ValueError as e:
        with pytest.raises(ValueError, match="resident"):
            tcache.build_frame_cache(video[0], tcfg, device="cpu", budget_bytes=budget)
        assert "resident" in str(e)
        return
    got = tcache.build_frame_cache(video[0], tcfg, device="cpu", budget_bytes=budget)
    assert type(got).__name__ == type(want).__name__
    for k in ("n_valid", "n_pad", "raw_fps", "duration"):
        assert getattr(got, k) == getattr(want, k), k
    if isinstance(want, jcache.StreamingFrameCache):
        assert got.cache_hw == want.cache_hw == (48, 80)
        want.close()
    else:
        np.testing.assert_array_equal(got.frames.numpy(), np.asarray(want.frames))
    with pytest.raises(ValueError, match="cache_mode"):
        tcache.build_frame_cache(video[0], dataclasses.replace(tcfg, cache_mode="nope"),
                                 device="cpu")


def _port_search(video, owl, reference_run, mode):
    """The port's search of ``video`` under ``cache_mode=mode`` on the
    reference's noise -> (final, keyframe secs, each step's seconds, stats)."""
    _, _, theur = owl
    _, tcfg = configs(cache_mode=mode)
    cache = tcache.build_frame_cache(video[0], tcfg, device="cpu")
    scorer = theur.build_scorer(cache.frames, TARGETS, CUES, tcfg)
    steps = int(reference_run[0].iteration)
    state = tinit(cache.n_valid, 2, tcfg, iter(jax_noise(4, cache.n_pad, steps)),
                  n_pad=cache.n_pad)
    stats = StepStats(record=True)
    if mode == "streaming":
        final, secs = teng.run_search_streaming(state, scorer, cache, tcfg, stats=stats)
        cache.close()
    else:
        final, secs = teng.run_search(state, scorer, tcfg, stats=stats)
    return final, secs.numpy(), [t["secs"][0].tolist() for t in stats.trace], stats


def test_streaming_search_matches_resident_and_reference(video, owl, reference_run):
    jfinal, jsecs, jasked = reference_run
    sfinal, ssecs, sasked, sstats = _port_search(video, owl, reference_run, "streaming")
    rfinal, rsecs, rasked, rstats = _port_search(video, owl, reference_run, "resident")
    assert sstats.steps == rstats.steps == len(jasked) >= 2
    assert sasked == rasked == jasked                        # every step's seconds
    np.testing.assert_array_equal(ssecs, jsecs)
    np.testing.assert_array_equal(rsecs, jsecs)
    np.testing.assert_array_equal(sfinal.P.numpy(), rfinal.P.numpy())
    np.testing.assert_array_equal(sfinal.scores.numpy(), rfinal.scores.numpy())
    np.testing.assert_allclose(sfinal.P.numpy(), np.asarray(jfinal.P), atol=TOL)
    np.testing.assert_array_equal(sfinal.remaining.numpy(), np.asarray(jfinal.remaining))
    assert sfinal.iteration == int(jfinal.iteration)
    # three host reads a streaming step (seconds, candidate count, flags), two resident
    assert sstats.host_reads == 3 * sstats.steps and rstats.host_reads == 2 * rstats.steps
    assert sstats.verify_widths == rstats.verify_widths


def test_searcher_streams_a_file_from_its_path(video, owl):
    """``KeyframeSearcher`` from the path alone: the streaming search returns
    the resident one's keyframes, frames and distribution."""
    _, _, theur = owl
    runs = {}
    for mode in ("resident", "streaming"):
        _, tcfg = configs(cache_mode=mode)
        s = KeyframeSearcher(video[0], theur, TARGETS, CUES, search_budget=0.5,
                             confidence_threshold=0.2, config=tcfg, seed=3)
        runs[mode] = (s, *s.search())
    (rs, rframes, rstamps), (ss, sframes, sstamps) = runs["resident"], runs["streaming"]
    assert isinstance(ss.cache, tcache.StreamingFrameCache)
    assert sstamps == rstamps and len(sstamps) == 8
    for a, b in zip(sframes, rframes):
        np.testing.assert_array_equal(a, b)
    assert a.shape == (96, 160, 3)
    np.testing.assert_array_equal(ss.P, rs.P)
    assert ss.remaining_targets == rs.remaining_targets
    assert ss.step_stats.host_reads == 3 * ss.step_stats.steps
    assert ss.step_stats.stream_seconds > 0
    with pytest.raises(ValueError, match="resident"):
        ss.search_with_visualization()


def test_scorer_without_step_buffer_raises(video):
    _, tcfg = configs(cache_mode="streaming")
    stream = tcache.build_frame_cache(video[0], tcfg, device="cpu")
    n = stream.n_pad
    scorer = TableScorer(torch.zeros(n), torch.zeros(n, 4, dtype=torch.bool),
                         torch.zeros(n), torch.zeros(n, 4, dtype=torch.bool))
    state = tinit(stream.n_valid, 2, tcfg, torch.Generator().manual_seed(0), n_pad=n)
    with pytest.raises(TypeError, match="streaming"):
        teng.run_search_streaming(state, scorer, stream, tcfg)
    assert hasattr(tds.OwlVitScorer, "score_verify_raw")


@pytest.mark.parametrize("mode, budget", [("auto", 16 * 1024 ** 2), ("streaming", None),
                                          ("downscale", 16 * 1024 ** 2)])
def test_search_videos_streams_what_the_reference_streams(monkeypatch, video, owl, mode, budget):
    """With a 16 MiB device total each package gives a video a quarter of it
    over twice its bucket's size: the two 130 s videos (256 padded seconds,
    a bucket of two, 1 MiB each) stream their 2,949,120-byte caches, the
    60 s one (128 padded seconds, a bucket of one, 2 MiB) keeps its
    1,474,560 bytes resident.  Both packages route the same videos (the
    searches themselves are stubbed: the routing alone is compared)."""
    short_path, long_path = video
    jcfg, tcfg = configs(cache_mode=mode)
    routes = {}
    for name, mv, cfg in (("ref", jmv, jcfg), ("port", tmv, tcfg)):
        streamed, batched = [], []

        def stream_stub(task, *a, _s=streamed, **k):
            _s.append(task.video_path)
            return {"video_path": task.video_path}

        def bucket_stub(tasks, caches, *a, _b=batched, **k):
            _b.extend(t.video_path for t in tasks)
            return [{"video_path": t.video_path} for t in tasks]

        monkeypatch.setattr(mv, "_search_streaming_video", stream_stub)
        monkeypatch.setattr(mv, "_search_bucket", bucket_stub)
        tasks = [mv.VideoTask(p, TARGETS, CUES, seed=i)
                 for i, p in enumerate([long_path, short_path, long_path])]
        heur = owl[2] if name == "port" else None
        out = mv.search_videos(tasks, heur, cfg, hbm_budget_bytes=budget)
        assert [r["video_path"] for r in out] == [t.video_path for t in tasks]
        routes[name] = (sorted(streamed), sorted(batched))
    assert routes["port"] == routes["ref"]
    streamed = {"auto": [long_path] * 2, "streaming": sorted([long_path] * 2 + [short_path]),
                "downscale": []}[mode]
    assert routes["port"][0] == streamed
