"""The port's T* pipeline (``framework/framework.py``, the ``color-probe``
heuristic, the detector surface, profiling, images) against the JAX
package's, on the CPU; mirrors ``tests/test_framework.py``.

Both read a synthetic mp4 (``write_synthetic_video``: ``default_scene``,
120 s) from its path, each through its own file decoder (their frames are
byte-equal, ``tests/test_torch_decoder.py``).  The search noise
is the reference's Gumbel draws, replayed into the port's searcher
(``jax_noise``), so both pipelines sample the same seconds: the grounding
objects, the keyframe timestamps and the answer of ``run()`` must be EQUAL.
Both use the fake grounder (the VLM stages have their own parity tests).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_noise
from tests.test_torch_owlvit import tiny_pair
from tstar_tpu.framework import framework as jfw
from tstar_tpu.framework.heuristics import OwlVitHeuristic as JOwlHeuristic
from tstar_tpu.framework.heuristics import initialize_heuristic as jinit_heuristic
from tstar_tpu.grounding.fake import FakeGrounder as JFakeGrounder
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models.clip_tokenizer import HashTokenizer as JHash
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu.video.decoder import open_video
from tstar_tpu.video.synthetic import default_scene as write_default_scene
from tstar_tpu_torch.framework import framework as tfw
from tstar_tpu_torch.framework.heuristics import (
    ColorProbeHeuristic,
    OwlVitHeuristic,
    initialize_heuristic,
)
from tstar_tpu_torch.grounding.fake import FakeGrounder
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THash
from tstar_tpu_torch.search import searcher as tsearcher
from tstar_tpu_torch.utils.config import FrameworkConfig, SearchConfig, dataset_config, demo_config
from tstar_tpu_torch.utils.profiling import StageTimer
from tstar_tpu_torch.video import cache as tcache


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file
    several-fold; its tiny shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


cv2 = pytest.importorskip("cv2")

QUESTION = "What is the color of the couch?"
OPTIONS = "A) Blue\nB) Red\nC) Green\nD) White"
STAGES = {"grounding", "decode_and_setup", "search", "qa"}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.mp4")
    meta = write_default_scene(path, duration_sec=120.0)
    return path, meta


@pytest.fixture(scope="module")
def tiny_owl():
    """The reference's tiny OWL-ViT heuristic and the port's, same weights."""
    jheur = JOwlHeuristic.__new__(JOwlHeuristic)
    jheur.name = "owl-vit-tiny"
    jheur.model = jow.OwlViTDetector(tiny_pair(jow), dtype=jnp.float32)
    jheur.variables = jax.jit(jheur.model.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32))
    jheur.tokenizer = JHash(100, 8)
    theur = OwlVitHeuristic(device="cpu", dtype=torch.float32, model_config=tiny_pair(tow))
    theur.model.load_state_dict(tow.params_from_jax(jheur.variables), strict=True)
    theur.tokenizer = THash(100, 8)
    return jheur, theur


def _run_both(monkeypatch, tmp_path, scene, jheur, theur, seed=0, **kw):
    """``run()`` of both frameworks on the same video, question and fake
    grounder, the port's search on the reference's replayed noise (the port
    saves its artifacts, the reference does not).  Returns (reference
    result, port result, port framework)."""
    path, _ = scene
    searchers = []

    class Recording(jfw.KeyframeSearcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            searchers.append(self)

    monkeypatch.setattr(jfw, "KeyframeSearcher", Recording)
    config = kw.pop("config", None)
    args = dict(question=QUESTION, options=OPTIONS, seed=seed, **kw)
    want = jfw.TStarFramework(
        video_path=path, heuristic=jheur, save_artifacts=False,
        grounder=JFakeGrounder(["couch"], ["tv"], qa_answer="B"),
        output_dir=str(tmp_path / "ref"),
        config=None if config is None else JSearchConfig(**config), **args,
    ).run()
    (ref,) = searchers
    steps = len(ref.P_history)
    noise = iter(jax_noise(seed, ref.cache.n_pad, steps))
    real = tsearcher.init_state
    monkeypatch.setattr(tsearcher, "init_state",
                        lambda *a, **k: real(*a, **k).replace(rng=noise))
    fw = tfw.TStarFramework(
        video_path=path, heuristic=theur, device="cpu",
        grounder=FakeGrounder(["couch"], ["tv"], qa_answer="B"),
        output_dir=str(tmp_path / "port"),
        config=None if config is None else SearchConfig(**config), **args,
    )
    got = fw.run()
    assert len(fw.video_searcher.P_history) == steps >= 3
    return want, got, fw


def test_color_probe_tables_match_reference(scene):
    path, _ = scene
    cfg = SearchConfig()
    host = tcache.build_frame_cache_host(path, cfg, decoder=open_video(path))
    want = jinit_heuristic("color-probe").build_scorer(
        jnp.asarray(host.frames), ["couch", "lamp"], ["tv"], JSearchConfig())
    got = initialize_heuristic("color-probe", device="cpu").build_scorer(
        torch.from_numpy(host.frames), ["couch", "lamp"], ["tv"], cfg)
    assert isinstance(initialize_heuristic("fake", device="cpu"), ColorProbeHeuristic)
    np.testing.assert_allclose(got.grid_conf.numpy(), np.asarray(want.grid_conf), atol=1e-6)
    np.testing.assert_array_equal(got.grid_presence.numpy(), np.asarray(want.grid_presence))
    np.testing.assert_array_equal(got.verify_presence.numpy(), np.asarray(want.verify_presence))
    assert got.grid_presence[:, 0].any() and got.grid_presence[:, 2].any()   # couch, tv


def test_run_color_probe_matches_reference(monkeypatch, tmp_path, scene):
    """The fake grounder and ``color-probe`` (confidence threshold 2.0: no
    target is confirmed and the search spends its budget): the same result
    as the reference's ``run()``, the stage timings under the reference's
    names, and (the port saving artifacts) the keyframe JPEGs, the search GIF
    and the score plot."""
    want, got, fw = _run_both(monkeypatch, tmp_path, scene, jinit_heuristic("color-probe"),
                              initialize_heuristic("color-probe", device="cpu"),
                              search_budget=1.0, confidence_threshold=2.0)
    assert got == want
    assert got["Answer"] == "B" and len(got["Frame Timestamps"]) == 8
    assert set(fw.results["Timings"]) == STAGES
    assert all(v["count"] == 1 for v in fw.results["Timings"].values())
    assert os.path.exists(os.path.join(fw.output_dir, "score_distribution.png"))
    assert os.path.exists(os.path.join(fw.output_dir, "search_iterations.gif"))
    assert len(os.listdir(os.path.join(fw.output_dir, "frames"))) == 8


def test_run_owlvit_matches_reference(monkeypatch, tmp_path, scene, tiny_owl):
    """A tiny OWL-ViT (``owl-vit-random``'s architecture, the reference's
    weights): the same grounding objects, timestamps and answer."""
    want, got, fw = _run_both(monkeypatch, tmp_path, scene, *tiny_owl, seed=2,
                              search_budget=0.5, confidence_threshold=0.5,
                              config=dict(cache_hw=(32, 64)))
    assert got == want
    assert fw.video_searcher.detect_bbox_iters       # the detector's history was kept


def test_int_budget_maps_to_full_cap(scene, tmp_path):
    """The framework's int default 1000 on a 120 s video is the full
    1000-frame cap, not min(1000, N); a small int budget is min(1000, N *
    budget)."""
    path, _ = scene
    fw = tfw.TStarFramework(
        video_path=path, heuristic=initialize_heuristic("color-probe", device="cpu"),
        grounder=FakeGrounder(["couch"], ["tv"]), question="q?", options="A) x",
        output_dir=str(tmp_path / "budget"), search_budget=1000, device="cpu",
    )
    searcher = fw.initialize_videoSearcher(["couch"], ["tv"])
    n = searcher.total_frame_num
    assert searcher.config.budget_frames(n) == 1000
    fw.search_budget = 2
    assert fw.initialize_videoSearcher(["couch"], ["tv"]).config.budget_frames(n) == min(1000, 2 * n)


def test_run_tstar_one_shot(scene, tmp_path):
    path, _ = scene
    results = tfw.run_tstar(
        video_path=path, question="Where is the couch?", options="A) Left\nB) Right",
        grounder="fake", heuristic="color-probe", search_budget=0.5,
        output_dir=str(tmp_path / "out2"), device="cpu",
    )
    assert set(results) == {"Grounding Objects", "Frame Timestamps", "Answer"}
    assert len(results["Frame Timestamps"]) == 8


def test_a_path_alone_reads_the_file(scene, tmp_path):
    """Without ``decoder=`` the framework reads the file with the port's
    decoder: ``run_tstar`` gives what it gives over the reference's decoder
    passed in, the keyframes at native size; a missing file raises the
    decoder's ``ValueError`` at its first read, after the grounding."""
    path, _ = scene
    kw = dict(question="Where is the couch?", options="A) Left\nB) Right", grounder="fake",
              heuristic="color-probe", search_budget=0.5, device="cpu", seed=3)
    alone = tfw.run_tstar(path, output_dir=str(tmp_path / "a"), **kw)
    given = tfw.run_tstar(path, output_dir=str(tmp_path / "b"), decoder=open_video(path), **kw)
    assert alone == given
    fw = tfw.TStarFramework(video_path=path, heuristic=ColorProbeHeuristic(device="cpu"),
                            grounder=FakeGrounder(), question="q?", options="A) x",
                            output_dir=str(tmp_path / "c"), device="cpu", save_artifacts=False)
    frames, _ = fw.perform_search(fw.initialize_videoSearcher(["couch"], ["tv"]))
    assert len(frames) == 8 and all(f.shape == (96, 160, 3) for f in frames)
    grounder = FakeGrounder()
    fw = tfw.TStarFramework(video_path=str(tmp_path / "missing.mp4"),
                            heuristic=ColorProbeHeuristic(device="cpu"), grounder=grounder,
                            question="q?", options="A) x", output_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="Cannot open video file"):
        fw.run()
    assert [c["kind"] for c in grounder.calls] == ["grounding"]


def test_cuda_without_a_card_raises(monkeypatch, scene, tmp_path):
    """``device='cuda'`` (the default) on a machine without a card raises;
    there is no CPU fallback."""
    path, _ = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfw.TStarFramework(video_path=path, heuristic=ColorProbeHeuristic(device="cpu"),
                           grounder=FakeGrounder(), question="q?", options="A) x",
                           output_dir=str(tmp_path), decoder=open_video(path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfw.run_tstar(path, "q?", "A) x", grounder="fake", heuristic="color-probe",
                      decoder=open_video(path))
    with pytest.raises(ValueError, match="the heuristic runs on cpu"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        tfw.TStarFramework(video_path=path, heuristic=ColorProbeHeuristic(device="cpu"),
                           grounder=FakeGrounder(), question="q?", options="A) x",
                           output_dir=str(tmp_path), decoder=open_video(path))


def test_detector_surface_matches_reference(tmp_path, tiny_owl):
    """``inference(image_path)`` and ``bbox_visualization`` on the tiny
    OWL-ViT: the reference's detections (boxes within 1e-3 px, confidences
    within 1e-5, the same classes) and the same annotated image."""
    from PIL import Image

    jheur, theur = tiny_owl
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (48, 80, 3), np.uint8)
    path = str(tmp_path / "img.png")
    Image.fromarray(image).save(path)
    for h in tiny_owl:
        h.reparameterize_object_list(["couch"], ["tv"])
    want = jheur.inference(path, score_threshold=0.005)
    got = theur.inference(path, score_threshold=0.005)
    assert len(got["class_id"]) == len(want["class_id"]) > 0
    np.testing.assert_array_equal(got["class_id"], want["class_id"])
    np.testing.assert_allclose(got["confidence"], want["confidence"], atol=1e-5)
    np.testing.assert_allclose(got["xyxy"], want["xyxy"], atol=1e-3)
    drawn = theur.bbox_visualization([image], [got])[0]
    np.testing.assert_array_equal(drawn, jheur.bbox_visualization([image], [got])[0])
    assert not np.array_equal(drawn, image)


def test_framework_configs_match_reference():
    from tstar_tpu.utils import config as jconfig

    for name in ("demo_config", "dataset_config"):
        got, want = globals()[name](), getattr(jconfig, name)()
        for field in ("grounder", "heuristic", "grounding_num_frames", "qa_temperature",
                      "qa_max_tokens", "output_dir", "save_artifacts", "seed"):
            assert getattr(got, field) == getattr(want, field), (name, field)
        assert got.search.confidence_threshold == want.search.confidence_threshold
        assert got.search.search_budget == want.search.search_budget
    assert FrameworkConfig(seed=3).seed == 3 and isinstance(FrameworkConfig().search, SearchConfig)


def test_stage_timer_and_metrics_logger():
    t = StageTimer()
    for name in ("decode", "decode", "search"):
        with t.stage(name):
            pass
    rep = t.report()
    assert rep["decode"]["count"] == 2 and rep["search"]["count"] == 1
    assert rep["decode"]["total_s"] >= 0


def test_image_utilities(tmp_path):
    """The base64, GIF and JPEG helpers, and ``extract_frames_at_fps``
    through a decoder."""
    import base64

    from tstar_tpu_torch.utils import images
    from tstar_tpu_torch.video.synthetic import default_scene

    frame = np.full((8, 8, 3), 128, np.uint8)
    assert base64.b64decode(images.encode_image_to_base64(frame))[:2] == b"\xff\xd8"
    with pytest.raises(ValueError):
        images.encode_image_to_base64([1, 2])
    gif = str(tmp_path / "g.gif")
    images.save_as_gif([frame, frame + 10, frame + 20], gif)
    assert images.extract_frames_from_gif(gif, str(tmp_path / "x")) == 3
    paths = images.save_frames_as_jpegs([frame, frame], [1.0, 2.5], str(tmp_path / "f"))
    assert [os.path.basename(p) for p in paths] == ["frame_0_at_1.00s.jpg", "frame_1_at_2.50s.jpg"]
    n = images.extract_frames_at_fps("mem://v", str(tmp_path / "fps"), fps=1.0,
                                     decoder=default_scene(12.0, hw=(36, 64)))
    assert n == 12 == len(os.listdir(tmp_path / "fps"))
