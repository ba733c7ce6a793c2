"""Slices 1 to 3 of the port as a whole: detector scorer (in its compute
dtype, quantized, with a reduced verification size, and over the K7 grid
kernel; the other slice-3 routes are in ``tests/test_torch_preprocess.py``
and ``tests/test_torch_flash.py``), frame cache, searcher.

The slice tests drive the reference and the port over the same synthetic
frame cache, with the same tiny OWL-ViT weights (``params_from_jax``) and
the same Gumbel noise (the reference key schedule's draws, replayed); each
package gets its own ``SearchConfig`` built from the same keyword arguments.
The sampled seconds of every iteration and the final keyframes must be
EQUAL; final scores agree to 1e-5 (float32 detector confidences, ~1e-6 apart
after the towers, then written and splatted unchanged).
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_noise
from tests.test_torch_owlvit import tiny_pair
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models.clip_tokenizer import HashTokenizer as JHash
from tstar_tpu.search import detector_scorer as jds
from tstar_tpu.search import engine as jeng
from tstar_tpu.search.state import init_state as jinit
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu.video import cache as jcache
from tstar_tpu_torch.framework.heuristics import OwlVitHeuristic, initialize_heuristic
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THash
from tstar_tpu_torch.search import detector_scorer as tds
from tstar_tpu_torch.search import engine as teng
from tstar_tpu_torch.search.searcher import KeyframeSearcher
from tstar_tpu_torch.search.state import init_state as tinit
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig
from tstar_tpu_torch.video import cache as tcache
from tstar_tpu_torch.video.synthetic import default_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file
    several-fold; its tiny shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(search_budget=1.0, cache_hw=(32, 64))
CFG = TSearchConfig(**BASE)
TARGETS, CUES = ["couch", "lamp"], ["tv"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configs(**overrides):
    """(reference config, port config) from the same keyword arguments."""
    kw = {**BASE, **overrides}
    return JSearchConfig(**kw), TSearchConfig(**kw)


@pytest.fixture(scope="module")
def pair():
    """(reference model, variables, port model, host cache) at tiny widths."""
    jmodel = jow.OwlViTDetector(tiny_pair(jow), dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32)
    )
    tmodel = tow.OwlViTDetector(tiny_pair(tow))
    tmodel.load_state_dict(tow.params_from_jax(variables), strict=True)
    tmodel.requires_grad_(False)
    host = tcache.build_frame_cache_host("mem://scene", CFG, decoder=default_scene(450.0))
    return jmodel, variables, tmodel, host


def _scorers(pair, **overrides):
    jmodel, variables, tmodel, host = pair
    jcfg, tcfg = configs(**overrides)
    js = jds.make_owlvit_scorer(
        jmodel, variables, jnp.asarray(host.frames), TARGETS, CUES, JHash(100, 8), jcfg
    )
    ts = tds.make_owlvit_scorer(
        tmodel, torch.from_numpy(host.frames), TARGETS, CUES, THash(100, 8), tcfg
    )
    return js, ts


def test_prompt_batch_matches():
    jcfg, tcfg = configs()
    want = jds.build_prompt_batch(TARGETS, CUES, JHash(100, 8), jcfg)
    got = tds.build_prompt_batch(TARGETS, CUES, THash(100, 8), tcfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_scorer_matches_reference(pair):
    js, ts = _scorers(pair)
    np.testing.assert_allclose(ts.query_embeds.numpy(), np.asarray(js.query_embeds), atol=2e-5)
    secs = np.array([70, 75, 401, 405, 30, 0, 9, 12, 200, 150, 333, 440, 60, 61, 62, 63])
    for method, idx in (("score_grid", secs), ("score_verify", secs[:8])):
        jc, jp = jax.jit(getattr(js, method))(jnp.asarray(idx, jnp.int32))
        tc, tp = getattr(ts, method)(torch.from_numpy(idx))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, err_msg=method)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), err_msg=method)


SECS = np.array([70, 75, 401, 405, 30, 0, 9, 12, 200, 150, 333, 440, 60, 61, 62, 63])


def _assert_scorers_match(js, ts, atol):
    for method, idx in (("score_grid", SECS), ("score_verify", SECS[:8])):
        jc, jp = jax.jit(getattr(js, method))(jnp.asarray(idx, jnp.int32))
        tc, tp = getattr(ts, method)(torch.from_numpy(idx))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=atol, err_msg=method)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), err_msg=method)


def test_scorer_matches_reference(pair):
    js, ts = _scorers(pair)
    np.testing.assert_allclose(ts.query_embeds.numpy(), np.asarray(js.query_embeds), atol=2e-5)
    _assert_scorers_match(js, ts, atol=1e-5)


@pytest.mark.parametrize(
    "override",
    [
        {"detector_quant": "int8"},
        {"detector_quant": "w8a16"},
        {"verify_image_size": 48},
        {"detector_quant": "int8", "verify_image_size": 48},
    ],
)
def test_quant_and_verify_size_scorers_match_reference(pair, override):
    """The quantized towers and the 48-pixel verification view (3x3 patches
    of 16 instead of 4x4): the same confidences within 1e-5 and the same
    presence masks.  (An int8 rounding flip upstream, see
    ``tests/test_torch_quant.py``, would show here as a larger difference.)"""
    js, ts = _scorers(pair, **override)
    assert (ts.qvision is None) == ("detector_quant" not in override)
    if "verify_image_size" in override:
        assert ts._verify_model.cfg.vision.image_size == 48
        fc1 = lambda m: m.vision.encoder.layers[0].mlp.fc1.kernel  # noqa: E731
        assert fc1(ts._verify_model).data_ptr() == fc1(ts.model).data_ptr()
    _assert_scorers_match(js, ts, atol=1e-5)


def test_scorer_rejects_unknown_quant(pair):
    tmodel, host = pair[2], pair[3]
    with pytest.raises(ValueError, match="detector_quant"):
        tds.make_owlvit_scorer(
            tmodel, torch.from_numpy(host.frames), TARGETS, CUES, THash(100, 8),
            dataclasses.replace(CFG, detector_quant="int4"),
        )


@pytest.mark.parametrize("override", [{"use_pallas_preprocess": True}])
def test_scorer_rejects_unported_options(pair, override):
    """The option earlier slices refused, ``use_pallas_preprocess=True``, now
    builds and routes each grid forward through K7 (its plain version on a
    CPU tensor); the native verification size and an explicit False are the
    default path."""
    tmodel, host = pair[2], pair[3]
    cache = torch.from_numpy(host.frames)
    cfg = dataclasses.replace(CFG, **override)
    scorer = tds.make_owlvit_scorer(tmodel, cache, TARGETS, CUES, THash(100, 8), cfg)
    assert scorer.config.use_pallas_preprocess is True
    from tstar_tpu_torch.kernels import pallas_grid

    calls = []
    real = pallas_grid.build_detector_grid_pallas_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_grid, "build_detector_grid_pallas_plain",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        conf, _ = scorer.score_grid(torch.from_numpy(SECS))
    assert calls == [1] and conf.shape == (16,) and torch.isfinite(conf).all()
    native = tmodel.cfg.vision.image_size
    ok = dataclasses.replace(CFG, verify_image_size=native, use_pallas_preprocess=False)
    scorer = tds.make_owlvit_scorer(tmodel, cache, TARGETS, CUES, THash(100, 8), ok)
    assert scorer.config is ok and scorer.verify_model is None and scorer.qvision is None


def test_host_cache_matches_reference():
    """Same duck-typed decoder into both cache builders: identical frames.
    The port's probe reads the decoder, not the (fake) path."""
    jcfg, tcfg = configs()
    want = jcache.build_frame_cache_host("unused", jcfg, decoder=default_scene(200.0))
    got = tcache.build_frame_cache_host("unused", tcfg, decoder=default_scene(200.0))
    np.testing.assert_array_equal(got.frames, want.frames)
    assert (got.n_valid, got.n_pad, got.raw_fps, got.duration) == (
        want.n_valid, want.n_pad, want.raw_fps, want.duration
    )
    dev = tcache.build_frame_cache("unused", tcfg, device="cpu", decoder=default_scene(200.0))
    np.testing.assert_array_equal(dev.frames.numpy(), want.frames)
    assert tcache.fit_cache_hw((192, 384), 4096, 10 ** 8) == jcache.fit_cache_hw((192, 384), 4096, 10 ** 8)


def _search_both(pair, seed, score_atol=1e-5, **overrides):
    """Run the reference's search and the port's step by step on replayed
    noise; the sampled seconds of every iteration, the keyframes and the
    remaining targets must be equal, the final scores within ``score_atol``."""
    js, ts = _scorers(pair, **overrides)
    jcfg, tcfg = configs(**overrides)
    host = pair[3]
    s0 = jinit(host.n_valid, len(TARGETS), jcfg, jax.random.key(seed), n_pad=host.n_pad)
    jfinal, jsecs, history = jeng.run_search_with_history(s0, js, jcfg)
    assert len(history) >= 5

    noise = iter(jax_noise(seed, host.n_pad, len(history)))
    state = tinit(host.n_valid, len(TARGETS), tcfg, noise, n_pad=host.n_pad)
    verified = []
    score_verify = ts.score_verify
    ts.score_verify = lambda secs: verified.append(secs.numel()) or score_verify(secs)
    it = 0
    with torch.no_grad():
        while teng._continue(state):
            state, aux = teng.search_step(state, ts, tcfg)
            np.testing.assert_array_equal(
                aux["secs"].numpy(), history[it]["secs"], err_msg=f"iteration {it}"
            )
            it += 1
        tsecs = teng.pop_frame_secs(state, tcfg)
    assert it == len(history)
    np.testing.assert_array_equal(tsecs.numpy(), np.asarray(jsecs))
    np.testing.assert_array_equal(state.remaining.numpy(), np.asarray(jfinal.remaining))
    np.testing.assert_allclose(state.scores.numpy(), np.asarray(jfinal.scores), atol=score_atol)
    return verified


def test_search_matches_reference_exactly(pair):
    _search_both(pair, seed=3)


def test_quantized_reduced_verify_search_matches_reference_exactly(pair):
    """detector_quant='int8' with verification at 48 pixels: the int8 tower
    scores the grids and the resized int8 tower the verifications.  Scores
    within 1e-2: in some of the ~20 forwards a ~1e-7 float difference moves
    an activation across an int8 rounding boundary (one quantization step,
    see ``tests/test_torch_quant.py``), which moves that forward's
    confidences by up to ~1e-2 (6.1e-3 seen); the sampled seconds and the
    keyframes stay equal."""
    verified = _search_both(
        pair, seed=3, score_atol=1e-2, detector_quant="int8", verify_image_size=48
    )
    assert verified, "the search never verified: the 48-pixel tower did not run"


def test_keyframe_searcher_facade():
    """initialize_heuristic + KeyframeSearcher.search() over an in-memory
    video: eight sorted timestamps in range, frames at native size."""
    heur = initialize_heuristic(
        "owl-vit-random", device="cpu", dtype=torch.float32, model_config=tiny_pair(tow), seed=1
    )
    assert isinstance(heur, OwlVitHeuristic)
    dec = default_scene(300.0, hw=(72, 128))
    searcher = KeyframeSearcher(
        "mem://scene", heur, TARGETS, CUES, search_budget=0.5,
        config=TSearchConfig(cache_hw=(32, 64)), seed=0, decoder=dec,
    )
    frames, stamps = searcher.search()
    assert len(frames) == len(stamps) == 8
    assert stamps == sorted(stamps) and 0 <= stamps[0] and stamps[-1] < 300
    assert frames[0].shape == (72, 128, 3)
    assert np.isfinite(searcher.score_distribution).all()
    assert searcher._final_state.iteration >= 1
    with pytest.raises(ValueError):
        initialize_heuristic("owl-vit")


PORT_MODULES = [
    "tstar_tpu_torch", "tstar_tpu_torch.utils", "tstar_tpu_torch.utils.config",
    "tstar_tpu_torch.ops", "tstar_tpu_torch.ops.quant", "tstar_tpu_torch.search",
    "tstar_tpu_torch.search.detector_scorer", "tstar_tpu_torch.search.searcher",
    "tstar_tpu_torch.kernels", "tstar_tpu_torch.kernels.attention",
    "tstar_tpu_torch.kernels.patch_matmul", "tstar_tpu_torch.kernels.layernorm",
    "tstar_tpu_torch.kernels.quant_matmul", "tstar_tpu_torch.kernels.ln_matmul",
    "tstar_tpu_torch.kernels.image", "tstar_tpu_torch.kernels._build",
    "tstar_tpu_torch.kernels.grid_embed", "tstar_tpu_torch.kernels.pallas_grid",
    "tstar_tpu_torch.models", "tstar_tpu_torch.models.transformer",
    "tstar_tpu_torch.models.owlvit_quant", "tstar_tpu_torch.video",
    "tstar_tpu_torch.framework", "tstar_tpu_torch.tools.profile_search",
    "tstar_tpu_torch.search.step_graphs", "tstar_tpu_torch.parallel",
    "tstar_tpu_torch.parallel.batched", "tstar_tpu_torch.parallel.multi_video", "chip_smoke",
    "tstar_tpu_torch.models.siglip", "tstar_tpu_torch.models.qwen2vl",
    "tstar_tpu_torch.models.llava_onevision", "tstar_tpu_torch.models.generate",
    "tstar_tpu_torch.models.qwen_tokenizer", "tstar_tpu_torch.models.qwen2vl_processor",
    "tstar_tpu_torch.models.loader", "tstar_tpu_torch.models.convert",
    "tstar_tpu_torch.grounding", "tstar_tpu_torch.grounding.vlm_backend",
    "tstar_tpu_torch.utils.images", "tstar_tpu_torch.tools.profile_vlm",
    "tstar_tpu_torch.ops.nms", "tstar_tpu_torch.kernels.nms", "tstar_tpu_torch.models.clip_tokenizer",
    "tstar_tpu_torch.models.yoloworld", "tstar_tpu_torch.models.yolo_loader",
    "tstar_tpu_torch.search.yolo_scorer", "tstar_tpu_torch.framework.heuristics",
    "tstar_tpu_torch.framework.framework", "tstar_tpu_torch.search.snapshot",
    "tstar_tpu_torch.grounding.openai_backend", "tstar_tpu_torch.utils.profiling",
    "tstar_tpu_torch.viz", "tstar_tpu_torch.viz.artifacts", "tstar_tpu_torch.viz.boxes",
    "tstar_tpu_torch.cli", "tstar_tpu_torch.cli.demo", "tstar_tpu_torch.video.decoder",
    "tstar_tpu_torch.search.reference_verify", "tstar_tpu_torch.bench",
    "tstar_tpu_torch.bench.metrics", "tstar_tpu_torch.bench.datasets",
    "tstar_tpu_torch.bench.evaluate", "tstar_tpu_torch.bench.runner",
    "tstar_tpu_torch.cli.dataset", "tstar_tpu_torch.cli.evaluate",
]


def test_port_imports_no_jax():
    """The port package, every slice module and ``chip_smoke`` (imported, not
    run) load without JAX, flax, triton, any module of the JAX package, or
    the packages the card's machine lacks (regex, cv2, safetensors,
    transformers, torchvision, mmcv; PIL, matplotlib, imageio and openai,
    which the artifact sinks and the OpenAI backend import when called)."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'triton', 'tstar_tpu', 'regex',\n"
        "       'cv2', 'safetensors', 'transformers', 'torchvision', 'mmcv', 'PIL',\n"
        "       'matplotlib', 'imageio', 'openai')\n"
        "       or m.startswith('tstar_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_port_sources_name_no_reference_module():
    """No ``import`` or ``from`` in ``tstar_tpu_torch/`` or ``chip_smoke.py``
    names ``tstar_tpu`` or a module under it, at any depth of the code."""
    files = sorted(Path(REPO, "tstar_tpu_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]
    assert len(files) > 20
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if n == "tstar_tpu" or n.startswith("tstar_tpu.")]
    assert not bad, bad
