"""Slice 1 of the port as a whole: detector scorer, frame cache, searcher.

The slice test drives the reference and the port over the same synthetic
frame cache, with the same tiny OWL-ViT weights (``params_from_jax``) and
the same Gumbel noise (the reference key schedule's draws, replayed).  The
sampled seconds of every iteration and the final keyframes must be EQUAL;
final scores agree to 1e-5 (float32 detector confidences, ~1e-6 apart after
the towers, then written and splatted unchanged).
"""

import dataclasses
import os
import subprocess
import sys

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
from tstar_tpu.utils.config import SearchConfig
from tstar_tpu.video import cache as jcache
from tstar_tpu_torch.framework.heuristics import OwlVitHeuristic, initialize_heuristic
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THash
from tstar_tpu_torch.search import detector_scorer as tds
from tstar_tpu_torch.search import engine as teng
from tstar_tpu_torch.search.searcher import KeyframeSearcher
from tstar_tpu_torch.search.state import init_state as tinit
from tstar_tpu_torch.video import cache as tcache
from tstar_tpu_torch.video.synthetic import default_scene

CFG = SearchConfig(search_budget=1.0, cache_hw=(32, 64))
TARGETS, CUES = ["couch", "lamp"], ["tv"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _scorers(pair):
    jmodel, variables, tmodel, host = pair
    js = jds.make_owlvit_scorer(
        jmodel, variables, jnp.asarray(host.frames), TARGETS, CUES, JHash(100, 8), CFG
    )
    ts = tds.make_owlvit_scorer(
        tmodel, torch.from_numpy(host.frames), TARGETS, CUES, THash(100, 8), CFG
    )
    return js, ts


def test_prompt_batch_matches():
    want = jds.build_prompt_batch(TARGETS, CUES, JHash(100, 8), CFG)
    got = tds.build_prompt_batch(TARGETS, CUES, THash(100, 8), CFG)
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


@pytest.mark.parametrize(
    "override",
    [
        {"detector_quant": "int8"},
        {"detector_quant": "w8a16"},
        {"verify_image_size": 32},
        {"use_pallas_preprocess": True},
    ],
)
def test_scorer_rejects_unported_options(pair, override):
    """Branches the port does not have raise instead of being ignored; the
    native verification size and an explicit False are the ported path."""
    tmodel, host = pair[2], pair[3]
    cache = torch.from_numpy(host.frames)
    with pytest.raises(NotImplementedError, match=next(iter(override))):
        tds.make_owlvit_scorer(
            tmodel, cache, TARGETS, CUES, THash(100, 8), dataclasses.replace(CFG, **override)
        )
    native = tmodel.cfg.vision.image_size
    ok = dataclasses.replace(CFG, verify_image_size=native, use_pallas_preprocess=False)
    assert tds.make_owlvit_scorer(tmodel, cache, TARGETS, CUES, THash(100, 8), ok).config is ok


def test_host_cache_matches_reference():
    """Same duck-typed decoder into both cache builders: identical frames.
    The port's probe reads the decoder, not the (fake) path."""
    want = jcache.build_frame_cache_host("unused", CFG, decoder=default_scene(200.0))
    got = tcache.build_frame_cache_host("unused", CFG, decoder=default_scene(200.0))
    np.testing.assert_array_equal(got.frames, want.frames)
    assert (got.n_valid, got.n_pad, got.raw_fps, got.duration) == (
        want.n_valid, want.n_pad, want.raw_fps, want.duration
    )
    dev = tcache.build_frame_cache("unused", CFG, device="cpu", decoder=default_scene(200.0))
    np.testing.assert_array_equal(dev.frames.numpy(), want.frames)
    assert tcache.fit_cache_hw((192, 384), 4096, 10 ** 8) == jcache.fit_cache_hw((192, 384), 4096, 10 ** 8)


def test_search_matches_reference_exactly(pair):
    js, ts = _scorers(pair)
    host = pair[3]
    seed = 3
    s0 = jinit(host.n_valid, len(TARGETS), CFG, jax.random.key(seed), n_pad=host.n_pad)
    jfinal, jsecs, history = jeng.run_search_with_history(s0, js, CFG)
    assert len(history) >= 5

    noise = iter(jax_noise(seed, host.n_pad, len(history)))
    state = tinit(host.n_valid, len(TARGETS), CFG, noise, n_pad=host.n_pad)
    it = 0
    with torch.no_grad():
        while teng._continue(state):
            state, aux = teng.search_step(state, ts, CFG)
            np.testing.assert_array_equal(
                aux["secs"].numpy(), history[it]["secs"], err_msg=f"iteration {it}"
            )
            it += 1
        tsecs = teng.pop_frame_secs(state, CFG)
    assert it == len(history)
    np.testing.assert_array_equal(tsecs.numpy(), np.asarray(jsecs))
    np.testing.assert_array_equal(state.remaining.numpy(), np.asarray(jfinal.remaining))
    np.testing.assert_allclose(state.scores.numpy(), np.asarray(jfinal.scores), atol=1e-5)


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
        config=dataclasses.replace(CFG, cache_hw=(32, 64)), seed=0, decoder=dec,
    )
    frames, stamps = searcher.search()
    assert len(frames) == len(stamps) == 8
    assert stamps == sorted(stamps) and 0 <= stamps[0] and stamps[-1] < 300
    assert frames[0].shape == (72, 128, 3)
    assert np.isfinite(searcher.score_distribution).all()
    assert searcher._final_state.iteration >= 1
    with pytest.raises(ValueError):
        initialize_heuristic("owl-vit")


def test_port_imports_no_jax():
    """The port package and every slice module load without JAX or flax."""
    modules = [
        "tstar_tpu_torch", "tstar_tpu_torch.ops", "tstar_tpu_torch.search",
        "tstar_tpu_torch.search.detector_scorer", "tstar_tpu_torch.search.searcher",
        "tstar_tpu_torch.kernels", "tstar_tpu_torch.kernels.attention",
        "tstar_tpu_torch.kernels.patch_matmul", "tstar_tpu_torch.kernels.layernorm",
        "tstar_tpu_torch.kernels.image", "tstar_tpu_torch.kernels._build",
        "tstar_tpu_torch.models", "tstar_tpu_torch.models.transformer",
        "tstar_tpu_torch.video", "tstar_tpu_torch.framework",
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'flax', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
