"""The port's calibrated OWL-ViT detector (``owl-vit-calibrated``) and its
two A/B tools against the JAX package, on the CPU.

Both heuristics hold the same weights (the reference's, carried across by
``owlvit.params_from_jax``) at ``tests/test_knob_recall.py``'s pinned
geometry and calibration seed (S = 577: image 192, patch 8, 3 layers of
64), in f32.  The calibration runs each package's own forwards and the same
float64 host solve, so the directions agree to 1e-4 and every calibration
statistic and suggested threshold to 1e-5 (f32 scores, ~1e-6 apart).  A
calibrated search on the A/B's scenes, the port on the reference's replayed
Gumbel noise, samples the same seconds every step and returns the same
keyframes.
"""


import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import ab_knob_recall as jab
from tests.test_torch_engine import jax_noise
from tests.test_torch_owlvit import tiny_pair
from tstar_tpu.framework.heuristics import CalibratedOwlVitHeuristic as JCalibrated
from tstar_tpu.models import owlvit as jow
from tstar_tpu.search import engine as jeng
from tstar_tpu.search.state import init_state as jinit
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu_torch.framework.heuristics import (
    CalibratedOwlVitHeuristic,
    initialize_heuristic,
)
from tstar_tpu_torch.kernels.image import build_detector_grid
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.search import engine as teng
from tstar_tpu_torch.search.state import init_state as tinit
from tstar_tpu_torch.tools import ab_knob_recall, verify_ab
from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.video import cache as tcache

CAL_SEED = 2            # tests/test_knob_recall.py's pinned lottery winner
BASE = dict(search_budget=1.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slowed this file
    ~15-fold; these shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Compiled:
    """A flax module whose ``apply`` is compiled once per method and shape;
    the reference's calibration calls it eagerly, op by op (the same
    computation)."""

    def __init__(self, model):
        self.module = model
        self.apply = jax.jit(model.apply, static_argnames="method")

    def __getattr__(self, name):
        return getattr(self.module, name)


@pytest.fixture(scope="module")
def calibrated():
    """(reference heuristic, port heuristic), same weights, both calibrated
    for "couch" at the default cache size."""
    jcfg = JSearchConfig(**BASE)
    init = jow.OwlViTDetector.init
    with pytest.MonkeyPatch.context() as mp:     # the reference's init, compiled
        mp.setattr(jow.OwlViTDetector, "init",
                   lambda self, *a: jax.jit(functools.partial(init, self))(*a))
        jh = JCalibrated(dtype=jnp.float32, model_config=jab.model_config(), seed=CAL_SEED,
                         object_size=jab.OBJECT_SIZE)
    jh.model = _Compiled(jh.model)
    jh.calibrate(jcfg.cache_hw, ["couch"], [], jcfg)
    th = CalibratedOwlVitHeuristic(dtype=torch.float32, model_config=ab_knob_recall.model_config(),
                                   seed=CAL_SEED, object_size=ab_knob_recall.OBJECT_SIZE,
                                   device="cpu")
    th.model.load_state_dict(tow.params_from_jax(jh.variables), strict=True)
    cfg = SearchConfig(**BASE)
    th.calibrate(cfg.cache_hw, ["couch"], [], cfg)
    return jh, th


def test_tool_settings_are_the_reference_scripts():
    assert ab_knob_recall.GEOMETRY == jab.GEOMETRY
    assert (ab_knob_recall.DURATION, ab_knob_recall.EVENT_LEN, ab_knob_recall.OBJECT_SIZE) == (
        jab.DURATION, jab.EVENT_LEN, jab.OBJECT_SIZE)


def test_calibration_matches_reference(calibrated):
    jh, th = calibrated
    (jdirs,), (tdirs,) = jh._dir_cache.values(), th._dir_cache.values()
    assert jdirs.keys() == tdirs.keys() == {"couch"}
    np.testing.assert_allclose(tdirs["couch"], jdirs["couch"], atol=1e-4)
    assert th.calibration.keys() == jh.calibration.keys()
    for k, want in jh.calibration["couch"].items():
        assert abs(th.calibration["couch"][k] - want) <= 1e-5, (k, th.calibration["couch"][k], want)
    assert abs(th.suggested_detector_threshold - jh.suggested_detector_threshold) <= 1e-5
    assert abs(th.suggested_confidence_threshold - jh.suggested_confidence_threshold) <= 1e-5
    # the pinned seed gives a working detector (tests/test_knob_recall.py's bounds)
    assert min(th.calibration["couch"]["grid_margin"],
               th.calibration["couch"]["verify_margin"]) > 0.05


def test_probe_affine_is_exact_and_matches_reference(calibrated):
    """The +/- basis probes recover the exact logit of any query,
    ``A . q_hat + b``, and the reference's (A, b) on the same canvas."""
    jh, th = calibrated
    cfg = SearchConfig(**BASE)
    frame = th._render_cal_frame(cfg.cache_hw, (200, 40, 40), 3)
    size = th.model.cfg.vision.image_size
    pixels = build_detector_grid(torch.from_numpy(frame[None]), torch.zeros(16, dtype=torch.int64),
                                 (4, 4), size, dtype=torch.float32)
    a, b = th._probe_affine(pixels)
    ja, jb = jh._probe_affine(jnp.asarray(pixels.numpy()))
    np.testing.assert_allclose(a, ja, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b, jb, rtol=1e-4, atol=1e-4)
    q = np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)
    with torch.no_grad():
        logits, _ = th.model.predict(th.model.encode_image(pixels), torch.from_numpy(q)[None], None)
    np.testing.assert_allclose(a @ (q / np.linalg.norm(q)) + b, logits[0, :, 0].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scene", [0, 1])
def test_calibrated_search_matches_reference(calibrated, scene):
    """The A/B's scene ``scene`` searched with each package's calibrated
    scorer at the reference's suggested thresholds: every step's sampled
    seconds, the keyframes and the remaining targets equal (the port on the
    reference's replayed noise), and verification removed the target."""
    jh, th = calibrated
    kw = dict(BASE, detector_threshold=jh.suggested_detector_threshold,
              confidence_threshold=jh.suggested_confidence_threshold)
    jcfg, tcfg = JSearchConfig(**kw), SearchConfig(**kw)
    make_decoder, _ = ab_knob_recall.make_scenes(scene + 1)[scene]
    host = tcache.build_frame_cache_host("mem://scene", tcfg, decoder=make_decoder())
    js = jh.build_scorer(jnp.asarray(host.frames), ["couch"], [], jcfg)
    ts = th.build_scorer(torch.from_numpy(host.frames), ["couch"], [], tcfg)
    assert bool(ts.query_mask[0]) and not bool(ts.query_mask[1:].any())  # ' ' masked
    np.testing.assert_allclose(ts.query_embeds.numpy(), np.asarray(js.query_embeds), atol=1e-4)

    s0 = jinit(host.n_valid, 1, jcfg, jax.random.key(scene), n_pad=host.n_pad)
    jfinal, jsecs, history = jeng.run_search_with_history(s0, js, jcfg)
    state = tinit(host.n_valid, 1, tcfg, iter(jax_noise(scene, host.n_pad, len(history))),
                  n_pad=host.n_pad)
    it = 0
    with torch.no_grad():
        while teng._continue(state):
            state, aux = teng.search_step(state, ts, tcfg)
            np.testing.assert_array_equal(aux["secs"].numpy(), history[it]["secs"], f"step {it}")
            it += 1
        tsecs = teng.pop_frame_secs(state, tcfg)
    assert it == len(history)
    np.testing.assert_array_equal(tsecs.numpy(), np.asarray(jsecs))
    np.testing.assert_array_equal(state.remaining.numpy(), np.asarray(jfinal.remaining))
    assert not state.remaining.any()


def test_registry_name(monkeypatch):
    from tstar_tpu_torch.framework import heuristics

    monkeypatch.setattr(heuristics, "owlvit_base_patch32", lambda: tiny_pair(tow))
    h = initialize_heuristic("owl-vit-calibrated", device="cpu", seed=3,
                             color_map={"couch": (1, 2, 3)})
    assert isinstance(h, CalibratedOwlVitHeuristic) and h.name == "owl-vit-calibrated"
    assert h.color_map == {"couch": (1, 2, 3)} and h.model.dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="calibrate first"):
        h.suggested_confidence_threshold


def test_ab_knob_recall_runs(calibrated, monkeypatch, capsys):
    """The tool end to end on the CPU at one scene and one seed, every knob,
    one JSON line.  The lottery runs over two seeds: the port's seed 0, and
    as seed 1 the reference's pinned seed-2 weights (the port's seeded
    weights depend on torch's version, its ``trunc_normal_`` draws; those
    calibrate with both margins above 0.17), which win."""
    jh, _ = calibrated
    make = ab_knob_recall.calibrated_heuristic

    def heuristic(seed, device):
        h = make(seed, device)
        if seed == 1:
            h.model.load_state_dict(tow.params_from_jax(jh.variables))
        return h

    monkeypatch.setattr(ab_knob_recall, "calibrated_heuristic", heuristic)
    out = ab_knob_recall.main(["--scenes", "1", "--seeds", "1", "--cal-seeds", "2",
                               "--device", "cpu"])
    assert out["cal_seed"] == 1 and out["cal_min_margin"] > 0.17
    assert list(out["knobs"]) == ["bf16", "verify128", "verify96", "int8", "w8a16",
                                  "int8_verify128"]
    for knob, e in out["knobs"].items():
        assert 0.0 <= e["recall"] <= 1.0 and e["mean_iterations"] >= 1, knob
        assert "keyframe_overlap_vs_bf16" in e or knob == "bf16"
    assert out["knobs"]["bf16"]["recall_delta_vs_bf16"] == 0.0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("{") and '"knobs"' in last


def test_verify_ab_runs(monkeypatch, capsys, tmp_path):
    """The verification A/B at tiny widths on the CPU against the reference
    script itself (``scripts/verify_ab.py``'s ``main``): its videos served
    from the same in-memory decoders in place of its mp4 files, its
    heuristic the tiny detector whose weights the port carries, the port on
    its replayed Gumbel draws.  Every video's iterations, remaining
    targets, removal agreement, keyframe overlap and rescore count equal.
    The threshold (the script's default is 0.3, where this random detector
    removes the target at its first rescore) makes the fidelity chain
    rescore 19 frames over five steps."""
    THRESHOLD = 0.68
    from scripts import verify_ab as jva
    from tstar_tpu.framework import heuristics as jheur
    from tstar_tpu.video import cache as jvcache
    from tstar_tpu.video import decoder as jdecoder
    from tstar_tpu.video import synthetic as jsynth
    from tstar_tpu_torch.search import state as tstate
    from tstar_tpu_torch.video.synthetic import PlantedObject, SyntheticDecoder

    init = jow.OwlViTDetector.init
    with pytest.MonkeyPatch.context() as mp:     # the reference's init, compiled
        mp.setattr(jow.OwlViTDetector, "init",
                   lambda self, *a: jax.jit(functools.partial(init, self))(*a))
        jh = jheur.OwlVitHeuristic(dtype=jnp.float32, seed=1, model_config=tiny_pair(jow))
    jh.model = _Compiled(jh.model)
    videos = {}

    def write(path, duration_sec, fps, hw, objects):
        objs = [PlantedObject(*dataclasses.astuple(o)) for o in objects]
        videos[path] = lambda: SyntheticDecoder(duration_sec, fps=fps, hw=hw, objects=objs)

    monkeypatch.setattr(jsynth, "write_synthetic_video", write)
    monkeypatch.setattr(jvcache, "open_video", lambda path: videos[path]())
    monkeypatch.setattr(jdecoder, "open_video", lambda path: videos[path]())
    monkeypatch.setattr(jheur, "initialize_heuristic", lambda name, **kw: jh)
    monkeypatch.setattr(jva.tempfile, "mkdtemp", lambda **kw: str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["verify_ab.py", "--videos", "2", "--duration", "60",
                                      "--confidence_threshold", str(THRESHOLD)])
    jva.main()
    want = json.loads(capsys.readouterr().out)

    th = initialize_heuristic("owl-vit-random", device="cpu", dtype=torch.float32,
                             model_config=tiny_pair(tow), seed=1)
    th.model.load_state_dict(tow.params_from_jax(jh.variables), strict=True)
    # each video's two searches start from init_state: the cache's, then the fidelity chain's
    steps = iter([n for r in want["per_video"] for n in (r["iters_cache"], r["iters_reference"])])
    tinit_state = tstate.init_state

    def replayed(n_valid, n_targets, cfg, rng, **kw):
        noise = jax_noise(rng.initial_seed(), kw["n_pad"], next(steps))
        return tinit_state(n_valid, n_targets, cfg, iter(noise), **kw)

    monkeypatch.setattr(tstate, "init_state", replayed)
    got = verify_ab.run(th, videos=2, duration=60.0, confidence_threshold=THRESHOLD)
    assert got["per_video"] == want["per_video"]
    for key in ("videos", "removal_agreement", "mean_keyframe_overlap"):
        assert got[key] == want[key], key
    # a removal on the first step after two rescores, and one after four steps of them
    assert [(r["iters_reference"], r["reference_rescores"]) for r in got["per_video"]] == [
        (1, 2), (4, 17)]


def test_int8_at_the_ab_geometry_takes_the_plain_math(monkeypatch):
    """The A/B geometry's int8 tower (K = 64 / 128) is below K4's shapes:
    its route plan, fixed when the weights are quantized, puts all 12 dense
    layers in plain ops, which compute K4's math (here the same features
    as the wrapper's plain version).  ``dense_w8a8`` itself always calls
    the wrapper, which on a CUDA tensor launches K4 or raises."""
    from tstar_tpu_torch.models import owlvit_quant
    from tstar_tpu_torch.ops import quant

    model = tow.init_params(tow.OwlViTDetector(ab_knob_recall.model_config()), 0).eval()
    qp = owlvit_quant.quantize_vision_tower(model)
    assert owlvit_quant.route_counts(qp) == {"plain": 12}
    px = torch.rand(1, 192, 192, 3, generator=torch.Generator().manual_seed(0))
    real, calls = owlvit_quant.dense_w8a8, []

    def record(x, w, *a, **k):
        calls.append(tuple(w.shape))
        return real(x, w, *a, **k)

    monkeypatch.setattr(owlvit_quant, "dense_w8a8", record)
    forced = {**qp, "routes": tuple({k: "k4" for k in owlvit_quant.DENSE} for _ in qp["routes"])}
    with torch.no_grad():
        plain = owlvit_quant.encode_image_int8(qp, px, model.cfg, dtype=torch.float32)
        assert calls == []
        wrapped = owlvit_quant.encode_image_int8(forced, px, model.cfg, dtype=torch.float32)
    assert len(calls) == 12 and torch.equal(plain, wrapped)

    wrapper = []
    monkeypatch.setattr(quant, "w8a8_matmul", lambda *a, **k: wrapper.append(tuple(a[1].shape)))
    quant.dense_w8a8(torch.randn(5, 64), torch.zeros(64, 128, dtype=torch.int8),
                     torch.ones(128), None)
    assert wrapper == [(64, 128)]


def test_int8_tower_takes_k1_only_at_head_width_64(monkeypatch):
    """The int8 tower routes attention as the float tower does: K1 only at
    head width 64 (the A/B geometry's heads are 16 wide)."""
    from tstar_tpu_torch.models import owlvit_quant

    def refuse(*a, **k):
        raise AssertionError("K1 called at head width 16")

    monkeypatch.setattr(owlvit_quant, "fused_mha_from_qkv", refuse)
    model = tow.init_params(tow.OwlViTDetector(ab_knob_recall.model_config()), 0).eval()
    q = owlvit_quant.quantize_vision_tower(model)
    with torch.no_grad():
        feats = owlvit_quant.encode_image_int8(q, torch.rand(1, 192, 192, 3), model.cfg,
                                               dtype=torch.float32)
    assert feats.shape == (1, 576, 64) and torch.isfinite(feats).all()
