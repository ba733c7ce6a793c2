"""The port's YOLO-World v2 (``tstar_tpu_torch/models/yoloworld.py``, the
scorer and the heuristic) against the JAX package's, on the CPU in f32.

Each module of the detector (ConvBN at stride 1 and 2, Bottleneck,
CSPLayer, SPPF, MaxSigmoidAttnBlock with and without its embed conv,
MaxSigmoidCSPLayer) and the whole ``yoloworld_small`` detector at 160^2 run
on the same inputs with the reference's flax parameters
(``params_from_jax``): outputs within 1e-5 absolute + 1e-4 relative (f32
convolutions summed in another order), the boxes within 1e-4 pixels (a few
f32 ulps at the 160-pixel scale: a box edge is the anchor less a DFL
expectation times the stride, which cancels near 0).  ``postprocess_yolo`` on equal inputs gives equal
slots, classes, boxes and keep masks; its scores are sigmoids, which XLA
and PyTorch round apart in the last bit on ~0.4% of inputs, so they agree
to 2 f32 ulps.  The detector's folded BN scales are first set for unit
variance (``unit_variance_bn_``), on both sides the same: at the default
init every score is 0.5 within a few ulps.  The text encoder agrees to 1e-5.  The searches are in
``tests/test_torch_yolo_search.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu.models import owlvit as jow
from tstar_tpu.models import yoloworld as jy
from tstar_tpu.models.clip_tokenizer import HashTokenizer as JHash
from tstar_tpu_torch.framework.heuristics import YoloWorldHeuristic, initialize_heuristic
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import yoloworld as ty
from tstar_tpu_torch.models.owlvit import TextConfig as TTextConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file
    several-fold; its tiny shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 1e-5, 1e-4
BOX_ATOL = 1e-4
TEXT = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            max_length=8)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _flax_module(jmod, tmod, inputs, *extra):
    """Init ``jmod`` on ``inputs`` (NHWC), carry its parameters into ``tmod``;
    -> (flax output NHWC, port output NHWC)."""
    variables = jmod.init(jax.random.key(0), jnp.asarray(inputs), *extra)
    # nontrivial folded-BN affines, so the scale and bias are tested too
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + rng.normal(0, 0.2, x.shape).astype(np.float32)
                      if any(getattr(k, "key", "").startswith("bn_") or getattr(k, "key", "") == "bias"
                             for k in p) else x), variables["params"])
    variables = {"params": params}
    want = jmod.apply(variables, jnp.asarray(inputs), *extra)
    tmod.load_state_dict(ty.params_from_jax(variables), strict=True)
    targs = [torch.from_numpy(np.asarray(e)) for e in extra]
    with torch.no_grad():
        got = tmod(_nchw(inputs), *targs)
    return np.asarray(want), _nhwc(got)


def _pixels(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("c_in,c_out,k,s,act,hw", [
    (3, 8, 3, 2, True, 16), (8, 8, 3, 1, True, 9), (8, 16, 1, 1, False, 8), (4, 8, 3, 2, False, 7),
])
def test_convbn_matches_flax(c_in, c_out, k, s, act, hw):
    """Stride 2 pads as XLA's "SAME" (none before, one after on an even
    size), which is not mmyolo's symmetric padding."""
    want, got = _flax_module(jy.ConvBN(c_out, k, s, act), ty.ConvBN(c_in, c_out, k, s, act),
                             _pixels((2, hw, hw, c_in)))
    _close(torch.from_numpy(got), want)


@pytest.mark.parametrize("name", ["bottleneck", "csp", "csp_no_shortcut", "sppf"])
def test_backbone_modules_match_flax(name):
    x = _pixels((2, 12, 12, 16))
    jmod, tmod = {
        "bottleneck": (jy.Bottleneck(16), ty.Bottleneck(16)),
        "csp": (jy.CSPLayer(32, 2), ty.CSPLayer(16, 32, 2)),
        "csp_no_shortcut": (jy.CSPLayer(16, 1, shortcut=False), ty.CSPLayer(16, 16, 1, False)),
        "sppf": (jy.SPPF(16), ty.SPPF(16)),
    }[name]
    want, got = _flax_module(jmod, tmod, x)
    _close(torch.from_numpy(got), want)


@pytest.mark.parametrize("embed", [8, 16])
def test_max_sigmoid_attn_block_matches_flax(embed):
    """embed 16 != c_in 8: the embed conv runs; 8: the input is the embedding."""
    x = _pixels((2, 10, 10, 8))
    guide = _pixels((5, 12), seed=2)
    want, got = _flax_module(jy.MaxSigmoidAttnBlock(8, embed, 4),
                             ty.MaxSigmoidAttnBlock(8, 8, 12, embed, 4), x, guide)
    _close(torch.from_numpy(got), want)


def test_max_sigmoid_csp_layer_matches_flax():
    x = _pixels((2, 8, 8, 24))
    guide = _pixels((3, 12), seed=3)
    want, got = _flax_module(jy.MaxSigmoidCSPLayer(16, 2, 8, 2),
                             ty.MaxSigmoidCSPLayer(24, 16, 2, 12, 8, 2), x, guide)
    _close(torch.from_numpy(got), want)


def _to_flax(state):
    """A ``YoloWorldDetector`` state dict -> the reference's flax variables
    (the inverse of ``params_from_jax``)."""
    params = {}
    for key, t in state.items():
        *path, leaf = key.split(".")
        arr = t.detach().float().numpy()
        if leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(arr, order="C")
    return {"params": params}


@pytest.fixture(scope="module")
def small():
    """yoloworld_small at 160^2 from a seeded init, its folded BN scales set
    for unit variance (``unit_variance_bn_``: seeded random convs
    shrink every score to 0.5 within a few ulps, where the class and NMS
    decisions are ties), the same parameters on both sides; and the
    reference's f32 outputs on two images."""
    jmodel = jy.YoloWorldDetector(jy.yoloworld_small(), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    px = rng.random((2, 160, 160, 3), dtype=np.float32)
    text = rng.normal(size=(5, 64)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    # the port's seeded init (flax's initializer families), carried to flax:
    # tracing and compiling the reference's init costs ~10 s of XLA here
    tmodel = ty.init_params(ty.YoloWorldDetector(ty.yoloworld_small()), 0)
    tmodel.requires_grad_(False)
    ty.unit_variance_bn_(tmodel, torch.from_numpy(px), torch.from_numpy(text))
    variables = _to_flax(tmodel.state_dict())
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(px), jnp.asarray(text))
    return jmodel, variables, tmodel, px, text, [np.asarray(w) for w in want]


def test_unit_variance_bn_spreads_the_scores(small):
    """The calibrated model's scores are ~1e-4 apart (default init: all 0.5
    within a few ulps)."""
    *_, (jl, _) = small
    scores = np.sort(1 / (1 + np.exp(-jl.max(-1))), axis=-1)
    assert np.median(np.diff(scores, axis=-1)) > 1e-5


@pytest.mark.parametrize("memory_format", ["contiguous", "channels_last"])
def test_detector_matches_flax(small, memory_format):
    _, _, tmodel, px, text, (jl, jb) = small
    if memory_format == "channels_last":
        tmodel = ty.YoloWorldDetector(tmodel.cfg)
        tmodel.load_state_dict(small[2].state_dict())
        tmodel = tmodel.to(memory_format=torch.channels_last)
    with torch.no_grad():
        tl, tb = tmodel(torch.from_numpy(px), torch.from_numpy(text))
    assert tl.shape == (2, 525, 5) and tb.shape == (2, 525, 4)
    assert tl.dtype == tb.dtype == torch.float32
    _close(tl, jl)
    _close(tb, jb, atol=BOX_ATOL)


def test_detector_per_image_text_equals_shared(small):
    """(B, T, D) text, one set an image, gives each image what a shared set
    gives it (the stacked scorer's flat forward)."""
    _, _, tmodel, px, text, _ = small
    other = np.roll(text, 1, axis=0)
    with torch.no_grad():
        per = tmodel(torch.from_numpy(px), torch.from_numpy(np.stack([text, other])))
        a = tmodel(torch.from_numpy(px[:1]), torch.from_numpy(text))
        b = tmodel(torch.from_numpy(px[1:]), torch.from_numpy(other))
    _close(per[0], torch.cat([a[0], b[0]]).numpy())
    _close(per[1], torch.cat([a[1], b[1]]).numpy(), atol=BOX_ATOL)


def test_postprocess_matches_reference(small):
    _, _, _, _, _, (jl, jb) = small
    # logits shifted so that ~3% of the anchors clear the 0.12 threshold
    # (logit -1.99): fewer survivors than slots, so some slots are invalid
    logits = jl / np.abs(jl).max() * 3.0
    logits = (logits - np.quantile(logits[..., :3].max(-1), 0.97) - 1.99).astype(np.float32)
    mask = np.array([1, 1, 1, 0, 0], bool)
    want = jy.postprocess_yolo(jnp.asarray(logits), jnp.asarray(jb), jnp.asarray(mask),
                               0.12, 0.7, 50)
    got = ty.postprocess_yolo(torch.from_numpy(logits), torch.from_numpy(jb),
                              torch.from_numpy(mask), 0.12, 0.7, 50)
    scores_w, cls_w, boxes_w, keep_w = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[3].numpy(), keep_w)
    np.testing.assert_array_equal(got[1].numpy(), cls_w)
    np.testing.assert_array_equal(got[2].numpy(), boxes_w)
    assert keep_w.sum() > 0 and (~keep_w).sum() > 0
    np.testing.assert_array_max_ulp(got[0].numpy(), scores_w, maxulp=2)


def test_text_encoder_matches_flax():
    jcfg = jow.TextConfig(**TEXT)
    jenc = jy.YoloTextEncoder(jcfg, projection_dim=64, dtype=jnp.float32)
    ids, mask = JHash(100, 8).encode_batch(["couch", "floor lamp", "tv", " "])
    variables = jenc.init(jax.random.key(1), jnp.asarray(ids), jnp.asarray(mask))
    want = jenc.apply(variables, jnp.asarray(ids), jnp.asarray(mask))
    tenc = ty.YoloTextEncoder(TTextConfig(**TEXT), projection_dim=64)
    tenc.load_state_dict(tow.params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = tenc(torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, want)
    assert ty.text_config_from_state(tenc.state_dict()).num_layers == 2


def test_random_heuristic_sizes_and_dispatch():
    h = initialize_heuristic("yolo-world-random", size="small", device="cpu", dtype=torch.float32)
    assert h.name == "yolo-world" and h.model.cfg == ty.yoloworld_small()
    assert h.text_model.text_cfg.num_layers == 2
    assert h.model.contrast0_bn_scale.dtype == torch.float32
    with pytest.raises(ValueError, match="yolo-world-random"):
        initialize_heuristic("yolo-world", size="small", device="cpu")
    with pytest.raises(ValueError, match="xl | small"):
        YoloWorldHeuristic(size="medium", device="cpu")
    bf = initialize_heuristic("yolo-world-random", size="small", device="cpu")
    assert bf.model.dtype == torch.bfloat16 and bf.model.contrast2_logit_scale.dtype == torch.float32


def test_compat_surface_matches_scorer_path():
    """reparameterize_object_list / inference_detector: the reference's
    prompts (targets, cues, ' ') and boxes clipped to the image."""
    h = initialize_heuristic("yolo-world-random", size="small", device="cpu", dtype=torch.float32)
    h.reparameterize_object_list(["couch"], ["tv"])
    assert h.texts == [["couch"], ["tv"], [" "]]
    img = np.random.default_rng(0).integers(0, 256, (120, 200, 3), dtype=np.uint8)
    out = h.inference_detector([img, img[:60]])
    assert len(out) == 2
    for det, (hh, ww) in zip(out, ((120, 200), (60, 200))):
        assert det["xyxy"].shape[1] == 4 and len(det["confidence"]) == len(det["class_id"])
        assert (det["xyxy"] >= 0).all() and (det["xyxy"][:, [0, 2]] <= ww).all()
        assert (det["xyxy"][:, [1, 3]] <= hh).all() and (det["confidence"] > 0.12).all()
