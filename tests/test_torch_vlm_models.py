"""The port's VLM modules against the JAX reference in f32, on one set of
numpy-made weights carried across by ``params_from_jax``: SigLIP, the
Qwen2-VL vision tower, the Qwen2 decoder layer with and without a KV cache,
the Qwen2-VL forward with an image and the LLaVA-OneVision forward with a
video; the HF name tables (a converted checkpoint equals the reference's
conversion, and exports back to the same tensors).

Tolerance: |port - reference| <= 1e-4 * max(1, |reference|) everywhere: f32
differs from XLA by summation order and by the last bits of cos / sin /
exp / tanh, over a few tiny layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu.models import llava_onevision as jllava
from tstar_tpu.models import qwen2vl as jqwen
from tstar_tpu.models import siglip as jsiglip
from tstar_tpu_torch.models import llava_onevision as tllava
from tstar_tpu_torch.models import qwen2vl as tqwen
from tstar_tpu_torch.models import siglip as tsiglip
from tstar_tpu_torch.models.convert import export_state_dict

IMG_TOK, VID_TOK = 151, 152

QWEN_VISION = dict(depth=2, embed_dim=16, num_heads=2, mlp_ratio=2.0, patch_size=2,
                   temporal_patch_size=1, spatial_merge_size=2, hidden_size=32)
QWEN_TEXT = dict(vocab_size=200, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                 intermediate_size=64, rope_theta=10000.0, mrope_section=(1, 1, 2),
                 tie_word_embeddings=False, rms_norm_eps=1e-5)
SIGLIP = dict(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32, patch_size=2,
              image_size=8)
LLAVA_TEXT = dict(QWEN_TEXT, mrope_section=(4, 0, 0), rms_norm_eps=1e-6)


def qwen_cfgs():
    j = jqwen.Qwen2VLConfig(vision=jqwen.Qwen2VLVisionConfig(**QWEN_VISION),
                            text=jqwen.Qwen2VLTextConfig(**QWEN_TEXT),
                            image_token_id=IMG_TOK, video_token_id=VID_TOK, vision_start_token_id=150)
    t = tqwen.Qwen2VLConfig(vision=tqwen.Qwen2VLVisionConfig(**QWEN_VISION),
                            text=tqwen.Qwen2VLTextConfig(**QWEN_TEXT),
                            image_token_id=IMG_TOK, video_token_id=VID_TOK, vision_start_token_id=150)
    return j, t


def llava_cfgs():
    j = jllava.LlavaOnevisionConfig(vision=jsiglip.SiglipVisionConfig(**SIGLIP),
                                    text=jqwen.Qwen2VLTextConfig(**LLAVA_TEXT),
                                    image_token_id=IMG_TOK, video_token_id=VID_TOK)
    t = tllava.LlavaOnevisionConfig(vision=tsiglip.SiglipVisionConfig(**SIGLIP),
                                    text=tqwen.Qwen2VLTextConfig(**LLAVA_TEXT),
                                    image_token_id=IMG_TOK, video_token_id=VID_TOK)
    return j, t


def numpy_variables(module, seed, *args, method=None):
    """``module``'s flax variables with every leaf drawn from numpy: kernels
    N(0, 1/fan_in), embeddings N(0, 1), norm scales 1 + N(0, 0.1^2), the
    rest N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, method=method))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "embedding" in name:
            return rng.normal(size=leaf.shape).astype(np.float32)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_module(cls, cfg, variables):
    m = cls(cfg)
    m.load_state_dict(tqwen.params_from_jax(variables), strict=True)
    return m.requires_grad_(False).eval()


def assert_close(got, want):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    bound = 1e-4 * np.maximum(1.0, np.abs(want))
    diff = np.abs(got - want)
    assert np.isfinite(got).all() and (diff <= bound).all(), float((diff - bound).max())


# ---------------------------------------------------------------------------
# fixtures: one model of each family, both packages, one set of weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = qwen_cfgs()
    jmodel = jqwen.Qwen2VLModel(jcfg, dtype=jnp.float32)
    ids = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.zeros((3, 1, 8), jnp.int32)
    patches = jnp.zeros((1, 16, 12), jnp.float32)
    variables = numpy_variables(jmodel, 0, ids, pos, None, patches, (4, 4))
    return jcfg, jmodel, variables, port_module(tqwen.Qwen2VLModel, tcfg, variables)


@pytest.fixture(scope="module")
def llava():
    jcfg, tcfg = llava_cfgs()
    jmodel = jllava.LlavaOnevisionModel(jcfg, dtype=jnp.float32)
    n = 2 * jcfg.tokens_per_frame + 1
    ids = jnp.zeros((1, n + 3), jnp.int32)
    pos = jnp.zeros((3, 1, n + 3), jnp.int32)
    frames = jnp.zeros((2, 8, 8, 3), jnp.float32)
    variables = numpy_variables(jmodel, 1, ids, pos, None, frames)
    return jcfg, jmodel, variables, port_module(tllava.LlavaOnevisionModel, tcfg, variables)


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feature_layer", [-1, -2, 1])
def test_siglip_tower_matches_reference(llava, feature_layer):
    jcfg, _, variables, tmodel = llava
    pixels = np.random.default_rng(2).normal(size=(3, 9, 9, 3)).astype(np.float32)  # 9: VALID drops a row
    tower = jsiglip.SiglipVisionTower(jcfg.vision, dtype=jnp.float32)
    want = tower.apply({"params": variables["params"]["vision_tower"]}, jnp.asarray(pixels),
                       feature_layer)
    got = tmodel.vision_tower(torch.from_numpy(pixels), feature_layer)
    assert_close(got, want)


def test_siglip_runs_no_post_layernorm(llava, monkeypatch):
    """Two LayerNorms a layer, none after the last (the reference computes
    post_layernorm and drops it)."""
    from tstar_tpu_torch.models import transformer

    _, _, _, tmodel = llava
    calls = []
    real = transformer.apply_layernorm
    monkeypatch.setattr(transformer, "apply_layernorm", lambda *a: calls.append(1) or real(*a))
    tmodel.vision_tower(torch.zeros(1, 8, 8, 3))
    assert len(calls) == 2 * len(tmodel.vision_tower.layers)


def test_qwen2vl_vision_tower_matches_reference(qwen):
    jcfg, _, variables, tmodel = qwen
    patches = np.random.default_rng(3).normal(size=(2, 32, 12)).astype(np.float32)
    tower = jqwen.Qwen2VLVisionTower(jcfg.vision, dtype=jnp.float32)
    want = jax.vmap(lambda p: tower.apply({"params": variables["params"]["visual"]}, p, (4, 8)))(
        jnp.asarray(patches))
    assert_close(tmodel.encode_images(torch.from_numpy(patches), (4, 8)), want)


# ---------------------------------------------------------------------------
# decoder layer
# ---------------------------------------------------------------------------

def _layer_inputs(cfg, b, s, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, cfg.hidden_size)).astype(np.float32)
    pos = rng.integers(0, 50, size=(3, b, s)).astype(np.int32)
    bias = np.where(rng.random((b, 1, s, m)) < 0.3, np.finfo(np.float32).min, 0.0).astype(np.float32)
    bias[..., 0] = 0.0
    return x, pos, bias


@pytest.mark.parametrize("cached", [False, True])
def test_decoder_layer_matches_reference(qwen, cached):
    jcfg, _, variables, tmodel = qwen
    t = jcfg.text
    b, s, m = 2, 5, 12
    x, pos, bias = _layer_inputs(t, b, s, m if cached else s, 4)
    cos, sin = jqwen.mrope_cos_sin(jnp.asarray(pos), t.head_dim, t.mrope_section, t.rope_theta)
    layer = jqwen.Qwen2DecoderLayer(t, dtype=jnp.float32)
    lvars = {"params": variables["params"]["layers_1"]}
    tlayer = tmodel.layers[1]
    tcos, tsin = tqwen.mrope_cos_sin(torch.from_numpy(pos), t.head_dim, t.mrope_section, t.rope_theta)
    assert_close(tcos, cos)
    if not cached:
        want, _ = layer.apply(lvars, jnp.asarray(x), cos, sin, jnp.asarray(bias))
        got, _ = tlayer(torch.from_numpy(x), tcos, tsin, torch.from_numpy(bias))
        assert_close(got, want)
        return
    rng = np.random.default_rng(5)
    kv = [rng.normal(size=(b, m, t.num_kv_heads, t.head_dim)).astype(np.float32) for _ in range(2)]
    want, (jk, jv) = layer.apply(lvars, jnp.asarray(x), cos, sin, jnp.asarray(bias),
                                 (jnp.asarray(kv[0]), jnp.asarray(kv[1])), jnp.asarray(3))
    cache = (torch.from_numpy(kv[0].copy()), torch.from_numpy(kv[1].copy()))
    got, _ = tlayer(torch.from_numpy(x), tcos, tsin, torch.from_numpy(bias), cache, torch.tensor(3))
    assert_close(got, want)
    assert_close(cache[0], jk)          # written in place at slots 3..7
    assert_close(cache[1], jv)


# ---------------------------------------------------------------------------
# whole forwards
# ---------------------------------------------------------------------------

def test_qwen2vl_forward_with_image_matches_reference(qwen):
    jcfg, jmodel, variables, tmodel = qwen
    rng = np.random.default_rng(6)
    patches = rng.normal(size=(1, 16, 12)).astype(np.float32)
    ids = np.array([[5, 150] + [IMG_TOK] * 4 + [7, 9, 11]], np.int32)
    pos = jqwen.build_mrope_position_ids(ids[0], IMG_TOK, [(1, 4, 4)], 2)[:, None]
    np.testing.assert_array_equal(tqwen.build_mrope_position_ids(ids[0], IMG_TOK, [(1, 4, 4)], 2)[:, None], pos)
    mask = np.ones_like(ids)
    mask[0, -1] = 0
    want = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(mask),
                        jnp.asarray(patches), (4, 4))
    got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(pos), torch.from_numpy(mask),
                 torch.from_numpy(patches), (4, 4))
    assert_close(got, want)


def test_llava_forward_with_video_matches_reference(llava):
    jcfg, jmodel, variables, tmodel = llava
    rng = np.random.default_rng(7)
    frames = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    n = 2 * jcfg.tokens_per_frame + 1
    ids = np.array([[5, 6] + [VID_TOK] * n + [7, 9]], np.int32)
    pos = jqwen.build_mrope_position_ids(ids[0], -1, [], 2)[:, None]
    want = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(pos), None, jnp.asarray(frames))
    got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(pos), None, torch.from_numpy(frames))
    assert_close(got, want)
    want_enc = jmodel.apply(variables, jnp.asarray(frames), method=jmodel.encode_images)
    assert_close(tmodel.encode_images(torch.from_numpy(frames)), want_enc)


# ---------------------------------------------------------------------------
# HF name tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["qwen", "llava"])
def test_hf_conversion_matches_reference(qwen, llava, family):
    """The port's state dict, exported under HF names, converts back to
    itself and, through the reference's converter, to the same weights."""
    jcfg, _, variables, tmodel = qwen if family == "qwen" else llava
    if family == "qwen":
        rules, convert, jconvert = (tqwen.qwen2vl_rules(tmodel.cfg), tqwen.convert_hf_qwen2vl_state_dict,
                                    jqwen.convert_hf_qwen2vl_state_dict)
    else:
        rules, convert, jconvert = (tllava.llava_rules(tmodel.cfg),
                                    tllava.convert_hf_llava_onevision_state_dict,
                                    jllava.convert_hf_llava_onevision_state_dict)
    state = tmodel.state_dict()
    hf = export_state_dict(state, rules)
    back = convert(hf, tmodel.cfg)
    assert back.keys() == state.keys()
    for k in state:
        assert torch.equal(back[k], state[k]), k
    ref = tqwen.params_from_jax(jconvert(hf, jcfg))
    assert ref.keys() == state.keys()
    for k in state:
        np.testing.assert_array_equal(ref[k].numpy(), state[k].numpy(), err_msg=k)
    if family == "llava":       # SigLIP's own converter: the tower's part of the table
        tower = tsiglip.convert_hf_siglip(hf, tmodel.cfg.vision, "model.vision_tower.vision_model.")
        assert tower.keys() == {k[len("vision_tower."):] for k in state if k.startswith("vision_tower.")}
        for k, v in tower.items():
            assert torch.equal(v, state["vision_tower." + k]), k


def test_qwen25_config_loads_as_the_reference_reads_it():
    """A Qwen2.5-VL ``config.json`` (here only its model type and window)
    reads as the reference reads it: the Qwen2.5 tower's config with
    Qwen2.5-VL-7B's defaults, and a ``Qwen2VLModel`` of it holds that tower
    (``tests/test_torch_qwen25vl.py`` holds the tower and the loader)."""
    import dataclasses

    from tstar_tpu.models.loader import qwen2vl_config_from_hf_json as jread
    from tstar_tpu_torch.models.loader import qwen2vl_config_from_hf_json
    from tstar_tpu_torch.models.qwen25_vision import Qwen25VisionConfig, Qwen25VisionTower

    hf = {"model_type": "qwen2_5_vl", "vision_config": {"window_size": 112}}
    cfg = qwen2vl_config_from_hf_json(hf)
    assert isinstance(cfg.vision, Qwen25VisionConfig) and cfg.vision.window_size == 112
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jread(hf))
    with torch.device("meta"):
        assert isinstance(tqwen.Qwen2VLModel(cfg).visual, Qwen25VisionTower)


# ---------------------------------------------------------------------------
# LLaVA-OneVision's anyres single-image path
# ---------------------------------------------------------------------------

PINPOINTS = [[8, 8], [8, 16], [16, 8], [16, 16], [8, 24], [24, 16]]


def test_select_best_resolution_matches_reference():
    rng = np.random.default_rng(11)
    for _ in range(200):
        hw = tuple(int(v) for v in rng.integers(1, 60, 2))
        pins = [list(map(int, p)) for p in rng.integers(1, 8, (int(rng.integers(1, 6)), 2)) * 8]
        assert tllava.select_best_resolution(hw, pins) == jllava.select_best_resolution(hw, pins)


@pytest.mark.parametrize("hw", [(10, 30), (21, 10), (37, 50), (8, 8)])
def test_preprocess_anyres_image_matches_reference(llava, hw):
    """The same pinpoint, grid and image size; tiles within one uint8 step
    before normalization (2 / 255 after it): ``resize_cubic`` is 1 off
    cv2's bicubic on a few values (``tests/test_torch_vlm_preprocess.py``),
    the zero padding lands in the same place."""
    jcfg, _, _, tmodel = llava
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), np.uint8)
    got, got_size, got_grid = tllava.preprocess_anyres_image(img, tmodel.cfg, PINPOINTS)
    want, want_size, want_grid = jllava.preprocess_anyres_image(img, jcfg, PINPOINTS)
    assert (got_size, got_grid) == (want_size, want_grid) == (hw, got_grid)
    assert got.shape == want.shape == (1 + got_grid[0] * got_grid[1], 8, 8, 3)
    assert np.abs(got - want).max() <= 2 / 255 + 1e-6


@pytest.mark.parametrize("hw, grid, max_patches", [
    ((8, 16), (1, 2), 9),      # the canvas's own aspect: nothing to unpad
    ((4, 16), (1, 2), 9),      # wider than the canvas: rows cropped
    ((20, 9), (3, 1), 9),      # taller: columns cropped
    ((16, 16), (2, 2), 1),     # above the token budget: downscaled
])
def test_encode_anyres_image_matches_reference(llava, hw, grid, max_patches):
    jcfg, jmodel, variables, tmodel = llava
    n = 1 + grid[0] * grid[1]
    tiles = np.random.default_rng(n).normal(size=(n, 8, 8, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(tiles), hw, grid, max_patches,
                        method=jllava.LlavaOnevisionModel.encode_anyres_image)
    got = tmodel.encode_anyres_image(torch.from_numpy(tiles), hw, grid, max_patches)
    assert_close(got, want)

