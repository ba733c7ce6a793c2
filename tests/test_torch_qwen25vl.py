"""The port's Qwen2.5-VL (``models/qwen25_vision.py`` under ``Qwen2VLModel``)
against the JAX package and against a tiny ``transformers``
``Qwen2_5_VLForConditionalGeneration`` built here, in f32: the window layout,
the vision tower, the multimodal forward, the HF name table, the config
reader and writer, and a checkpoint served through ``UniversalGrounder``.

The tiny model (``tests/test_qwen25vl.py``'s): an 8x8 patch grid with
windows of 8 px and patches of 2 px, so a 4x4-unit image splits into four
2x2-unit windows, block 1 attends globally.  Tolerances: against JAX, on
one set of weights, |port - reference| <= 1e-4 * max(1, |reference|) (the
bound of ``tests/test_torch_vlm_models.py``); against HF, 5e-4 absolute and
relative (the reference's own bound against HF: its attention runs SDPA
over the variable-length windows, summed in another order).
"""

import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vlm_backend import SPECIAL, TEXT, save, write_tokenizer
from tests.test_torch_vlm_models import assert_close
from tstar_tpu.grounding import universal as juniversal
from tstar_tpu.grounding.vlm_backend import JaxVLMBackend
from tstar_tpu.models import generate as jgen
from tstar_tpu.models import loader as jloader
from tstar_tpu.models import qwen2vl as jqwen
from tstar_tpu.models import qwen25_vision as jq25
from tstar_tpu_torch.grounding import universal as tuniversal
from tstar_tpu_torch.models import loader as tloader
from tstar_tpu_torch.models import qwen2vl as tqwen
from tstar_tpu_torch.models import qwen25_vision as tq25
from tstar_tpu_torch.models.convert import export_state_dict

transformers = pytest.importorskip("transformers")

IMG_TOK, VID_TOK, VSTART = 151, 152, 150
VISION = dict(depth=3, embed_dim=16, num_heads=2, intermediate_size=32, patch_size=2,
              temporal_patch_size=1, spatial_merge_size=2, hidden_size=32, window_size=8,
              fullatt_block_indexes=(1,))
TEXT_CFG = dict(vocab_size=200, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=64, rope_theta=10000.0, mrope_section=(1, 1, 2),
                tie_word_embeddings=False, rms_norm_eps=1e-5)


def cfgs():
    ids = dict(image_token_id=IMG_TOK, video_token_id=VID_TOK, vision_start_token_id=VSTART)
    j = jqwen.Qwen2VLConfig(vision=jq25.Qwen25VisionConfig(**VISION),
                            text=jqwen.Qwen2VLTextConfig(**TEXT_CFG), **ids)
    t = tqwen.Qwen2VLConfig(vision=tq25.Qwen25VisionConfig(**VISION),
                            text=tqwen.Qwen2VLTextConfig(**TEXT_CFG), **ids)
    return j, t


def hf_config(vision=None, text=None, **ids):
    return transformers.Qwen2_5_VLConfig(
        text_config=text or dict(
            vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=64, rope_theta=10000.0, rms_norm_eps=1e-5,
            rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]},
            max_position_embeddings=512, tie_word_embeddings=False),
        vision_config=vision or dict(
            depth=3, hidden_size=16, num_heads=2, intermediate_size=32, patch_size=2,
            temporal_patch_size=1, spatial_merge_size=2, in_chans=3, out_hidden_size=32,
            window_size=8, fullatt_block_indexes=[1]),
        **(ids or dict(image_token_id=IMG_TOK, video_token_id=VID_TOK,
                       vision_start_token_id=VSTART)),
    )


@pytest.fixture(scope="module")
def models():
    """(HF model, reference model + variables, port model), one set of
    weights: HF's, converted by each package's own converter."""
    torch.manual_seed(0)
    hf = transformers.Qwen2_5_VLForConditionalGeneration(hf_config()).eval()
    jcfg, tcfg = cfgs()
    sd = hf.state_dict()
    variables = jqwen.convert_hf_qwen2vl_state_dict(sd, jcfg)
    port = tqwen.Qwen2VLModel(tcfg)
    port.load_state_dict(tqwen.convert_hf_qwen2vl_state_dict(sd, tcfg), strict=True)
    return hf, jqwen.Qwen2VLModel(jcfg, dtype=jnp.float32), variables, port.requires_grad_(False).eval()


@pytest.mark.parametrize("grid", [(8, 8), (12, 8), (6, 10)])
def test_window_partition_matches_reference_and_hf(models, grid):
    """(6, 10): 3x5 units in windows of 2x2 units, padding units dropped."""
    hf = models[0]
    _, tcfg = cfgs()
    got_idx, got_seg = tq25.window_partition(*grid, tcfg.vision)
    want_idx, want_seg = jq25.window_partition(*grid, cfgs()[0].vision)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_seg, want_seg)
    hf_idx, hf_cu = hf.model.visual.get_window_index(torch.tensor([[1, *grid]]))
    np.testing.assert_array_equal(got_idx, hf_idx.numpy())
    got_cu = np.concatenate([[0], np.cumsum(np.bincount(got_seg))])
    np.testing.assert_array_equal(got_cu, np.unique(np.asarray(hf_cu)))


def test_weights_carry_across(models):
    """The reference's converted variables, through ``params_from_jax``, are
    the port's own conversion of the HF checkpoint, tensor for tensor."""
    _, _, variables, port = models
    want = tqwen.params_from_jax(variables)
    state = port.state_dict()
    assert want.keys() == state.keys()
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("grid", [(8, 8), (6, 10)])
def test_tower_matches_reference_and_hf(models, grid):
    hf, jmodel, variables, port = models
    n = grid[0] * grid[1]
    patches = np.random.default_rng(0).standard_normal((n, 12)).astype(np.float32)
    got = port.encode_images(torch.from_numpy(patches)[None], grid)[0]
    want = jmodel.apply(variables, jnp.asarray(patches)[None], grid,
                        method=jqwen.Qwen2VLModel.encode_images)[0]
    assert_close(got, want)
    with torch.no_grad():
        hf_out = hf.model.visual(torch.from_numpy(patches), grid_thw=torch.tensor([[1, *grid]]))
    np.testing.assert_allclose(got.numpy(), hf_out.numpy(), rtol=5e-4, atol=5e-4)


def test_multimodal_forward_matches_reference_and_hf(models):
    hf, jmodel, variables, port = models
    rng = np.random.default_rng(1)
    patches = rng.standard_normal((64, 12)).astype(np.float32)
    ids = np.array([[5, VSTART] + [IMG_TOK] * 16 + [7, 9]])
    pos = jqwen.build_mrope_position_ids(ids[0], IMG_TOK, [(1, 8, 8)], 2)[:, None]
    want = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(pos), None,
                        jnp.asarray(patches)[None], (8, 8))
    got = port(torch.from_numpy(ids), torch.from_numpy(pos), None,
               torch.from_numpy(patches)[None], (8, 8))
    assert_close(got, want)
    with torch.no_grad():
        hf_logits = hf(input_ids=torch.tensor(ids), pixel_values=torch.from_numpy(patches),
                       image_grid_thw=torch.tensor([[1, 8, 8]])).logits
    np.testing.assert_allclose(got.numpy(), hf_logits.numpy(), rtol=5e-4, atol=5e-4)


def test_hf_names_export_and_convert_back(models):
    """The port's state dict exported under HF's names is HF's own state dict
    (the table's first name for a vision tensor is ``visual.``, which HF
    loads as ``model.visual.``), and converts back to itself."""
    hf, _, _, port = models
    _, tcfg = cfgs()
    rules = tqwen.qwen2vl_rules(tcfg)
    exported = export_state_dict(port.state_dict(), rules)
    hf_sd = hf.state_dict()
    for k, v in exported.items():
        assert torch.equal(v, hf_sd[k] if k in hf_sd else hf_sd["model." + k]), k
    back = tqwen.convert_hf_qwen2vl_state_dict(exported, tcfg)
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())


def test_config_reader_and_writer_match_reference(models, tmp_path):
    """HF's ``config.json`` reads as the reference reads it; the port's
    writer gives a file both packages read back as the same config."""
    hf = models[0]
    hf_json = json.loads(hf.config.to_json_string())
    got = tloader.qwen2vl_config_from_hf_json(hf_json)
    want = jloader.qwen2vl_config_from_hf_json(hf_json)
    assert isinstance(got.vision, tq25.Qwen25VisionConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    written = tloader._hf_config(got)
    assert written["model_type"] == "qwen2_5_vl"
    assert tloader.qwen2vl_config_from_hf_json(written) == got
    assert dataclasses.asdict(jloader.qwen2vl_config_from_hf_json(written)) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny Qwen2.5-VL checkpoint as ``transformers`` writes one, with the
    300-token byte vocabulary of ``tests/test_torch_vlm_backend.py``."""
    d = tmp_path_factory.mktemp("qwen25_ckpt")
    text = dict(TEXT, rms_norm_eps=1e-5, rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]})
    cfg = hf_config(
        vision=dict(depth=2, hidden_size=16, num_heads=2, intermediate_size=32, patch_size=14,
                    temporal_patch_size=2, spatial_merge_size=2, in_chans=3, out_hidden_size=32,
                    window_size=56, fullatt_block_indexes=[1]),
        text=text, image_token_id=SPECIAL["<|image_pad|>"], video_token_id=SPECIAL["<|video_pad|>"],
        vision_start_token_id=SPECIAL["<|vision_start|>"])
    torch.manual_seed(0)
    save(transformers.Qwen2_5_VLForConditionalGeneration(cfg), d)
    hf_cfg = json.loads(cfg.to_json_string())
    hf_cfg["text_config"]["rope_scaling"] = {"type": "mrope", "mrope_section": [1, 1, 2]}
    (d / "config.json").write_text(json.dumps(hf_cfg))
    write_tokenizer(d)
    return d


def test_checkpoint_serves_through_the_grounder(checkpoint, tmp_path, monkeypatch):
    """``load_vlm_checkpoint`` reads a Qwen2.5-VL directory into the same
    weights as the reference's loader; ``UniversalGrounder(model_path=)``
    answers as the reference's grounder at temperature 0 (both f32); and a
    checkpoint the port writes loads back to the same weights."""
    model, tok = tloader.load_vlm_checkpoint(str(checkpoint), device="cpu", dtype=torch.float32)
    assert isinstance(model.visual, tq25.Qwen25VisionTower)
    _, variables, _ = jloader.load_vlm_checkpoint(str(checkpoint), dtype=jnp.float32)
    want = tqwen.params_from_jax(variables)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)

    # the reference's f32 model gets an f32 cache, as in test_torch_vlm_backend.py
    monkeypatch.setattr(jgen, "generate", functools.partial(jgen.generate, cache_dtype=jnp.float32))
    tg = tuniversal.UniversalGrounder("qwen2.5-vl-tiny", model_path=str(checkpoint),
                                      device="cpu", dtype=torch.float32)
    jg = juniversal.UniversalGrounder("qwen2.5-vl-tiny",
                                      backend=JaxVLMBackend(str(checkpoint), dtype=jnp.float32))
    tg.backend.max_pixels = jg.backend.max_pixels = 56 * 56
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (64, 80, 3), np.uint8) for _ in range(2)]
    answer = tg.inference_qa(frames, "What color?", "A) Red\nB) Blue", temperature=0.0)
    assert isinstance(answer, str) and answer
    assert answer == jg.inference_qa(frames, "What color?", "A) Red\nB) Blue", temperature=0.0)

    out = tmp_path / "written"
    tloader.save_vlm_checkpoint(model, str(out))
    write_tokenizer(out)
    again, _ = tloader.load_vlm_checkpoint(str(out), device="cpu", dtype=torch.float32)
    assert again.cfg == model.cfg
    assert all(torch.equal(again.state_dict()[k], v) for k, v in model.state_dict().items())

