"""The port's mmyolo YOLO-World converter (``tstar_tpu_torch/models/yolo_loader.py``)
against the JAX package's, on the CPU.

The checkpoint is the reference test's plain-torch replica of the mmyolo
module graph, whose ``state_dict`` has mmyolo's names, with nontrivial BN
statistics (``tests/test_yolo_loader.py``), and an HF CLIP text model with
projection.  Both converters give the same parameters, tensor for tensor
and bit for bit (the BN fold is the same f32 arithmetic; the port's
detector on the reference's parameters is tested in
``tests/test_torch_yoloworld.py``).  A tensor left over or missing raises
``ConversionError``, allowlisted buffers do not, and a converted tensor of
the wrong shape does.  ``load_yolo_world_checkpoint`` reads a ``.pth`` +
CLIP vocabulary directory and the reference's native ``.npz`` files; a
``.pth`` whose metadata holds objects of other modules loads without
running any of the file's code, and one that calls a blocked module raises.
The table read backwards (``export_mmyolo_state_dict``) writes a checkpoint
that converts back to the same parameters.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from tests.test_yolo_loader import (
    TINY, TINY_EMBED, _build_replica, _randomize_bn_stats, _tiny_text_model,
)
from tstar_tpu.models import yolo_loader as jyl
from tstar_tpu.models import yoloworld as jy
from tstar_tpu.models.loader import save_flax_params
from tstar_tpu_torch.framework.heuristics import initialize_heuristic
from tstar_tpu_torch.models import yolo_loader as tyl
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import yoloworld as ty


def _port_cfg(jcfg):
    return ty.YoloWorldConfig(**jcfg.__dict__)


def _text_model(max_positions, projection_dim):
    """``_tiny_text_model`` with the detector's text width as projection."""
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    cfg = CLIPTextConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=max_positions,
                         projection_dim=projection_dim, bos_token_id=62, eos_token_id=63)
    torch.manual_seed(3)
    return CLIPTextModelWithProjection(cfg).eval()


def _replica(cfg, seed=0, max_positions=16):
    torch.manual_seed(seed)
    text = (_tiny_text_model(max_positions) if cfg.text_dim == 32
            else _text_model(max_positions, cfg.text_dim))
    top = _build_replica(cfg, text)
    top.eval()
    _randomize_bn_stats(top, torch.Generator().manual_seed(seed))
    return dict(top.state_dict())


@pytest.mark.parametrize("cfg", [TINY, TINY_EMBED], ids=["tiny", "embed_conv"])
def test_converters_give_the_same_parameters(cfg):
    sd = _replica(cfg)
    jdet, jtext = jyl.convert_mmyolo_yolo_world_state_dict(sd, cfg)
    det, text = tyl.convert_mmyolo_yolo_world_state_dict(sd, _port_cfg(cfg))
    want_det, want_text = ty.params_from_jax(jdet), tow.params_from_jax(jtext)
    assert set(det) == set(want_det) and set(text) == set(want_text)
    for got, want in ((det, want_det), (text, want_text)):
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    if cfg is TINY_EMBED:
        assert any("embed_conv" in k for k in det)


@pytest.mark.parametrize("change", ["leftover", "missing", "missing_text"])
def test_leftover_or_missing_tensor_raises(change):
    sd = _replica(TINY)
    if change == "leftover":
        sd["neck.top_down_layers.0.attn_block.mystery.weight"] = torch.zeros(3)
        match = "not consumed"
    elif change == "missing":
        del sd["backbone.image_model.stem.conv.weight"]
        match = "missing"
    else:
        del sd["backbone.text_model.model.text_model.encoder.layers.1.mlp.fc2.bias"]
        match = "missing"
    with pytest.raises(tyl.ConversionError, match=match):
        tyl.convert_mmyolo_yolo_world_state_dict(sd, _port_cfg(TINY))


def test_ignored_buffers_and_non_strict():
    sd = _replica(TINY)
    sd["bbox_head.head_module.proj"] = torch.arange(8.0)
    sd["data_preprocessor.mean"] = torch.zeros(3)
    tyl.convert_mmyolo_yolo_world_state_dict(sd, _port_cfg(TINY))      # no raise
    sd["extra.weight"] = torch.zeros(2)
    tyl.convert_mmyolo_yolo_world_state_dict(sd, _port_cfg(TINY), strict=False)


def test_wrong_architecture_raises():
    """A checkpoint of another config: embed convs it does not have are
    missing; a converted tensor of the wrong shape fails validation."""
    sd = _replica(TINY)
    with pytest.raises(tyl.ConversionError):
        tyl.convert_mmyolo_yolo_world_state_dict(sd, _port_cfg(TINY_EMBED))
    det, text = tyl.convert_mmyolo_yolo_world_state_dict(sd, _port_cfg(TINY))
    text_cfg = ty.text_config_from_state(text)
    tyl.validate_converted_shapes(_port_cfg(TINY), text_cfg, det, text)
    det["stem.conv.weight"] = det["stem.conv.weight"][:, :, :2]
    with pytest.raises(tyl.ConversionError, match="shape"):
        tyl.validate_converted_shapes(_port_cfg(TINY), text_cfg, det, text)


def test_text_config_inferred_as_the_reference():
    """Heads as the reference infers them (64-wide, at least one), the
    position length from the checkpoint (77 for real CLIP)."""
    sd = _replica(TINY, max_positions=77)
    _, jtext = jyl.convert_mmyolo_yolo_world_state_dict(sd, TINY)
    _, text = tyl.convert_mmyolo_yolo_world_state_dict(sd, _port_cfg(TINY))
    want = jyl._infer_text_config(jtext)
    got = ty.text_config_from_state(text)
    assert got.__dict__ == want.__dict__ and got.max_length == 77


def _vocab(d):
    chars = list("abcdefghijklmnopqrstuvwxyz ")
    vocab = {}
    for ch in chars:
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault(ch + "</w>", len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")


def _small_replica():
    """The replica at ``yoloworld_small``'s dims (the size the loader knows)."""
    return _replica(jy.yoloworld_small())


@pytest.mark.parametrize("route", ["pth", "npz"])
def test_checkpoint_directory_loads(tmp_path, route):
    sd = _small_replica()
    jdet, jtext = jyl.convert_mmyolo_yolo_world_state_dict(sd, jy.yoloworld_small())
    if route == "pth":
        torch.save({"state_dict": sd, "meta": {"note": "test"}}, tmp_path / "yolo_world_v2.pth")
    else:
        save_flax_params(jax.device_get(jdet), str(tmp_path), "yolo_world.npz")
        save_flax_params(jax.device_get(jtext), str(tmp_path), "text_tower.npz")
    _vocab(tmp_path)
    model, text_model, tok = tyl.load_yolo_world_checkpoint(str(tmp_path), size="small",
                                                            device="cpu", dtype=torch.float32)
    want = ty.params_from_jax(jdet)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    want_t = tow.params_from_jax(jtext)
    for k, v in text_model.state_dict().items():
        assert torch.equal(v, want_t[k]), k
    assert text_model.text_cfg.__dict__ == jyl._infer_text_config(jtext).__dict__
    ids, _ = tok.encode_batch(["couch", "lamp"])
    assert tok.context == 16 and ids[0, 0] == tok.bos_id
    h = initialize_heuristic("yolo-world", checkpoint_dir=str(tmp_path), size="small",
                             device="cpu", dtype=torch.bfloat16)
    assert h.model.dtype == torch.bfloat16 and h.model.contrast0_bias.dtype == torch.float32


class _TrainingLog:
    """Stands for mmengine's metadata objects (message hub, history buffers)."""

    def __init__(self):
        self.history = np.arange(4.0)


class _RunsCode:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (os.system, (f"touch {self.marker}",))


def test_pth_metadata_never_runs_code(tmp_path):
    sd = {"a": torch.arange(3.0), "b": torch.ones(2, dtype=torch.int64)}
    meta = {"hub": _TrainingLog(), "arr": np.ones(2), "dtype": np.dtype("float32"), "seed": 3}
    path = tmp_path / "meta.pth"
    torch.save({"state_dict": sd, "meta": meta}, path)
    ckpt = tyl.load_pth(str(path))
    assert set(ckpt["state_dict"]) == {"a", "b"}
    for k, v in sd.items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    assert ckpt["meta"]["seed"] == 3 and not isinstance(ckpt["meta"]["hub"], _TrainingLog)
    marker = tmp_path / "ran"
    torch.save({"state_dict": sd, "meta": _RunsCode(marker)}, tmp_path / "code.pth")
    with pytest.raises(pickle.UnpicklingError):
        tyl.load_pth(str(tmp_path / "code.pth"))
    assert not marker.exists()


def test_export_converts_back_to_the_same_parameters(tmp_path):
    sd = _small_replica()
    det, text = tyl.convert_mmyolo_yolo_world_state_dict(sd, ty.yoloworld_small())
    back = tyl.export_mmyolo_state_dict(det, text, ty.yoloworld_small())
    assert set(back) <= set(sd)
    det2, text2 = tyl.convert_mmyolo_yolo_world_state_dict(back, ty.yoloworld_small())
    for got, want in ((det2, det), (text2, text)):
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
