"""The port's OWL-ViT checkpoint loader against the JAX package's, on the CPU.

A random ``transformers.OwlViTForObjectDetection`` (and an
``Owlv2ForObjectDetection``, whose ``owlv2.`` prefix the converter detects)
is saved to ``tmp_path`` with CLIP-style vocabulary files, the reference
test's fixture (``tests/test_owlvit_loader.py``).  The port's
``load_owlvit_checkpoint`` (its own safetensors parser, the name table of
``models/convert.py``) and the reference's give the same detector outputs
in f32, within 1e-5 absolute + 1e-4 relative (the same weights; the towers
sum in another order); their tokenizers give equal ids.
``initialize_heuristic('owl-vit', checkpoint_dir=..., device='cpu')``
builds a working scorer, and raises without a checkpoint.  The name table
read backwards writes the same tensors (``save_owlvit_checkpoint``).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("safetensors")

from tstar_tpu.models.loader import load_owlvit_checkpoint as jload  # noqa: E402
from tstar_tpu_torch.framework.heuristics import initialize_heuristic  # noqa: E402
from tstar_tpu_torch.models.convert import (  # noqa: E402
    convert_hf_owlvit_state_dict, export_state_dict, owlvit_rules,
)
from tstar_tpu_torch.models.loader import (  # noqa: E402
    load_owlvit_checkpoint, read_safetensors, save_owlvit_checkpoint,
)
from tstar_tpu_torch.utils.config import SearchConfig  # noqa: E402


def _write_vocab(d):
    chars = list("abcdefghijklmnopqrstuvwxyz ")
    vocab = {}
    for ch in chars:
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault(ch + "</w>", len(vocab))
    merges = [("c", "o"), ("co", "u"), ("cou", "c"), ("couc", "h</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


@pytest.fixture(scope="module", params=["owlvit", "owlv2"])
def checkpoint_dir(request, tmp_path_factory):
    from safetensors.torch import save_file

    d = tmp_path_factory.mktemp(f"{request.param}_ckpt")
    text = dict(vocab_size=100, hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=48, max_position_embeddings=8)
    vision = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, patch_size=16, image_size=64)
    if request.param == "owlvit":
        hf_cfg = transformers.OwlViTConfig(text_config=text, vision_config=vision,
                                           projection_dim=24)
        cls = transformers.OwlViTForObjectDetection
    else:
        hf_cfg = transformers.Owlv2Config(text_config=text, vision_config=vision,
                                          projection_dim=24)
        cls = transformers.Owlv2ForObjectDetection
    torch.manual_seed(0)
    model = cls(hf_cfg)
    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              str(d / "model.safetensors"))
    (d / "config.json").write_text(hf_cfg.to_json_string())
    _write_vocab(d)
    return str(d)


def test_loader_matches_reference(checkpoint_dir):
    jmodel, variables, jtok = jload(checkpoint_dir, dtype=jnp.float32)
    tmodel, ttok = load_owlvit_checkpoint(checkpoint_dir, device="cpu", dtype=torch.float32)
    assert tmodel.cfg == _port_cfg(jmodel.cfg)
    texts = ["couch", "a couch", " "]
    ids, mask = ttok.encode_batch(texts)
    for got, want in zip((ids, mask), jtok.encode_batch(texts)):
        np.testing.assert_array_equal(got, want)
    px = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jl, jb = jmodel.apply(variables, jnp.asarray(px), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        tl, tb = tmodel(torch.from_numpy(px), torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5, rtol=1e-4)


def _port_cfg(jcfg):
    from tstar_tpu_torch.models import owlvit as tow

    return tow.OwlViTConfig(
        vision=tow.VisionConfig(**jcfg.vision.__dict__), text=tow.TextConfig(**jcfg.text.__dict__),
        projection_dim=jcfg.projection_dim)


def test_name_table_round_trip(checkpoint_dir, tmp_path):
    """Reading the table backwards writes the checkpoint's own tensors (those
    the detector reads), and a written checkpoint loads to the same model."""
    sd = read_safetensors(f"{checkpoint_dir}/model.safetensors")
    tmodel, _ = load_owlvit_checkpoint(checkpoint_dir, device="cpu", dtype=torch.float32)
    base = "owlv2" if any(k.startswith("owlv2.") for k in sd) else "owlvit"
    back = export_state_dict(tmodel.state_dict(), owlvit_rules(tmodel.cfg, base))
    assert set(back) <= set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    state = convert_hf_owlvit_state_dict(sd, tmodel.cfg)
    assert set(state) == set(tmodel.state_dict())
    save_owlvit_checkpoint(tmodel, str(tmp_path))
    _write_vocab(tmp_path)
    again, _ = load_owlvit_checkpoint(str(tmp_path), device="cpu", dtype=torch.float32)
    for (k, a), b in zip(tmodel.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


def test_heuristic_from_checkpoint_dir(checkpoint_dir):
    h = initialize_heuristic("owl-vit", checkpoint_dir=checkpoint_dir, device="cpu",
                             dtype=torch.float32)
    assert h.name == "owl-vit" and h.model.dtype == torch.float32
    rng = np.random.default_rng(1)
    cache = torch.from_numpy(rng.integers(0, 256, (128, 32, 64, 3), dtype=np.uint8))
    scorer = h.build_scorer(cache, ["couch"], [], SearchConfig())
    conf, presence = scorer.score_grid(torch.arange(16))
    assert conf.shape == (16,) and bool(torch.isfinite(conf).all())
    h.reparameterize_object_list(["couch"], ["tv"])
    assert h.texts == [["couch"], ["tv"], [" "]]
    det = h.inference_detector([rng.integers(0, 256, (50, 80, 3), dtype=np.uint8)])[0]
    assert det["xyxy"].shape[1] == 4 and len(det["confidence"]) == len(det["class_id"])


@pytest.mark.parametrize("name", ["owl-vit", "owlv2", "yolo-world", "yolo-world-v2"])
def test_checkpoint_backends_raise_without_a_checkpoint(name):
    with pytest.raises(ValueError, match="random"):
        initialize_heuristic(name, device="cpu")
