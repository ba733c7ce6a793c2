"""The port's OWL-ViT (tstar_tpu_torch/models) against the reference's flax
model (tstar_tpu/models) with the same weights: ``params_from_jax`` of the
reference's ``model.init`` variables, tiny widths, float32 on the CPU.

Tolerance: 2e-5 absolute on features, logits and boxes.  The two-layer
towers chain ~15 float32 matmuls and normalizations whose sums run in
different orders in XLA and PyTorch; measured differences are ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu.models import owlvit as jow
from tstar_tpu.models import transformer as jtr
from tstar_tpu.models.clip_tokenizer import HashTokenizer as JHash
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import transformer as ttr
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THash

TOL = 2e-5


def tiny_pair(module):
    """The same tiny config in both packages."""
    v = module.VisionConfig(
        hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
        patch_size=16, image_size=64,
    )
    t = module.TextConfig(
        vocab_size=100, hidden_size=24, num_layers=2, num_heads=4,
        intermediate_size=48, max_length=8,
    )
    return module.OwlViTConfig(vision=v, text=t, projection_dim=24)


@pytest.fixture(scope="module")
def models():
    jmodel = jow.OwlViTDetector(tiny_pair(jow), dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32)
    )
    tmodel = tow.OwlViTDetector(tiny_pair(tow))
    tmodel.load_state_dict(tow.params_from_jax(variables), strict=True)
    tmodel.requires_grad_(False)
    return jmodel, variables, tmodel


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ids, mask = JHash(100, 8).encode_batch(["couch", "floor lamp", " ", "red tv set"])
    return px, ids, mask


def test_tokenizers_identical():
    texts = ["couch", "Floor  Lamp", " ", "a b c d e f g h i j"]
    for want, got in zip(JHash(100, 8).encode_batch(texts), THash(100, 8).encode_batch(texts)):
        np.testing.assert_array_equal(got, want)


def test_params_from_jax_covers_every_parameter(models):
    _, variables, tmodel = models
    state = tow.params_from_jax(variables)
    assert set(state) == set(tmodel.state_dict())


def test_encode_text_matches(models):
    jmodel, variables, tmodel = models
    _, ids, mask = _inputs()
    want = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(mask), method=jow.OwlViTDetector.encode_text)
    got = tmodel.encode_text(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_encode_image_predict_postprocess_match(models):
    jmodel, variables, tmodel = models
    px, ids, mask = _inputs(1)
    jf = jmodel.apply(variables, jnp.asarray(px), method=jow.OwlViTDetector.encode_image)
    tf = tmodel.encode_image(torch.from_numpy(px))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=TOL)

    q = np.asarray(jmodel.apply(
        variables, jnp.asarray(ids), jnp.asarray(mask), method=jow.OwlViTDetector.encode_text
    ))
    qmask = np.array([True, True, True, False])
    jl, jb = jmodel.apply(variables, jf, jnp.asarray(q), jnp.asarray(qmask), method=jow.OwlViTDetector.predict)
    tl, tb = tmodel.predict(tf, torch.from_numpy(q), torch.from_numpy(qmask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=TOL)

    want = jow.postprocess_detections(jl, jb, (64, 64))
    got = tow.postprocess_detections(tl, tb, (64, 64))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=TOL * 64)


def test_box_bias_and_masks_match():
    np.testing.assert_allclose(tow.box_bias(24).numpy(), np.asarray(jow.box_bias(24)), atol=1e-6)
    np.testing.assert_array_equal(ttr.causal_bias(8).numpy(), np.asarray(jtr.causal_bias(8)))
    m = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(
        ttr.padding_bias(torch.from_numpy(m)).numpy(), np.asarray(jtr.padding_bias(jnp.asarray(m)))
    )
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(
        ttr.quick_gelu(torch.from_numpy(x)).numpy(), np.asarray(jtr.quick_gelu(jnp.asarray(x))),
        rtol=1e-6, atol=1e-7,
    )


def test_biased_attention_matches_flax_layer():
    """The text tower's path: plain masked softmax attention under an
    additive causal + padding bias, through one encoder layer."""
    layer = jtr.EncoderLayer(num_heads=4, intermediate_size=48)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 8, 24)).astype(np.float32)
    mask = (np.arange(8)[None] < np.array([[3], [8], [5]])).astype(np.int32)
    bias = jtr.causal_bias(8) + jtr.padding_bias(jnp.asarray(mask))
    variables = layer.init(jax.random.key(1), jnp.asarray(x), bias)
    want = layer.apply(variables, jnp.asarray(x), bias)

    tlayer = ttr.EncoderLayer(24, 4, 48)
    state = tow.params_from_jax(variables)
    tlayer.load_state_dict(state, strict=True)
    tbias = ttr.causal_bias(8) + ttr.padding_bias(torch.from_numpy(mask))
    with torch.no_grad():
        got = tlayer(torch.from_numpy(x), tbias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_random_init_families():
    """owl-vit-random's init: truncated lecun-normal kernels, N(0, 0.02)
    embeddings, zero biases, unit LayerNorm scales, reproducible by seed."""
    cfg = tiny_pair(tow)
    a = tow.init_params(tow.OwlViTDetector(cfg), seed=5).state_dict()
    b = tow.init_params(tow.OwlViTDetector(cfg), seed=5).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    k = a["vision.encoder.layers.0.mlp.fc1.kernel"]            # fan_in 32
    std = (1 / 32) ** 0.5
    assert k.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(k.std().item() - std) < 0.15 * std
    assert abs(a["text.token_embedding"].std().item() - 0.02) < 0.002
    assert torch.all(a["vision.pre_layernorm.scale"] == 1)
    assert torch.all(a["vision.encoder.layers.1.self_attn.qkv_bias"] == 0)
