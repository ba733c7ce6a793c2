"""Slice 3's attention routes against the JAX reference on the CPU: K8's
plain version (``kernels/attention.flash_mha_plain``) against the
reference's ``flash_mha`` (JAX's TPU flash kernel in interpret mode),
``bf16_probs_attention``, the gates, and the flash route through a vision
tower and through the int8 tower.  Inputs come from numpy with a seed; each
tolerance states its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tstar_tpu.kernels import attention as jatt
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models import owlvit_quant as jq
from tstar_tpu_torch.kernels import attention as tatt
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import owlvit_quant as tq
from tstar_tpu_torch.models import transformer as ttr


def _qkv(seed, b, s, h, d=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s", [130, 257])
def test_flash_plain_matches_reference_kernel(s):
    """f32, S not a multiple of 128 (the reference pads to 256 / 384 and masks
    the pads): 1e-5, the f32 sums run in other orders."""
    q, k, v = _qkv(s, 1, s, 2)
    with pltpu.force_tpu_interpret_mode():
        want = jatt.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tatt.flash_mha(*(torch.from_numpy(t) for t in (q, k, v)))
    assert got.shape == (1, s, 2, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_flash_plain_bf16_rounds_where_the_reference_does():
    """bf16 q, k, v: the normalized probabilities are rounded to bf16 before
    PV, as the reference kernel's single key block does; the outputs agree to
    one bf16 ulp (2^-7 relative) plus 1e-3 for a rounding flip of one
    probability."""
    q, k, v = (t.astype(jnp.bfloat16) for t in map(jnp.asarray, _qkv(7, 1, 130, 2)))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jatt.flash_mha(q, k, v).astype(jnp.float32))
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (q, k, v)]
    got = tatt.flash_mha(*t)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= 1e-3 + 2.0 ** -7 * np.abs(want)).all(), err.max()


def test_bf16_probs_attention_matches_reference():
    """bf16 in and out: the f32 logits and softmax agree to ~1e-7, the bf16
    products of the AV matmul are summed in another order before the final
    rounding: one bf16 ulp plus 1e-3 for a flipped bf16 probability."""
    q, k, v = (jnp.asarray(t).astype(jnp.bfloat16) for t in _qkv(9, 2, 40, 3))
    want = np.asarray(jatt.bf16_probs_attention(q, k, v).astype(jnp.float32))
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (q, k, v)]
    got = tatt.bf16_probs_attention(*t)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 40, 3, 64)
    err = np.abs(got.float().numpy() - want)
    assert (err <= 1e-3 + 2.0 ** -7 * np.abs(want)).all(), err.max()


def test_attention_gates(monkeypatch):
    """The reference's switches, less its TPU check: K1 off only under
    TSTAR_FUSED_MHA=0; flash for S >= 256, head width % 64, no bias; bf16
    probabilities for bf16 with no bias."""
    for var in ("TSTAR_FUSED_MHA", "TSTAR_FLASH_ATTENTION", "TSTAR_ATTN_PROBS_BF16"):
        monkeypatch.delenv(var, raising=False)
    q = torch.zeros(1, 257, 2, 64)
    assert tatt.use_fused_mha() and not tatt.use_flash_attention(q, None)
    assert not tatt.use_bf16_probs(q.bfloat16(), None)
    for value, on in (("0", False), ("1", True), ("force", True)):
        monkeypatch.setenv("TSTAR_FUSED_MHA", value)
        assert tatt.use_fused_mha() == on
    monkeypatch.setenv("TSTAR_FLASH_ATTENTION", "1")
    assert tatt.use_flash_attention(q, None)
    assert not tatt.use_flash_attention(q, torch.zeros(1, 1, 257, 257))
    assert not tatt.use_flash_attention(torch.zeros(1, 255, 2, 64), None)
    assert not tatt.use_flash_attention(torch.zeros(1, 257, 2, 48), None)
    monkeypatch.setenv("TSTAR_ATTN_PROBS_BF16", "1")
    assert tatt.use_bf16_probs(q.bfloat16(), None)
    assert not tatt.use_bf16_probs(q, None)
    assert not tatt.use_bf16_probs(q.bfloat16(), torch.zeros(1))


def _tower_cfg(module):
    """64^2 images in patches of 4: 257 tokens, one 64-wide head."""
    v = module.VisionConfig(
        hidden_size=64, num_layers=2, num_heads=1, intermediate_size=96,
        patch_size=4, image_size=64,
    )
    t = module.TextConfig(
        vocab_size=100, hidden_size=24, num_layers=1, num_heads=4,
        intermediate_size=48, max_length=8,
    )
    return module.OwlViTConfig(vision=v, text=t, projection_dim=24)


@pytest.fixture(scope="module")
def towers():
    jmodel = jow.OwlViTDetector(_tower_cfg(jow), dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(
        jax.random.key(1), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32)
    )
    tmodel = tow.OwlViTDetector(_tower_cfg(tow))
    tmodel.load_state_dict(tow.params_from_jax(variables), strict=True)
    tmodel.requires_grad_(False)
    px = np.random.default_rng(11).normal(size=(2, 64, 64, 3)).astype(np.float32)
    return jmodel, variables, tmodel, px


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(1) or real(*a))
    return calls


def test_flash_route_through_the_tower(towers, monkeypatch):
    """TSTAR_FUSED_MHA=0 TSTAR_FLASH_ATTENTION=1: every layer's attention
    goes through ``flash_mha`` (its plain version here); the features equal
    the reference tower's on its XLA attention (its flash gate needs a TPU)
    within 1e-5, f32 sums in other orders."""
    jmodel, variables, tmodel, px = towers
    monkeypatch.setenv("TSTAR_FUSED_MHA", "0")
    monkeypatch.setenv("TSTAR_FLASH_ATTENTION", "1")
    want = jmodel.apply(variables, jnp.asarray(px), method=jow.OwlViTDetector.encode_image)
    flash = _count_calls(monkeypatch, ttr, "flash_mha")
    k1 = _count_calls(monkeypatch, ttr, "fused_mha_from_qkv")
    got = tmodel.encode_image(torch.from_numpy(px))
    assert len(flash) == 2 and not k1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bf16_probs_route_through_the_tower(towers, monkeypatch):
    """TSTAR_FUSED_MHA=0 TSTAR_ATTN_PROBS_BF16=1 in a bf16 tower: every
    layer's attention goes through ``bf16_probs_attention``; the flash switch
    wins when both are set."""
    tmodel, px = towers[2], towers[3]
    model = tow.OwlViTDetector(_tower_cfg(tow))
    model.load_state_dict(tmodel.state_dict())
    model = model.to(torch.bfloat16).requires_grad_(False)
    monkeypatch.setenv("TSTAR_FUSED_MHA", "0")
    monkeypatch.setenv("TSTAR_ATTN_PROBS_BF16", "1")
    probs = _count_calls(monkeypatch, ttr, "bf16_probs_attention")
    flash = _count_calls(monkeypatch, ttr, "flash_mha")
    x = torch.from_numpy(px)
    assert torch.isfinite(model.encode_image(x).float()).all()
    assert len(probs) == 2 and not flash
    monkeypatch.setenv("TSTAR_FLASH_ATTENTION", "1")
    model.encode_image(x)
    assert len(probs) == 2 and len(flash) == 2


def test_flash_route_through_the_int8_tower(towers, monkeypatch):
    """The int8 tower under TSTAR_FUSED_MHA=0 TSTAR_FLASH_ATTENTION=1 routes
    as the reference's (K1, else flash, else plain): flash in every layer,
    the features within the int8 tower test's 5e-2 (an activation may cross
    an int8 rounding boundary, ``tests/test_torch_quant.py``)."""
    jmodel, variables, tmodel, px = towers
    monkeypatch.setenv("TSTAR_FUSED_MHA", "0")
    monkeypatch.setenv("TSTAR_FLASH_ATTENTION", "1")
    want = jq.encode_image_int8(
        jq.quantize_vision_tower(variables, jmodel.cfg), jnp.asarray(px), jmodel.cfg,
        dtype=jnp.float32,
    )
    flash = _count_calls(monkeypatch, tq, "flash_mha")
    got = tq.encode_image_int8(
        tq.quantize_vision_tower(tmodel), torch.from_numpy(px), tmodel.cfg, dtype=torch.float32
    )
    assert len(flash) == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-2)
