"""SigLIP's widths, D = 1152 and 16 heads of 72 (``tstar_tpu/models/siglip.py``),
and the shape gates of the port's LayerNorm (K3) and attention (K1) kernels.

The reference's gates send a LayerNorm whose width is not a multiple of 128,
and attention whose head width is not a multiple of 128 lanes, to XLA; the
port's model layer sends what K3 and K1 do not take to the same math in
plain tensor ops or the split-head routes, by shape alone, on the CPU as on
the card: 1152 goes to K3 (9 x 128), heads of 72 do not go to K1.  The port's
``EncoderLayer`` is held against ``tstar_tpu.models.transformer.EncoderLayer``
on the same numpy-made weights, loaded through ``params_from_jax``.

Tolerances: f32 differs from XLA by summation order only, over sums of 1152
and 4304 products of values of order one (outputs up to ~10): 2e-5
absolute + 1e-5 relative.
bf16 rounds the projections, the probabilities and the residual stream
(|x| ~ 4, one ulp 3.1e-2) at the same points in both frameworks, but a sum
taken in another order can round to the neighbouring value: two ulps at that
magnitude, 6.25e-2 absolute + 2e-2 relative (``tests/test_torch_ln_matmul.py``'s
encoder-layer tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu.models import transformer as jtr
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import transformer as ttr

D, HEADS, MLP, S = 1152, 16, 4304, 37
_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (6.25e-2, 2e-2)}
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _numpy_variables(layer, x, seed):
    """The layer's flax variables with every leaf drawn from numpy: kernels
    N(0, 1/fan_in), biases and LayerNorm shifts N(0, 0.1^2), LayerNorm scales
    1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: layer.init(jax.random.key(0), x))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _layers(dtype, seed=0):
    rng = np.random.default_rng(seed + 1)
    x = (2 * rng.normal(size=(2, S, D))).astype(np.float32)
    jlayer = jtr.EncoderLayer(num_heads=HEADS, intermediate_size=MLP, eps=1e-6, dtype=_JNP[dtype])
    variables = _numpy_variables(jlayer, jnp.asarray(x), seed)
    tlayer = ttr.EncoderLayer(D, HEADS, MLP, eps=1e-6)
    tlayer.load_state_dict(tow.params_from_jax(variables), strict=True)
    return jlayer, variables, tlayer.to(dtype).requires_grad_(False), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_siglip_width_layer_matches_reference(dtype, monkeypatch):
    """One pre-norm layer at D = 1152, 16 x 72, S = 37, against the flax layer
    on the same weights.  Default routes: K1 on (``TSTAR_FUSED_MHA`` unset),
    no LN fold."""
    for var in ("TSTAR_FUSED_MHA", "TSTAR_FLASH_ATTENTION", "TSTAR_ATTN_PROBS_BF16",
                "TSTAR_LN_MATMUL"):
        monkeypatch.delenv(var, raising=False)
    jlayer, variables, tlayer, x = _layers(dtype)
    want = np.asarray(jlayer.apply(variables, jnp.asarray(x, _JNP[dtype])), np.float32)
    got = tlayer(torch.from_numpy(x).to(dtype))
    assert got.shape == (2, S, D) and got.dtype == dtype
    atol, rtol = _TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


def _count(monkeypatch, name):
    """Counts the model layer's calls of the kernel wrapper ``name``."""
    calls = []
    fn = getattr(ttr, name)

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return fn(*args, **kw)

    monkeypatch.setattr(ttr, name, counted)
    return calls


@pytest.mark.parametrize("d,heads,k1,k3", [(1152, 16, 0, 2), (768, 12, 1, 2), (1152, 18, 1, 2),
                                            (512, 8, 1, 2), (576, 9, 1, 0)])
def test_gates_route_by_width(monkeypatch, d, heads, k1, k3):
    """The gates decide by shape alone: K1 only at head width 64, K3 at the
    widths the reference's kernel takes (a multiple of 128: 512, 768, 1152;
    not 576); the rest take the plain math.  CPU tensors, so every call is
    a plain version; what is counted is which wrapper the layer chose."""
    monkeypatch.delenv("TSTAR_FUSED_MHA", raising=False)
    monkeypatch.delenv("TSTAR_LN_MATMUL", raising=False)
    mha = _count(monkeypatch, "fused_mha_from_qkv")
    ln = _count(monkeypatch, "fused_layernorm")
    layer = ttr.EncoderLayer(d, heads, 64).requires_grad_(False)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.02)
    out = layer(torch.randn(1, 5, d))
    assert out.shape == (1, 5, d) and bool(torch.isfinite(out).all())
    assert (len(mha), len(ln)) == (k1, k3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_layernorm_is_k3_math(dtype):
    """The branch for a width K3 does not take is K3's own math:
    ``apply_layernorm`` at D = 1160 (not a multiple of 128) equals K3's
    plain version exactly."""
    from tstar_tpu_torch.kernels.layernorm import fused_layernorm_plain, supported_width

    d = 1160
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(7, d, generator=g) * 3 + 1).to(dtype)
    scale = torch.randn(d, generator=g).to(dtype)
    bias = torch.randn(d, generator=g).to(dtype)
    assert not supported_width(d, dtype) and supported_width(D, dtype)
    assert torch.equal(ttr.apply_layernorm(x, scale, bias, 1e-6),
                       fused_layernorm_plain(x, scale, bias, 1e-6))
