"""The port's quantized detector (ops/quant, kernels/quant_matmul,
models/owlvit_quant) and its reduced-resolution view (models/owlvit
``interpolate_position_embedding`` / ``resize_detector``) against the
reference's, on the CPU, from the same numpy inputs and the same weights.

Tolerances:
- ``quantize_weight``, ``dense_w8a8`` and ``quantize_vision_tower`` are
  bit-equal: the same f32 divisions, half-to-even rounding, an exact integer
  product and the same f32 dequantization order.
- ``w8a8_matmul`` against the reference's Pallas kernel (``interpret=True``):
  that kernel may reassociate its f32 epilogue by one ulp, so its own test's
  tolerance (``tests/test_quant_matmul.py``): one bf16 ulp at the output's
  magnitude, 1e-5 in f32.
- ``dense_w8a16``: f32 products summed in another order, 1e-5.
- The tiny W8A8 tower: upstream float differences of ~1e-7 (attention,
  LayerNorm sums in another order) can move an activation across an int8
  rounding boundary, which moves it by one quantization step (|row max| /
  127); a few such flips move features by up to ~1e-2, so 5e-2 absolute.
  The weight-only tower has no activation rounding: 2e-5.
- Position-embedding resampling: the same filter, 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_owlvit import tiny_pair
from tstar_tpu.kernels.quant_matmul import w8a8_matmul as jax_w8a8
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models import owlvit_quant as jq
from tstar_tpu.ops import quant as jops
from tstar_tpu_torch.kernels.quant_matmul import w8a8_matmul
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import owlvit_quant as tq
from tstar_tpu_torch.ops import quant as tops

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _layer(rng, k, n):
    w = (rng.normal(size=(k, n)) * 0.03).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    w_i8, w_s = jops.quantize_weight(w)
    return w, w_i8, w_s, b


def test_quantize_weight_bit_equal():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(96, 80)).astype(np.float32)
    w[:, 3] = 0.0                      # an all-zero channel takes the 1e-12 floor
    for got, want in zip(tops.quantize_weight(w), jops.quantize_weight(w)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# The four dense layers of the quantized tower: (K, N, in dtype, out dtype).
LAYERS = [
    (768, 2304, "float32", "bfloat16"),    # qkv: f32 LayerNorm out -> bf16
    (768, 768, "bfloat16", "bfloat16"),    # out_proj
    (768, 3072, "float32", "float32"),     # fc1 writes f32
    (3072, 768, "float32", "bfloat16"),    # fc2 reads it
]


@pytest.mark.parametrize("k,n,xd,od", LAYERS)
def test_dense_w8a8_bit_equal(k, n, xd, od):
    rng = np.random.default_rng(k + n)
    _, w_i8, w_s, b = _layer(rng, k, n)
    x = (rng.normal(size=(2, 37, k)) * 3).astype(np.float32)
    want = jops.dense_w8a8(
        jnp.asarray(x, JDT[xd]), jnp.asarray(w_i8), jnp.asarray(w_s), jnp.asarray(b),
        out_dtype=JDT[od],
    )
    got = tops.dense_w8a8(
        torch.from_numpy(x).to(TDT[xd]), torch.from_numpy(w_i8), torch.from_numpy(w_s),
        torch.from_numpy(b), out_dtype=TDT[od],
    )
    assert got.dtype == TDT[od] and got.shape == (2, 37, n)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("k,n,xd,od", LAYERS)
def test_dense_w8a8_with_transposed_weight_bit_equal(k, n, xd, od):
    """The int8 tower hands ``dense_w8a8`` the (N, K) copy that K4 reads on
    the card; given it, the result is still bit-equal to the reference."""
    rng = np.random.default_rng(k * n)
    _, w_i8, w_s, b = _layer(rng, k, n)
    x = (rng.normal(size=(3, 19, k)) * 3).astype(np.float32)
    want = jops.dense_w8a8(
        jnp.asarray(x, JDT[xd]), jnp.asarray(w_i8), jnp.asarray(w_s), jnp.asarray(b),
        out_dtype=JDT[od],
    )
    got = tops.dense_w8a8(
        torch.from_numpy(x).to(TDT[xd]), torch.from_numpy(w_i8), torch.from_numpy(w_s),
        torch.from_numpy(b), out_dtype=TDT[od],
        w_t=torch.from_numpy(np.ascontiguousarray(w_i8.T)),
    )
    assert got.dtype == TDT[od] and got.shape == (3, 19, n)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_dense_w8a8_rejects_an_untransposed_weight():
    """A (K, N) array passed as ``w_t`` is refused, on the CPU too."""
    rng = np.random.default_rng(11)
    _, w_i8, w_s, b = _layer(rng, 64, 48)
    x = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    with pytest.raises(ValueError, match="transpose"):
        tops.dense_w8a8(x, torch.from_numpy(w_i8), torch.from_numpy(w_s), torch.from_numpy(b),
                        w_t=torch.from_numpy(w_i8))


def test_dense_w8a8_without_bias_bit_equal():
    rng = np.random.default_rng(9)
    _, w_i8, w_s, _ = _layer(rng, 64, 48)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    want = jops.dense_w8a8(jnp.asarray(x), jnp.asarray(w_i8), jnp.asarray(w_s))
    got = tops.dense_w8a8(torch.from_numpy(x), torch.from_numpy(w_i8), torch.from_numpy(w_s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_matmul_matches_pallas_interpret(dtype):
    """The setup of ``tests/test_quant_matmul.py::test_matches_dense_w8a8``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 96, 128)).astype(np.float32)
    w_i8, w_s = jops.quantize_weight(rng.normal(size=(128, 256)).astype(np.float32))
    b = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    want = jax_w8a8(
        jnp.asarray(x, JDT[dtype]), jnp.asarray(w_i8), jnp.asarray(w_s), jnp.asarray(b),
        out_dtype_name=dtype, interpret=True,
    )
    got = w8a8_matmul(
        torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(w_i8), torch.from_numpy(w_s),
        torch.from_numpy(b), TDT[dtype],
    )
    atol, rtol = (0.3, 0.0) if dtype == "bfloat16" else (1e-5, 1e-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("xd,od", [("float32", "float32"), ("bfloat16", "bfloat16"), ("float32", "bfloat16")])
def test_dense_w8a16_matches(xd, od):
    rng = np.random.default_rng(5)
    _, w_i8, w_s, b = _layer(rng, 96, 64)
    x = rng.normal(size=(3, 17, 96)).astype(np.float32)
    want = jops.dense_w8a16(
        jnp.asarray(x, JDT[xd]), jnp.asarray(w_i8), jnp.asarray(w_s), jnp.asarray(b),
        out_dtype=JDT[od],
    )
    got = tops.dense_w8a16(
        torch.from_numpy(x).to(TDT[xd]), torch.from_numpy(w_i8), torch.from_numpy(w_s),
        torch.from_numpy(b), out_dtype=TDT[od],
    )
    assert got.dtype == TDT[od]
    if od == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    else:  # one bf16 ulp at |y| < 2
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2 ** -7)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def test_quantize_vision_tower_bit_equal(models):
    """Every array of the reference's quantized tower, bit-equal; the port
    adds only each dense layer's (N, K) copy ``wt`` and the route plan
    ``routes`` (both checked below)."""
    _, variables, tmodel = models
    want = dict(_leaves(jq.quantize_vision_tower(variables, tiny_pair(jow))))
    qp = tq.quantize_vision_tower(tmodel)
    assert set(qp) - {"routes"} == set(jq.quantize_vision_tower(variables, tiny_pair(jow)))
    got = dict(_leaves({k: v for k, v in qp.items() if k != "routes"}))
    transposed = {k + "t" for k in want if k.startswith("layers.") and k.endswith(".w")}
    assert len(transposed) == 4 * len(tmodel.vision.encoder.layers)
    assert set(got) == set(want) | transposed
    for key, w in want.items():
        g = got[key].numpy()
        assert g.dtype == np.asarray(w).dtype, key
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)


def test_quantize_vision_tower_transposes_each_weight_once(models):
    """Each dense layer carries ``wt``: its int8 kernel transposed to (N, K)
    and contiguous, made here once per scorer for K4 (never per call)."""
    _, _, tmodel = models
    qp = tq.quantize_vision_tower(tmodel)
    for lyr in qp["layers"]:
        for name in ("qkv", "o", "fc1", "fc2"):
            w, wt = lyr[name]["w"], lyr[name]["wt"]
            assert wt.dtype == torch.int8 and wt.is_contiguous(), name
            assert wt.shape == (w.shape[1], w.shape[0]), name
            assert torch.equal(wt, w.T), name
            assert wt.data_ptr() != w.data_ptr(), name


def test_quantize_vision_tower_plans_each_route(models):
    """The plan names K4 for a dense layer exactly where K4 takes its (K, N)
    weight: none of the tiny tower's (hidden 32), every one of B/32's (the
    card's smoke run checks its real plan), all but fc2 of L/14 (K = 4096)."""
    from tstar_tpu_torch.kernels.quant_matmul import supported_shape

    _, _, tmodel = models
    qp = tq.quantize_vision_tower(tmodel)
    n = len(tmodel.vision.encoder.layers)
    assert len(qp["routes"]) == n and tq.route_counts(qp) == {"plain": 4 * n}
    for lyr, route in zip(qp["layers"], qp["routes"]):
        assert route == {k: "plain" for k in tq.DENSE}
        assert not any(supported_shape(*lyr[k]["w"].shape) for k in tq.DENSE)
    b32 = {"qkv": (768, 2304), "o": (768, 768), "fc1": (768, 3072), "fc2": (3072, 768)}
    l14 = {"qkv": (1024, 3072), "o": (1024, 1024), "fc1": (1024, 4096), "fc2": (4096, 1024)}
    assert all(supported_shape(*kn) for kn in b32.values())
    assert [k for k, kn in l14.items() if not supported_shape(*kn)] == ["fc2"]


@pytest.mark.parametrize("weight_only,atol", [(False, 5e-2), (True, 2e-5)])
def test_encode_image_int8_matches(models, weight_only, atol):
    _, variables, tmodel = models
    px = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(np.float32)
    cfg_j = tiny_pair(jow)
    want = jq.encode_image_int8(
        jq.quantize_vision_tower(variables, cfg_j), jnp.asarray(px), cfg_j,
        dtype=jnp.float32, weight_only=weight_only,
    )
    got = tq.encode_image_int8(
        tq.quantize_vision_tower(tmodel), torch.from_numpy(px), tmodel.cfg,
        dtype=torch.float32, weight_only=weight_only,
    )
    assert got.shape == (2, 16, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("src,dst", [(24, 16), (24, 20), (24, 32), (4, 3), (4, 4), (4, 6)])
def test_interpolate_position_embedding_matches(src, dst):
    pos = np.random.default_rng(src * dst).normal(size=(1 + src * src, 48)).astype(np.float32)
    want = jow.interpolate_position_embedding(jnp.asarray(pos), src, dst)
    got = tow.interpolate_position_embedding(torch.from_numpy(pos), src, dst)
    assert got.shape == (1 + dst * dst, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_resize_detector_shares_weights_and_matches(models):
    jmodel, variables, tmodel = models
    view = tow.resize_detector(tmodel, 48)
    assert tow.resize_detector(tmodel, 64) is tmodel
    with pytest.raises(ValueError):
        tow.resize_detector(tmodel, 50)
    assert view.cfg.vision.image_size == 48 and view.cfg.vision.num_patches == 9
    old, new = dict(tmodel.named_parameters()), dict(view.named_parameters())
    assert set(old) == set(new)
    for name, p in new.items():
        if name == "vision.position_embedding":
            assert p.shape == (10, 32) and p.data_ptr() != old[name].data_ptr()
        else:
            assert p.data_ptr() == old[name].data_ptr(), name

    jview, jvars = jow.resize_detector(jmodel, variables, 48)
    rng = np.random.default_rng(4)
    px = rng.normal(size=(2, 48, 48, 3)).astype(np.float32)
    q = rng.normal(size=(3, 24)).astype(np.float32)
    jf = jview.apply(jvars, jnp.asarray(px), method=jow.OwlViTDetector.encode_image)
    jl, jb = jview.apply(jvars, jf, jnp.asarray(q), method=jow.OwlViTDetector.predict)
    with torch.no_grad():
        tf = view.encode_image(torch.from_numpy(px))
        tl, tb = view.predict(tf, torch.from_numpy(q))
    assert tf.shape == (2, 9, 32) and tb.shape == (2, 9, 4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=2e-5)
    assert dataclasses.replace(tmodel.cfg.vision, image_size=48) == view.cfg.vision
