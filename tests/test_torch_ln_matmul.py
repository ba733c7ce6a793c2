"""K5 (tstar_tpu_torch/kernels/ln_matmul.py): its plain version against the
reference's Pallas kernel (``interpret=True``, as ``tests/test_ln_matmul.py``
runs it), the port's encoder layer with the fusion forced against the
reference's unfused layer, and the ``TSTAR_LN_MATMUL`` gate.

Tolerances: f32 differs by summation order only (2e-5, the reference test's);
bf16 outputs are rounded twice (product, then + bias), so one bf16 ulp from
another summation order before either rounding: the reference test's 3e-2
absolute + 2e-2 relative.  The encoder layer in bf16 adds the residual
stream (|x| ~ 4, one ulp 3.1e-2) and attention's bf16 probabilities:
6.25e-2 absolute (two ulps at that magnitude) + 2e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu.kernels.ln_matmul import ln_matmul as jax_ln_matmul
from tstar_tpu.models import transformer as jtr
from tstar_tpu_torch.kernels import ln_matmul as kln
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import transformer as ttr


def _params(rng, d, n):
    scale = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    w = (rng.normal(size=(d, n)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    return scale, bias, w, b


@pytest.mark.parametrize("rows,d,n", [(64, 128, 256), (577, 128, 384)])
def test_plain_matches_pallas_f32(rows, d, n):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, rows, d)).astype(np.float32)
    p = _params(rng, d, n)
    want = jax_ln_matmul(jnp.asarray(x), *map(jnp.asarray, p), eps=1e-5, interpret=True)
    got = kln.ln_matmul(torch.from_numpy(x), *map(torch.from_numpy, p), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_matches_pallas_bf16():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 96, 256)).astype(np.float32)
    p = _params(rng, 256, 128)
    want = jax_ln_matmul(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, p), eps=1e-5, interpret=True
    )
    got = kln.ln_matmul(torch.from_numpy(x).to(torch.bfloat16), *map(torch.from_numpy, p), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=3e-2, rtol=2e-2
    )


def test_encoder_layer_forced_fusion_matches_reference(monkeypatch):
    """bf16, D=128 (two heads of 64), fc 256: the port with
    ``TSTAR_LN_MATMUL=force`` (both projections through ``ln_matmul``)
    against the reference layer, which stays unfused on the CPU."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 40, 128)) * 2).astype(np.float32)
    layer = jtr.EncoderLayer(num_heads=2, intermediate_size=256, dtype=jnp.bfloat16)
    variables = layer.init(jax.random.key(3), jnp.asarray(x))
    want = layer.apply(variables, jnp.asarray(x, jnp.bfloat16))

    tlayer = ttr.EncoderLayer(128, 2, 256)
    tlayer.load_state_dict(tow.params_from_jax(variables), strict=True)
    tlayer = tlayer.to(torch.bfloat16).requires_grad_(False)
    calls = []

    def counted(*args, **kw):
        calls.append(args[3].shape)
        return kln.ln_matmul(*args, **kw)

    monkeypatch.setattr(ttr, "ln_matmul", counted)
    monkeypatch.setenv("TSTAR_LN_MATMUL", "force")
    got = tlayer(torch.from_numpy(x).to(torch.bfloat16))
    assert calls == [(128, 384), (128, 256)]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=6.25e-2, rtol=2e-2
    )
    monkeypatch.setenv("TSTAR_LN_MATMUL", "0")
    unfused = tlayer(torch.from_numpy(x).to(torch.bfloat16))
    assert len(calls) == 2
    np.testing.assert_allclose(
        unfused.float().numpy(), np.asarray(want, np.float32), atol=6.25e-2, rtol=2e-2
    )


@pytest.mark.parametrize("env,shape,dtype,n_out,want", [
    (None, (16, 577, 768), torch.bfloat16, 2304, False),   # unset: off
    ("0", (16, 577, 768), torch.bfloat16, 2304, False),
    ("1", (16, 577, 768), torch.bfloat16, 2304, True),     # 9232 rows >= 4096
    ("1", (1, 577, 768), torch.bfloat16, 2304, False),     # 577 rows < 4096
    ("force", (1, 577, 768), torch.bfloat16, 2304, True),
    ("force", (1, 577, 768), torch.float32, 2304, False),  # bf16 only
    ("force", (577, 768), torch.bfloat16, 2304, False),    # 3-d only
    ("force", (1, 577, 768), torch.bfloat16, 100, False),  # 128-multiple widths
    ("force", (1, 577, 96), torch.bfloat16, 256, False),
])
def test_gate(monkeypatch, env, shape, dtype, n_out, want):
    if env is None:
        monkeypatch.delenv("TSTAR_LN_MATMUL", raising=False)
    else:
        monkeypatch.setenv("TSTAR_LN_MATMUL", env)
    assert kln.use_ln_matmul(torch.empty(shape, dtype=dtype, device="meta"), n_out) is want
