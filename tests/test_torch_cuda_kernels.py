"""The port's hand-written kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)  Shapes
are the main path's: S=577 tokens, D=768, 12 heads x 64, at batch 1 (grid
forward), 8 and 16 (verify forwards); 768^2 images with 32-pixel patches;
LayerNorm over 577, 8*577 and 16*577 rows of 768, and 256 rows of 512 (the
text tower).
"""

import pytest
import torch

from tstar_tpu_torch.kernels.attention import (
    fused_mha_from_qkv,
    fused_mha_from_qkv_plain,
)
from tstar_tpu_torch.kernels.layernorm import fused_layernorm, fused_layernorm_plain
from tstar_tpu_torch.kernels.patch_matmul import (
    patch_embed_matmul,
    patch_embed_matmul_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# Card tolerances, as (atol, rtol): pass when |got - want| <= atol +
# rtol * |want| everywhere.  f32 differs from the plain version by summation
# order only.  In bf16 the f32 results before the last rounding differ by
# summation order only, so outputs differ by at most one bf16 ulp, which
# rtol = 2^-7 covers; the attention's atol also covers a rounding flip of one
# of its bf16 probabilities.
_BF16_ULP = 2.0 ** -7
_TOL = {
    "mha": {torch.float32: (1e-6, 1e-5), torch.bfloat16: (1e-3, _BF16_ULP)},
    "patch": {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-4, _BF16_ULP)},
    "ln": {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, _BF16_ULP)},
}


def _assert_close(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    bad = (got - want).abs() > atol + rtol * want.abs()
    assert not bad.any(), f"max abs err {(got - want).abs().max().item():.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(1, 577), (8, 577), (16, 577), (2, 385)])
def test_mha_kernel_matches_plain_on_card(cuda, dtype, b, s):
    """S=385 keeps even f32 K/V resident in shared memory (the branch bf16
    takes at S=577); f32 at S=577 streams K/V in tiles."""
    g = torch.Generator(device=cuda).manual_seed(b)
    qkv = torch.randn(b, s, 3 * 768, generator=g, device=cuda).to(dtype)
    before = fused_mha_from_qkv.launches
    got = fused_mha_from_qkv(qkv, 12)
    torch.cuda.synchronize()
    assert fused_mha_from_qkv.launches == before + 1
    _assert_close(got, fused_mha_from_qkv_plain(qkv, 12), _TOL["mha"][dtype])


def _patch_reference(px, w):
    """The plain version in f32 on the same (rounded) inputs, rounded once
    (cuBLAS's bf16 GEMM may itself reduce in reduced precision)."""
    return patch_embed_matmul_plain(px.float(), w.float()).to(px.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 16])
def test_patch_kernel_matches_plain_on_card(cuda, dtype, b):
    g = torch.Generator(device=cuda).manual_seed(b)
    px = torch.randn(b, 768, 768, 3, generator=g, device=cuda).to(dtype)
    w = (torch.randn(32, 32, 3, 768, generator=g, device=cuda) * 0.02).to(dtype)
    got = patch_embed_matmul(px, w)
    torch.cuda.synchronize()
    _assert_close(got, _patch_reference(px, w), _TOL["patch"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,p,c,d", [(2, 64, 16, 3, 32), (3, 56, 14, 3, 40)])
def test_patch_kernel_other_shapes_on_card(cuda, dtype, b, hw, p, c, d):
    """Small shapes; p*C = 42 is not a multiple of 8, so bf16 takes the
    CUDA-core kernel instead of the tensor-core one."""
    g = torch.Generator(device=cuda).manual_seed(hw)
    px = torch.randn(b, hw, hw, c, generator=g, device=cuda).to(dtype)
    w = (torch.randn(p, p, c, d, generator=g, device=cuda) * 0.05).to(dtype)
    got = patch_embed_matmul(px, w)
    torch.cuda.synchronize()
    assert got.shape == (b, (hw // p) ** 2, d)
    _assert_close(got, _patch_reference(px, w), _TOL["patch"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(577, 768), (8 * 577, 768), (16 * 577, 768), (256, 512)])
def test_layernorm_kernel_matches_plain_on_card(cuda, dtype, rows, d):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = (torch.randn(rows, d, generator=g, device=cuda) * 3 + 1).to(dtype)
    s = torch.randn(d, generator=g, device=cuda)
    bias = torch.randn(d, generator=g, device=cuda)
    got = fused_layernorm(x, s, bias)
    torch.cuda.synchronize()
    _assert_close(got, fused_layernorm_plain(x, s, bias), _TOL["ln"][dtype])
