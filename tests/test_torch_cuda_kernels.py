"""The port's hand-written kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)  Shapes
are the main path's: S=577 tokens, D=768, 12 heads x 64, at batch 1 (grid
forward), 8 and 16 (verify forwards), and S=257 (verify at 512); 768^2 and
512^2 images with 32-pixel patches; LayerNorm over 577, 8*577 and 16*577
rows of 768, and 256 rows of 512 (the text tower); the int8 tower's four
dense layers (K4) and the two LayerNorm->matmul folds (K5) at 577, 16*257
and 16*577 rows.
"""

import pytest
import torch

from tstar_tpu_torch.kernels.attention import (
    fused_mha_from_qkv,
    fused_mha_from_qkv_plain,
)
from tstar_tpu_torch.kernels.layernorm import fused_layernorm, fused_layernorm_plain
from tstar_tpu_torch.kernels.ln_matmul import bf16_error_bound, ln_matmul, ln_matmul_plain
from tstar_tpu_torch.kernels.patch_matmul import (
    patch_embed_matmul,
    patch_embed_matmul_plain,
)
from tstar_tpu_torch.kernels.quant_matmul import w8a8_matmul, w8a8_matmul_plain


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
@pytest.mark.parametrize("b,s", [(1, 577), (8, 577), (16, 577), (2, 385), (16, 257)])
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
@pytest.mark.parametrize("b,hw", [(1, 768), (8, 768), (16, 768), (16, 512)])
def test_patch_kernel_matches_plain_on_card(cuda, dtype, b, hw):
    g = torch.Generator(device=cuda).manual_seed(b)
    px = torch.randn(b, hw, hw, 3, generator=g, device=cuda).to(dtype)
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


# K4: the int8 tower's dense layers, (K, N, input dtype, output dtype).
_W8A8_LAYERS = [
    (768, 2304, torch.float32, torch.bfloat16),   # qkv
    (768, 768, torch.bfloat16, torch.bfloat16),   # out_proj
    (768, 3072, torch.float32, torch.float32),    # fc1
    (3072, 768, torch.float32, torch.bfloat16),   # fc2
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [577, 16 * 257, 16 * 577, 33])
@pytest.mark.parametrize("k,n,xd,od", _W8A8_LAYERS)
def test_w8a8_kernel_equals_plain_on_card(cuda, rows, k, n, xd, od):
    """Exactly equal: the integer product is exact and the divisions and the
    epilogue round as the plain version's.  33 rows: a ragged row tile."""
    g = torch.Generator(device=cuda).manual_seed(rows + k + n)
    x = (torch.randn(rows, k, generator=g, device=cuda) * 3).to(xd)
    w = torch.randint(-127, 128, (k, n), generator=g, device=cuda).to(torch.int8)
    ws = torch.rand(n, generator=g, device=cuda) * 1e-3
    b = torch.randn(n, generator=g, device=cuda) * 0.1
    before = w8a8_matmul.launches
    got = w8a8_matmul(x, w, ws, b, od)
    torch.cuda.synchronize()
    assert w8a8_matmul.launches == before + 1
    assert got.dtype == od and got.shape == (rows, n)
    want = w8a8_matmul_plain(x, w, ws, b, od)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want), f"max abs err {(got.float() - want.float()).abs().max().item():.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [577, 16 * 577, 70])
@pytest.mark.parametrize("n", [2304, 3072])
def test_ln_matmul_kernel_matches_plain_on_card(cuda, rows, n):
    """bf16, D = 768 (ln1 -> qkv, ln2 -> fc1), within ``bf16_error_bound``:
    rounding flips of the normalized row and of the product, whose f32 sums
    run in another order than the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(rows + n)
    x = (torch.randn(1, rows, 768, generator=g, device=cuda) * 3 + 1).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(768, generator=g, device=cuda)
    bias = 0.1 * torch.randn(768, generator=g, device=cuda)
    w = (torch.randn(768, n, generator=g, device=cuda) * 0.036).to(torch.bfloat16)
    b = (0.1 * torch.randn(n, generator=g, device=cuda)).to(torch.bfloat16)
    before = ln_matmul.launches
    got = ln_matmul(x, scale, bias, w, b, 1e-5)
    torch.cuda.synchronize()
    assert ln_matmul.launches == before + 1
    want = ln_matmul_plain(x, scale, bias, w, b, 1e-5)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    bound = bf16_error_bound(x, scale, bias, w, b, 1e-5, want)
    assert bool((err <= bound).all()), f"max abs err {err.max().item():.3e}"
