"""The port's hand-written kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)  Shapes
are the main path's: S=577 tokens, D=768, 12 heads x 64, at batch 1 (grid
forward), 8 and 16 (verify forwards), and S=257 (verify at 512); 768^2 and
512^2 images with 32-pixel patches; LayerNorm over 577, 8*577 and 16*577
rows of 768, and 256 rows of 512 (the text tower), and at 1 and 33 rows in
bf16, f16 and f32; the int8 tower's four dense layers (K4, reading the
weight's (N, K) copy) and the two LayerNorm->matmul folds (K5) at 577, 16*257
and 16*577 rows; the grid inputs (K6, K7) over a 192x384 cache (identity
height) and a 180x320 one (resized height) into 4x4 cells of 192^2 (K6
also at B=3, patch 16, D=512 and 320, and patch 8 on the WMMA kernel; K7
also into a 772^2 canvas, 2316 values a row); flash
attention (K8) on the fused projection's strided views.  The attention
kernels (K1, K8) also run at the edges of their 64-key tiles (S=64, 65), at
S=1000, where the bf16 kernel's K/V ring streams, and at B=32.
"""

import pytest
import torch

from tstar_tpu_torch.kernels.attention import (
    flash_mha,
    flash_mha_plain,
    fused_mha_from_qkv,
    fused_mha_from_qkv_plain,
)
from tstar_tpu_torch.kernels.grid_embed import (
    _height_matrix,
    _width_affine,
    grid_cell_embed,
    grid_cell_embed_plain,
    grid_embed_config,
)
from tstar_tpu_torch.kernels.layernorm import fused_layernorm, fused_layernorm_plain
from tstar_tpu_torch.kernels.ln_matmul import bf16_error_bound, ln_matmul, ln_matmul_plain
from tstar_tpu_torch.kernels.pallas_grid import (
    build_detector_grid_pallas,
    build_detector_grid_pallas_plain,
)
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
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    assert not bad.any(), (
        f"max abs err {err.max().item():.3e}; {int(bad.sum())} outside the tolerance, worst "
        f"{err[bad].max().item():.3e} where the reference is {want[bad][err[bad].argmax()].item():.6e}"
    )


# (B, S) of the attention cases: the main path's (S=577 at B=1, 8, 16; S=257
# at B=16), a last key tile of one valid key (577 and 257 both), the tile
# edges S=64 and 65, S=70 and 385, S=1000 (the bf16 kernel's K/V no longer fit
# in shared memory and stream through a ring) and B=32.
_ATTN_SHAPES = [(1, 577), (8, 577), (16, 577), (16, 257), (2, 385), (2, 70), (1, 64), (1, 65),
                (2, 1000), (32, 577)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", _ATTN_SHAPES)
def test_mha_kernel_matches_plain_on_card(cuda, dtype, b, s, monkeypatch):
    """f32: S=385 keeps K/V resident in shared memory, S=577 streams them in
    tiles.  bf16: the wgmma kernel keeps the head's K/V resident up to
    S=832."""
    monkeypatch.delenv("TSTAR_MHA_P16", raising=False)
    g = torch.Generator(device=cuda).manual_seed(b)
    qkv = torch.randn(b, s, 3 * 768, generator=g, device=cuda).to(dtype)
    before = fused_mha_from_qkv.launches
    got = fused_mha_from_qkv(qkv, 12)
    torch.cuda.synchronize()
    assert fused_mha_from_qkv.launches == before + 1
    _assert_close(got, fused_mha_from_qkv_plain(qkv, 12), _TOL["mha"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(1, 577), (16, 257), (2, 1000)])
def test_mha_p16_kernel_matches_plain_on_card(cuda, b, s, monkeypatch):
    """``TSTAR_MHA_P16=1``: the row sum of the rounded probabilities, in the
    kernel and in the plain version; bf16's tolerance."""
    monkeypatch.setenv("TSTAR_MHA_P16", "1")
    g = torch.Generator(device=cuda).manual_seed(s)
    qkv = torch.randn(b, s, 3 * 768, generator=g, device=cuda).to(torch.bfloat16)
    before = fused_mha_from_qkv.launches
    got = fused_mha_from_qkv(qkv, 12)
    torch.cuda.synchronize()
    assert fused_mha_from_qkv.launches == before + 1
    _assert_close(got, fused_mha_from_qkv_plain(qkv, 12), _TOL["mha"][torch.bfloat16])


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
    """Small shapes; in bf16, p*C = 48 (a multiple of 16) takes the wgmma
    kernel in 16-value segments, 42 the CUDA-core kernel."""
    g = torch.Generator(device=cuda).manual_seed(hw)
    px = torch.randn(b, hw, hw, c, generator=g, device=cuda).to(dtype)
    w = (torch.randn(p, p, c, d, generator=g, device=cuda) * 0.05).to(dtype)
    got = patch_embed_matmul(px, w)
    torch.cuda.synchronize()
    assert got.shape == (b, (hw // p) ** 2, d)
    _assert_close(got, _patch_reference(px, w), _TOL["patch"][dtype])
    cfg = _patch_config(b, hw, c, p, d)
    assert (cfg[0] > 0) == ((p * c) % 16 == 0)


def _patch_config(b, hw, c, p, d):
    """The bf16 wgmma kernel's launch configuration for a shape (all 0 where
    the CUDA-core kernel takes it): CTAs, columns, stages, shared memory, K
    chunks a stage, values a chunk."""
    import ctypes

    from tstar_tpu_torch.kernels import _build

    cfg = (ctypes.c_int * 6)()
    _build.check(_build.load().tstar_patch_embed_config(b, hw, hw, c, p, d, cfg),
                 "tstar_patch_embed_config")
    return list(cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,p,c,d,pk", [(1, 768, 16, 3, 768, 16), (2, 224, 14, 16, 64, 32),
                                           (2, 224, 14, 8, 64, 16)])
def test_patch_kernel_segments_on_card(cuda, b, hw, p, c, d, pk):
    """bf16 wgmma kernel beyond the main path's 96-value (pw, c) runs: patch
    16 RGB (48 values: three 16-value segments, 32-byte swizzle), and runs of
    224 and 112 values at patch 14, whose 98 chunks leave the last stage part
    empty (TMA fills the chunks past the last with zeros)."""
    g = torch.Generator(device=cuda).manual_seed(p * c)
    px = torch.randn(b, hw, hw, c, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(p, p, c, d, generator=g, device=cuda) * (p * p * c) ** -0.5).to(torch.bfloat16)
    cfg = _patch_config(b, hw, c, p, d)
    assert cfg[0] > 0 and cfg[5] == pk
    before = patch_embed_matmul.launches
    got = patch_embed_matmul(px, w)
    torch.cuda.synchronize()
    assert patch_embed_matmul.launches == before + 1
    assert got.shape == (b, (hw // p) ** 2, d)
    _assert_close(got, _patch_reference(px, w), _TOL["patch"][torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw", [(3, 768), (8, 512), (5, 448)])
def test_patch_kernel_ragged_tiles_on_card(cuda, b, hw):
    """bf16 wgmma kernel at batches whose patch rows do not fill its 16 x 8
    patch tiles: B=3 at 768^2 (72 patch rows, M = 1728, not a multiple of
    its 128-patch tiles), B=8 at 512^2 (verification at 512, 64-column
    tiles) and 448^2 (14 x 14 patches: both tile edges ragged)."""
    g = torch.Generator(device=cuda).manual_seed(b * hw)
    px = torch.randn(b, hw, hw, 3, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(32, 32, 3, 768, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    before = patch_embed_matmul.launches
    got = patch_embed_matmul(px, w)
    torch.cuda.synchronize()
    assert patch_embed_matmul.launches == before + 1
    assert got.shape == (b, (hw // 32) ** 2, 768)
    _assert_close(got, _patch_reference(px, w), _TOL["patch"][torch.bfloat16])


def _record_weight_pointer(monkeypatch, entry):
    """Records the weight pointer (second / fourth argument) that reaches the
    C entry point ``entry`` of the kernel library."""
    from tstar_tpu_torch.kernels import _build

    lib = _build.load()
    fn, seen = getattr(lib, entry), []

    def recording(*args):
        seen.append(args)
        return fn(*args)

    monkeypatch.setattr(lib, entry, recording)
    return seen


@pytest.mark.cuda
def test_patch_and_ln_matmul_read_the_weight_in_place_on_card(cuda, monkeypatch):
    """K2 and K5 read the bf16 (K, N) weight as it is stored: the pointer that
    reaches the kernel is the weight's own (no transposed or cast copy), and
    a launch allocates its output and nothing else of that size."""
    g = torch.Generator(device=cuda).manual_seed(7)
    px = torch.randn(1, 768, 768, 3, generator=g, device=cuda).to(torch.bfloat16)
    w2 = (torch.randn(32, 32, 3, 768, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    x = torch.randn(1, 577, 768, generator=g, device=cuda).to(torch.bfloat16)
    scale, bias = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    w5 = (torch.randn(768, 2304, generator=g, device=cuda) * 0.036).to(torch.bfloat16)
    b5 = torch.zeros(2304, device=cuda).to(torch.bfloat16)
    patch_embed_matmul(px, w2)
    ln_matmul(x, scale, bias, w5, b5, 1e-5)
    torch.cuda.synchronize()
    k2 = _record_weight_pointer(monkeypatch, "tstar_patch_embed_bf16")
    k5 = _record_weight_pointer(monkeypatch, "tstar_ln_matmul_bf16")
    for run, weight_bytes in ((lambda: patch_embed_matmul(px, w2), w2.numel() * 2),
                              (lambda: ln_matmul(x, scale, bias, w5, b5, 1e-5), w5.numel() * 2)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = run()
        torch.cuda.synchronize()
        out_bytes = got.numel() * got.element_size()
        assert torch.cuda.max_memory_allocated() - before < out_bytes + weight_bytes // 2
    assert [a[1] for a in k2] == [w2.data_ptr()]
    assert [a[3] for a in k5] == [w5.data_ptr()]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [512, 768])
@pytest.mark.parametrize("rows", [1, 33, 577, 16 * 577])
def test_layernorm_kernel_rows_and_dtypes_on_card(cuda, rows, d, dtype):
    """K3 at one row, a ragged last CTA (33 rows, 8 a CTA), a grid forward
    and a wide verify forward; the text tower's and the vision tower's
    widths; every dtype it takes.  f16 keeps bf16's tolerance (its ulp is
    smaller).  Scale and bias already in x's dtype, as the towers hold them."""
    g = torch.Generator(device=cuda).manual_seed(rows * d)
    x = (torch.randn(rows, d, generator=g, device=cuda) * 3 + 1).to(dtype)
    s = torch.randn(d, generator=g, device=cuda).to(dtype)
    bias = torch.randn(d, generator=g, device=cuda).to(dtype)
    before = fused_layernorm.launches
    got = fused_layernorm(x, s, bias)
    torch.cuda.synchronize()
    assert fused_layernorm.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    tol = _TOL["ln"][torch.float32 if dtype == torch.float32 else torch.bfloat16]
    _assert_close(got, fused_layernorm_plain(x, s, bias), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [128, 384, 1152, 2304, 4096])
@pytest.mark.parametrize("rows", [1, 33, 74])
def test_layernorm_kernel_reference_widths_on_card(cuda, rows, d, dtype):
    """K3 at the widths the reference's kernel takes beyond the towers' (a
    multiple of 128): held in registers (128 and 384 in f32) or read twice
    (every other case here); SigLIP's 1152 at its two sequences of 37 rows."""
    g = torch.Generator(device=cuda).manual_seed(rows * d)
    x = (torch.randn(rows, d, generator=g, device=cuda) * 3 + 1).to(dtype)
    s = torch.randn(d, generator=g, device=cuda).to(dtype)
    bias = torch.randn(d, generator=g, device=cuda).to(dtype)
    before = fused_layernorm.launches
    got = fused_layernorm(x, s, bias)
    torch.cuda.synchronize()
    assert fused_layernorm.launches == before + 1
    tol = _TOL["ln"][torch.float32 if dtype == torch.float32 else torch.bfloat16]
    _assert_close(got, fused_layernorm_plain(x, s, bias), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(200, torch.bfloat16), (100, torch.float32),
                                     (1160, torch.bfloat16), (64, torch.float32)])
def test_layernorm_kernel_raises_on_other_widths_on_card(cuda, d, dtype):
    """A width the reference's kernel does not take (not a multiple of 128)
    raises: no fallback."""
    x = torch.ones(4, d, device=cuda, dtype=dtype)
    before = fused_layernorm.launches
    with pytest.raises(ValueError, match="does not take"):
        fused_layernorm(x, torch.ones(d, device=cuda), torch.zeros(d, device=cuda))
    assert fused_layernorm.launches == before


# K4: the int8 tower's dense layers, (K, N, input dtype, output dtype).
_W8A8_LAYERS = [
    (768, 2304, torch.float32, torch.bfloat16),   # qkv
    (768, 768, torch.bfloat16, torch.bfloat16),   # out_proj
    (768, 3072, torch.float32, torch.float32),    # fc1
    (3072, 768, torch.float32, torch.bfloat16),   # fc2
]


def _w8a8_inputs(cuda, rows, k, n, xd):
    """x, the (K, N) int8 kernel, its (N, K) copy (made once, here), scales
    and bias."""
    g = torch.Generator(device=cuda).manual_seed(rows + k + n)
    x = (torch.randn(rows, k, generator=g, device=cuda) * 3).to(xd)
    w = torch.randint(-127, 128, (k, n), generator=g, device=cuda).to(torch.int8)
    ws = torch.rand(n, generator=g, device=cuda) * 1e-3
    b = torch.randn(n, generator=g, device=cuda) * 0.1
    return x, w, w.T.contiguous(), ws, b


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [577, 16 * 257, 16 * 577, 33])
@pytest.mark.parametrize("k,n,xd,od", _W8A8_LAYERS)
def test_w8a8_kernel_equals_plain_on_card(cuda, rows, k, n, xd, od):
    """Exactly equal: the integer product is exact and the divisions and the
    epilogue round as the plain version's.  33 rows: a ragged row tile.  The
    kernel reads the (N, K) copy of the weight, the plain version the (K, N)
    kernel."""
    x, w, wt, ws, b = _w8a8_inputs(cuda, rows, k, n, xd)
    before = w8a8_matmul.launches
    got = w8a8_matmul(x, w, ws, b, od, w_t=wt)
    torch.cuda.synchronize()
    assert w8a8_matmul.launches == before + 1
    assert got.dtype == od and got.shape == (rows, n)
    want = w8a8_matmul_plain(x, w, ws, b, od)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want), f"max abs err {(got.float() - want.float()).abs().max().item():.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,xd,od", _W8A8_LAYERS)
def test_w8a8_kernel_equals_plain_at_half_steps_on_card(cuda, k, n, xd, od):
    """Inputs at and one ulp around (j + 1/2) quantization steps, where
    x / xs lies within a few ulps of a rounding boundary: the kernel's
    multiply by 1 / xs must hand these to the IEEE quotient and round as
    the plain version does."""
    g = torch.Generator(device=cuda).manual_seed(k + 3 * n)
    rows = 97
    amax = torch.rand(rows, 1, generator=g, device=cuda) * 10 + 0.1
    xs = amax / torch.full_like(amax, 127.0)
    j = torch.randint(-127, 127, (rows, k), generator=g, device=cuda).float()
    x = (j + 0.5) * xs
    step = torch.randint(-1, 2, (rows, k), generator=g, device=cuda).float()
    x = torch.nextafter(x, x + step * x.abs().clamp_min(1e-30))
    x[:, 0] = amax[:, 0]                       # the row's absmax, as above
    x = x.to(xd)
    _, w, wt, ws, b = _w8a8_inputs(cuda, rows, k, n, xd)
    got = w8a8_matmul(x, w, ws, b, od, w_t=wt)
    torch.cuda.synchronize()
    want = w8a8_matmul_plain(x, w, ws, b, od)
    assert torch.equal(got, want), f"max abs err {(got.float() - want.float()).abs().max().item():.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,xd,od", _W8A8_LAYERS)
def test_w8a8_launch_transposes_no_weight_on_card(cuda, k, n, xd, od):
    """A launch allocates its output and nothing else: no per-call copy or
    transpose of the weight (fc1's would be 2.4 MB), of x or of the f32
    scale and bias."""
    x, w, wt, ws, b = _w8a8_inputs(cuda, 577, k, n, xd)
    w8a8_matmul(x, w, ws, b, od, w_t=wt)   # the library is loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = w8a8_matmul(x, w, ws, b, od, w_t=wt)
    torch.cuda.synchronize()
    out_bytes = got.numel() * got.element_size()
    assert torch.cuda.max_memory_allocated() - before <= -(-out_bytes // 512) * 512


@pytest.mark.cuda
def test_w8a8_kernel_needs_the_transposed_weight_on_card(cuda):
    """Without ``w_t`` (or with the (K, N) kernel in its place) the wrapper
    raises rather than transposing per call."""
    x, w, _, ws, b = _w8a8_inputs(cuda, 33, 768, 768, torch.bfloat16)
    before = w8a8_matmul.launches
    with pytest.raises(ValueError, match="w_t"):
        w8a8_matmul(x, w, ws, b, torch.bfloat16)
    with pytest.raises(ValueError, match="transpose"):
        w8a8_matmul(x, w[:, :384], ws[:384], b[:384], torch.bfloat16, w_t=w[:, :384])
    assert w8a8_matmul.launches == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 33, 8 * 577, 16 * 257])
@pytest.mark.parametrize("n", [2304, 3072])
def test_ln_matmul_kernel_ragged_rows_on_card(cuda, rows, n):
    """K5 at one row, a ragged 64-row slab (33), the 8-image verify forward
    and 16 x 257 (4112 rows, verification at 512), within
    ``bf16_error_bound``."""
    g = torch.Generator(device=cuda).manual_seed(rows * 7 + n)
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


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(1152, 3456), (256, 128)])
def test_ln_matmul_kernel_other_widths_on_card(cuda, d, n):
    """K5 at widths other than the towers' 768 (the kernel's two-pass row
    path): SigLIP's 1152 -> 3456 q|k|v and the smallest it takes."""
    g = torch.Generator(device=cuda).manual_seed(d + n)
    x = (torch.randn(2, 70, d, generator=g, device=cuda) * 3 + 1).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    bias = 0.1 * torch.randn(d, generator=g, device=cuda)
    w = (torch.randn(d, n, generator=g, device=cuda) * d ** -0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(n, generator=g, device=cuda)).to(torch.bfloat16)
    got = ln_matmul(x, scale, bias, w, b, 1e-6)
    torch.cuda.synchronize()
    want = ln_matmul_plain(x, scale, bias, w, b, 1e-6)
    err = (got.float() - want.float()).abs()
    bound = bf16_error_bound(x, scale, bias, w, b, 1e-6, want)
    assert bool((err <= bound).all()), f"max abs err {err.max().item():.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(768, 100), (704, 256), (1664, 256)])
def test_ln_matmul_kernel_raises_on_other_shapes_on_card(cuda, d, n):
    """A width the kernel does not take raises: no fallback."""
    x = torch.ones(1, 4, d, device=cuda, dtype=torch.bfloat16)
    w = torch.ones(d, n, device=cuda, dtype=torch.bfloat16)
    before = ln_matmul.launches
    with pytest.raises(ValueError, match="multiples of 128"):
        ln_matmul(x, torch.ones(d, device=cuda), torch.zeros(d, device=cuda), w,
                  torch.zeros(n, device=cuda, dtype=torch.bfloat16), 1e-5)
    assert ln_matmul.launches == before


def _frames(cuda, seed, n, hw):
    g = torch.Generator(device=cuda).manual_seed(seed)
    cache = torch.randint(0, 256, (n, *hw, 3), generator=g, device=cuda, dtype=torch.int32)
    secs = torch.randperm(n, generator=g, device=cuda)[:16]
    return cache.to(torch.uint8), secs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(192, 384), (180, 320)])
def test_grid_pack_kernel_ragged_rows_on_card(cuda, dtype, hw):
    """K7 into a 772^2 canvas: 4x4 cells of 193, 2316 values a row, not a
    multiple of the kernel's 8-value vectors (rows not 16-byte aligned in
    bf16: stored value by value).  The tolerances of the main shapes."""
    cache, secs = _frames(cuda, 2, 640, hw)
    before = build_detector_grid_pallas.launches
    got = build_detector_grid_pallas(cache, secs, (4, 4), 772, dtype)
    torch.cuda.synchronize()
    assert build_detector_grid_pallas.launches == before + 1
    assert got.shape == (1, 772, 772, 3) and got.dtype == dtype
    want = build_detector_grid_pallas_plain(cache, secs, (4, 4), 772, dtype)
    _assert_close(got, want, (1e-5, 1e-5) if dtype == torch.float32 else (1e-6, _BF16_ULP))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(192, 384), (180, 320)])
def test_grid_pack_kernel_matches_plain_on_card(cuda, dtype, hw):
    """K7: f32 within 1e-5 (the same 2-4 tap products summed in another
    order); bf16 within one ulp of the same value, plus 1e-6 where ``* scale
    + bias`` cancels to near 0 and bf16 keeps the f32 difference."""
    cache, secs = _frames(cuda, 1, 640, hw)
    before = build_detector_grid_pallas.launches
    got = build_detector_grid_pallas(cache, secs, (4, 4), 768, dtype)
    torch.cuda.synchronize()
    assert build_detector_grid_pallas.launches == before + 1
    assert got.shape == (1, 768, 768, 3) and got.dtype == dtype
    want = build_detector_grid_pallas_plain(cache, secs, (4, 4), 768, dtype)
    _assert_close(got, want, (1e-5, 1e-5) if dtype == torch.float32 else (1e-6, _BF16_ULP))


def _grid_embed_inputs(cuda, seed, b, hw, p=32, d=768, n=640, cell=192):
    """A seeded (B, n, *hw, 3) cache, (B, 16) seconds and a (p, p, 3, d)
    bf16 patch kernel, with the width / height matrices of 4x4 cells of
    ``cell``^2; -> (args, keywords) of ``grid_cell_embed``."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    cache = torch.randint(0, 256, (b, n, *hw, 3), generator=g, device=cuda,
                          dtype=torch.int32).to(torch.uint8)
    secs = torch.randint(0, n, (b, 16), generator=g, device=cuda)
    w = (torch.randn(p, p, 3, d, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    awk, bias = (torch.from_numpy(t).to(cuda) for t in _width_affine(hw[1], cell))
    ah = _height_matrix(hw[0], cell)
    ah = None if ah is None else torch.from_numpy(ah).to(cuda)
    kw = dict(grid_shape=(4, 4), cell_hw=(cell, cell), patch_size=p)
    return (cache, secs, awk, bias, ah, w), kw


def _grid_embed_checked(args, kw):
    """One K6 launch, counted, held to the plain version: the canvas values
    round as the plain version's; the bf16 patch GEMM sums its products in
    another order (and across a cluster's K parts): one bf16 ulp plus 1e-4."""
    before = grid_cell_embed.launches
    got = grid_cell_embed(*args, **kw)
    torch.cuda.synchronize()
    assert grid_cell_embed.launches == before + 1
    b, d, p = args[0].shape[0], args[5].shape[-1], kw["patch_size"]
    cell_h, cell_w = kw["cell_hw"]
    assert got.shape == (b, 16 * (cell_h // p) * (cell_w // p), d)
    assert got.dtype == torch.bfloat16
    _assert_close(got, grid_cell_embed_plain(*args, **kw), (1e-4, _BF16_ULP))
    return got


def _grid_embed_cfg(args, kw):
    cache, _, _, _, ah, w = args
    return grid_embed_config(cache.shape[0], tuple(cache.shape[2:4]), kw["grid_shape"],
                             kw["cell_hw"], kw["patch_size"], w.shape[-1], ah is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw", [(1, (192, 384)), (16, (192, 384)), (1, (180, 320))])
def test_grid_embed_kernel_matches_plain_on_card(cuda, b, hw):
    """K6 at the main path's shapes, on the wgmma kernel (32-value chunks):
    the canvas values round as the plain version's; the bf16 patch GEMM
    sums 3072 products in another order: one bf16 ulp plus 1e-4."""
    args, kw = _grid_embed_inputs(cuda, b, b, hw)
    cfg = _grid_embed_cfg(args, kw)
    assert cfg["ctas"] > 0 and cfg["pk"] == 32 and cfg["columns"] == 256
    _grid_embed_checked(args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,p,d", [(3, (192, 384), 32, 768), (1, (192, 384), 16, 768),
                                      (2, (180, 320), 16, 768), (1, (192, 384), 32, 512),
                                      (1, (180, 320), 32, 320)])
def test_grid_embed_kernel_other_shapes_on_card(cuda, b, hw, p, d):
    """K6's wgmma kernel beyond the main path: B=3 (M = 1728 patches, a
    ragged last 128-row tile), patch 16 (48-value runs in 16-value chunks,
    32-byte swizzle; with and without the height taps), D=512 (two 256-column
    tiles) and D=320 (a ragged last column tile).  A second launch gives the
    same bits: a cluster sums its K parts in a fixed order."""
    args, kw = _grid_embed_inputs(cuda, 100 + b * p + d, b, hw, p=p, d=d)
    cfg = _grid_embed_cfg(args, kw)
    assert cfg["ctas"] > 0 and cfg["pk"] == (32 if p == 32 else 16)
    assert cfg["split"] in (1, 2, 4, 8) and p % cfg["split"] == 0
    got = _grid_embed_checked(args, kw)
    assert torch.equal(got, grid_cell_embed(*args, **kw))


@pytest.mark.cuda
def test_grid_embed_small_patch_takes_the_wmma_kernel_on_card(cuda):
    """Patch 8 on 192^2 cells: a (pw, c) run of 24 values, not a multiple of
    16, so the shape rule sends it to the WMMA kernel (its configuration
    reads all 0), which agrees with the plain version as well."""
    args, kw = _grid_embed_inputs(cuda, 8, 1, (192, 384), p=8)
    assert set(_grid_embed_cfg(args, kw).values()) == {0}
    _grid_embed_checked(args, kw)


@pytest.mark.cuda
def test_grid_kernels_read_int32_and_int64_seconds_on_card(cuda):
    """K6 and K7 read the seconds as given, int64 (the search's) or int32,
    with the same results."""
    args, kw = _grid_embed_inputs(cuda, 5, 1, (192, 384))
    secs = args[1]
    k6 = [grid_cell_embed(args[0], s, *args[2:], **kw) for s in (secs, secs.to(torch.int32))]
    cache, fsecs = _frames(cuda, 5, 64, (192, 384))
    k7 = [build_detector_grid_pallas(cache, s, (4, 4), 768) for s in (fsecs, fsecs.to(torch.int32))]
    torch.cuda.synchronize()
    assert secs.dtype == fsecs.dtype == torch.int64
    assert torch.equal(*k6) and torch.equal(*k7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", _ATTN_SHAPES)
def test_flash_kernel_matches_plain_on_card(cuda, dtype, b, s):
    """K8 on (B, S, 12, 64) views into a (B, S, 3*768) projection.  f32: sums
    and exp in other orders, (1e-5, 1e-5).  bf16: the kernel rounds the
    normalized probabilities, as the plain version (and the reference) do, so
    K1's tolerance holds: one bf16 ulp of the output plus 1e-3 for a rounding
    flip of one probability."""
    g = torch.Generator(device=cuda).manual_seed(b * s)
    qkv = torch.randn(b, s, 3 * 768, generator=g, device=cuda).to(dtype)
    q, k, v = (t.view(b, s, 12, 64) for t in qkv.split(768, dim=-1))
    before = flash_mha.launches
    got = flash_mha(q, k, v)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    assert got.shape == (b, s, 12, 64) and got.dtype == dtype
    _assert_close(got, flash_mha_plain(q, k, v), _TOL["mha"][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["separate", "heads_major"])
@pytest.mark.parametrize("b,s", [(1, 577), (3, 130)])
def test_flash_kernel_on_other_strides_on_card(cuda, b, s, layout):
    """bf16 K8 on q, k, v that are not views into one projection: three
    contiguous (B, S, 12, 64) tensors (sequence stride 768), or three
    (B, 12, S, 64) tensors transposed (head stride S*64, larger than the
    sequence stride)."""
    g = torch.Generator(device=cuda).manual_seed(s)
    shape = (b, s, 12, 64) if layout == "separate" else (b, 12, s, 64)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    if layout == "heads_major":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    got = flash_mha(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (b, s, 12, 64)
    _assert_close(got, flash_mha_plain(q, k, v), _TOL["mha"][torch.bfloat16])


@pytest.mark.cuda
def test_flash_bf16_rounds_where_the_reference_does_on_card(cuda):
    """K8 in bf16 rounds the normalized probabilities, as ``flash_mha_plain``
    and the reference do: at the grid forward's shape every output is within
    K1's tolerance (one bf16 ulp plus 1e-3), and at least 99% are bit-equal
    to the plain version (only f32 summation orders differ; a kernel that
    rounded the unnormalized probabilities matched on ~0.1%)."""
    g = torch.Generator(device=cuda).manual_seed(577)
    qkv = torch.randn(1, 577, 3 * 768, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (t.view(1, 577, 12, 64) for t in qkv.split(768, dim=-1))
    got = flash_mha(q, k, v)
    torch.cuda.synchronize()
    want = flash_mha_plain(q, k, v)
    _assert_close(got, want, _TOL["mha"][torch.bfloat16])
    assert (got == want).float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_siglip_width_layer_on_card(cuda, dtype, monkeypatch):
    """An ``EncoderLayer`` at SigLIP's D = 1152, 16 heads x 72, on the card
    against the same layer on the CPU: both LayerNorms launch K3 (1152 is
    9 x 128, as the reference's kernel takes it), the 72-wide heads take the
    plain split-head route (the reference's XLA), the projections are
    cuBLAS's.  f32: summation order only, 1e-4 absolute + 1e-4 relative.
    bf16: two ulps of the residual stream's magnitude (6.25e-2) + 2e-2
    relative, as ``tests/test_torch_widths.py`` holds the CPU layer to the
    reference."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models.transformer import EncoderLayer

    for var in ("TSTAR_FUSED_MHA", "TSTAR_FLASH_ATTENTION", "TSTAR_ATTN_PROBS_BF16",
                "TSTAR_LN_MATMUL"):
        monkeypatch.delenv(var, raising=False)
    torch.manual_seed(0)
    layer = EncoderLayer(1152, 16, 4304, eps=1e-6).requires_grad_(False)
    for name, p in layer.named_parameters():
        if "kernel" in name:
            torch.nn.init.normal_(p, std=p.shape[0] ** -0.5)
        else:
            torch.nn.init.normal_(p, mean=1.0 if "scale" in name else 0.0, std=0.1)
    layer = layer.to(dtype)
    x = (2 * torch.randn(2, 37, 1152)).to(dtype)
    want = layer(x)
    reset_launch_counts()
    got = layer.to(cuda)(x.to(cuda))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_layernorm"] == 2
    assert all(v == 0 for k, v in counts.items() if k != "fused_layernorm")
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (6.25e-2, 2e-2)
    _assert_close(got.cpu(), want, tol)


@pytest.mark.cuda
def test_b32_towers_launch_k1_and_k3_on_every_layer_on_card(cuda, monkeypatch):
    """OWL-ViT B/32 at full width in bf16: the width gates leave every
    LayerNorm of both towers on K3 and every unbiased attention (the vision
    tower's 12) on K1; the text tower's causal attention has a bias and takes
    the plain route, as in the reference."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models import transformer
    from tstar_tpu_torch.models.owlvit import OwlViTDetector, init_params, owlvit_base_patch32

    for var in ("TSTAR_FUSED_MHA", "TSTAR_LN_MATMUL", "TSTAR_FLASH_ATTENTION"):
        monkeypatch.delenv(var, raising=False)
    cfg = owlvit_base_patch32()
    model = init_params(OwlViTDetector(cfg), seed=0).requires_grad_(False).to(cuda, torch.bfloat16)
    norms = []
    apply_ln = transformer.apply_layernorm

    def counted(x, *args):
        norms.append(x.shape[-1])
        return apply_ln(x, *args)

    monkeypatch.setattr(transformer, "apply_layernorm", counted)
    px = torch.randn(1, 768, 768, 3, device=cuda).to(torch.bfloat16)
    ids = torch.randint(1, cfg.text.vocab_size, (2, cfg.text.max_length), device=cuda)
    mask = torch.ones_like(ids)
    for run, layers, attn in ((lambda: model.encode_image(px), cfg.vision.num_layers,
                               cfg.vision.num_layers),
                              (lambda: model.encode_text(ids, mask), cfg.text.num_layers, 0)):
        norms.clear()
        reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        counts = launch_counts()
        assert bool(torch.isfinite(out.float()).all())
        assert len(norms) >= 2 * layers + 1
        assert counts["fused_layernorm"] == len(norms)
        assert counts["fused_mha_from_qkv"] == attn
