"""Slice 3's detector-input routes against the JAX reference on the CPU:
K7's plain version (``kernels/pallas_grid.py``) against the reference kernel
in interpret mode, K6's plain version (``kernels/grid_embed.py``) against
``grid_cell_embed(..., interpret=True)``, the composed projection
(``kernels/image.py``), and the scorer and the whole search under each
route.  Inputs come from numpy with a seed; each tolerance states its
reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_owlvit import tiny_pair
from tests.test_torch_slice import (
    BASE,
    CUES,
    SECS,
    TARGETS,
    _assert_scorers_match,
    _scorers,
    _search_both,
    configs,
)
from tstar_tpu.kernels import grid_embed as jge
from tstar_tpu.kernels import image as jimg
from tstar_tpu.kernels import pallas_grid as jpg
from tstar_tpu.models import owlvit as jow
from tstar_tpu_torch.kernels import grid_embed as tge
from tstar_tpu_torch.kernels import image as timg
from tstar_tpu_torch.kernels import pallas_grid as tpg
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.search import detector_scorer as tds
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig
from tstar_tpu_torch.video import cache as tcache
from tstar_tpu_torch.video.synthetic import default_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file
    several-fold; its tiny shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# One bf16 ulp is at most 2^-7 of the value it rounds.
BF16_ULP = 2.0 ** -7


def _within_ulp(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert (err <= atol + BF16_ULP * np.abs(want)).all(), f"max abs err {err.max():.3e}"


# ---------------------------------------------------------------------------
# K7: the fused grid-pack kernel's plain version
# ---------------------------------------------------------------------------


def _jax_grid(cache, secs, size, dtype):
    return np.asarray(jpg.build_detector_grid_pallas(
        jnp.asarray(cache), jnp.asarray(secs, jnp.int32), (4, 4), size, dtype=dtype,
        interpret=True,
    ).astype(jnp.float32))


@pytest.mark.parametrize("seed,ch,cw", [(0, 20, 40), (1, 20, 40), (2, 16, 40)])
def test_grid_pack_plain_matches_reference_kernel(seed, ch, cw):
    """f32 within the reference test's own 2e-5 (``tests/test_pallas_grid.py``:
    the same f32 products summed in another order).  (20, 40) -> 16x16 cells
    resizes the height; (16, 40) takes the identity-height branch."""
    rng = np.random.default_rng(seed)
    cache = rng.integers(0, 256, (64, ch, cw, 3), dtype=np.uint8)
    secs = rng.choice(64, 16, replace=False).astype(np.int32)
    want = _jax_grid(cache, secs, 64, jnp.float32)
    got = tpg.build_detector_grid_pallas(
        torch.from_numpy(cache), torch.from_numpy(secs), (4, 4), 64, dtype=torch.float32
    )
    assert got.shape == want.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_grid_pack_plain_bf16_within_one_ulp():
    """bf16: both round the same f32 value (up to summation order) once, so
    they differ by at most one bf16 ulp."""
    rng = np.random.default_rng(3)
    cache = rng.integers(0, 256, (32, 20, 40, 3), dtype=np.uint8)
    secs = np.arange(16, dtype=np.int32)
    want = _jax_grid(cache, secs, 64, jnp.bfloat16)
    got = tpg.build_detector_grid_pallas(
        torch.from_numpy(cache), torch.from_numpy(secs), (4, 4), 64, dtype=torch.bfloat16
    )
    assert got.dtype == torch.bfloat16
    _within_ulp(got.float().numpy(), want, atol=0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grid_pack_plain_matches_reference_kernel_ragged_row(dtype):
    """Detector size 772: 4x4 cells of 193 pixels, 2316 values a canvas row,
    not a multiple of the card kernel's 8-value vectors.  f32 within the
    reference test's 2e-5 (summation order); bf16 within one ulp of the
    same value (each side rounds once), plus 1e-6 where ``* scale + bias``
    cancels to near 0 and bf16 keeps the f32 sides' difference of one f32
    ulp of the operands (~2.4e-7; the card test's bound)."""
    rng = np.random.default_rng(7)
    cache = rng.integers(0, 256, (24, 20, 40, 3), dtype=np.uint8)
    secs = rng.choice(24, 16, replace=False).astype(np.int32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = _jax_grid(cache, secs, 772, jdt)
    got = tpg.build_detector_grid_pallas(
        torch.from_numpy(cache), torch.from_numpy(secs), (4, 4), 772, dtype=tdt
    )
    assert got.shape == want.shape == (1, 772, 772, 3) and got.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        _within_ulp(got.float().numpy(), want, atol=1e-6)


def test_grid_pack_gathers_each_cell_from_its_second():
    """Constant frames, each cell at its own second: every cell holds its
    frame's intensity, as the reference kernel computes it."""
    cache = np.zeros((32, 20, 40, 3), np.uint8)
    for s in range(32):
        cache[s] = s * 5
    secs = np.array([7, 1, 30, 2, 9, 8, 3, 5, 11, 13, 17, 19, 23, 29, 0, 31], np.int32)
    got = tpg.build_detector_grid_pallas(
        torch.from_numpy(cache), torch.from_numpy(secs), (4, 4), 64, dtype=torch.float32
    ).numpy()
    np.testing.assert_allclose(got, _jax_grid(cache, secs, 64, jnp.float32), atol=2e-5)
    for k, s in enumerate(secs):
        pix = got[0, (k // 4) * 16 + 8, (k % 4) * 16 + 8]
        np.testing.assert_allclose((pix * jimg.CLIP_STD + jimg.CLIP_MEAN) * 255.0, s * 5, atol=0.5)


def test_grid_tap_tables_hold_the_matrix_entries():
    """Each row's taps are the nonzero entries of ``_interp_matrix``, edge
    clamps folded onto one source pixel (weight 1, second weight 0)."""
    for n_in, n_out in ((384, 192), (180, 192), (20, 16), (40, 16), (16, 16)):
        a = timg._interp_matrix(n_in, n_out)
        idx, wts = tpg._taps(n_in, n_out)
        dense = np.zeros_like(a)
        for o in range(n_out):
            dense[o, idx[o, 0]] += wts[o, 0]
            if idx[o, 1] != idx[o, 0]:
                dense[o, idx[o, 1]] += wts[o, 1]
        np.testing.assert_array_equal(dense, a)


# ---------------------------------------------------------------------------
# K6: the fused cache -> patch-embedding path's plain version
# ---------------------------------------------------------------------------

CH, CW, ROWS, COLS, SIZE, P, D = 32, 64, 2, 2, 64, 8, 128


def _ge_inputs(seed, ch=CH, b=1, n=10, p=P):
    rng = np.random.default_rng(seed)
    cache = rng.integers(0, 256, (b, n, ch, CW, 3), dtype=np.uint8)
    secs = rng.integers(0, n, (b, ROWS * COLS)).astype(np.int32)
    hwio = (rng.normal(size=(p, p, 3, D)) * 0.05).astype(np.float32)
    return cache, secs, hwio


def _ge_both(cache, secs, hwio, cell_h=SIZE // ROWS):
    ch = cache.shape[2]
    cell_w = SIZE // COLS
    p = hwio.shape[0]
    jawk, jbias = jge._width_affine(CW, cell_w, 128 // p)
    jah = jge._height_matrix(ch, cell_h)
    want = jge.grid_cell_embed(
        jnp.asarray(cache), jnp.asarray(secs), jnp.asarray(jawk), jnp.asarray(jbias),
        None if jah is None else jnp.asarray(jah), jnp.asarray(hwio),
        grid_shape=(ROWS, COLS), cell_hw=(cell_h, cell_w), patch_size=p, interpret=True,
    )
    awk, bias = tge._width_affine(CW, cell_w)
    ah = tge._height_matrix(ch, cell_h)
    got = tge.grid_cell_embed(
        torch.from_numpy(cache), torch.from_numpy(secs), torch.from_numpy(awk),
        torch.from_numpy(bias), None if ah is None else torch.from_numpy(ah),
        torch.from_numpy(hwio), grid_shape=(ROWS, COLS), cell_hw=(cell_h, cell_w), patch_size=p,
    )
    return got, want


@pytest.mark.parametrize("seed,ch,b", [(0, 32, 1), (1, 40, 1), (3, 32, 3)])
def test_grid_embed_plain_matches_reference_kernel(seed, ch, b):
    """Identity height (32 rows -> 32), a resized height (40 -> 32) and a
    batch of 3.  Both round at the same points: the canvas values equal, the
    f32 patch sums (192 products) differ by order only, so the bf16
    embeddings are within one ulp, plus 1e-5 for values that round near 0."""
    cache, secs, hwio = _ge_inputs(seed, ch=ch, b=b)
    got, want = _ge_both(cache, secs, hwio)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 64, D) == want.shape
    _within_ulp(got.float().numpy(), np.asarray(want, np.float32), atol=1e-5)


@pytest.mark.parametrize("seed,ch,b", [(4, 32, 1), (5, 40, 3)])
def test_grid_embed_plain_matches_reference_kernel_patch16(seed, ch, b):
    """Patch 16, the geometry class the card's wgmma kernel takes in
    16-value chunks (a 48-value (pw, c) run): one video with the identity
    height, and B=3 with a resized height (40 -> 32 rows), whose M = 48
    patches is not a multiple of that kernel's 128-row tiles.  Tolerance as
    at patch 8: equal canvas values, f32 patch sums (768 products) that
    differ by order only, so one bf16 ulp plus 1e-5 near 0."""
    cache, secs, hwio = _ge_inputs(seed, ch=ch, b=b, p=16)
    got, want = _ge_both(cache, secs, hwio)
    n_patches = ROWS * COLS * ((SIZE // ROWS) // 16) ** 2
    assert got.dtype == torch.bfloat16 and got.shape == (b, n_patches, D) == want.shape
    _within_ulp(got.float().numpy(), np.asarray(want, np.float32), atol=1e-5)


def test_grid_embed_canvas_patch_order():
    """Cell (r, c)'s patches land at the canvas's row-major patch positions:
    constant frames make each cell's patches distinct."""
    cache = np.zeros((1, 10, CH, CW, 3), np.uint8)
    for f in range(10):
        cache[0, f] = 17 * f
    _, _, hwio = _ge_inputs(2)
    secs = np.array([[4, 1, 8, 6]], np.int32)
    got, want = _ge_both(cache, secs, hwio)
    _within_ulp(got.float().numpy(), np.asarray(want, np.float32), atol=1e-5)
    nph = (SIZE // ROWS) // P
    row0 = got[0, : COLS * nph].float().numpy()
    assert not np.allclose(row0[0], row0[nph + 1], atol=1e-3)


def test_grid_embed_matrices_match_reference():
    """The port's width matrix is the reference's without its 128-lane pad
    columns; the height matrix and the identity case are the reference's."""
    for cw, cell_w, p in ((384, 192, 32), (64, 32, 8), (40, 16, 16)):
        jawk, jbias = jge._width_affine(cw, cell_w, 128 // p)
        awk, bias = tge._width_affine(cw, cell_w)
        lanes = np.array([o * (128 // p) + c for o in range(cell_w) for c in range(3)])
        np.testing.assert_array_equal(awk, jawk[:, lanes])
        np.testing.assert_array_equal(bias, jbias[lanes])
    for ch, cell_h in ((192, 192), (180, 192), (40, 32)):
        want, got = jge._height_matrix(ch, cell_h), tge._height_matrix(ch, cell_h)
        assert (want is None) == (got is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("env", ["0", "1", "force", "interpret"])
def test_grid_embed_gate_matches_reference(monkeypatch, env):
    """Same decision as the reference's gate for the same configuration,
    except that the reference needs a TPU for "1" and "force"."""
    monkeypatch.setenv("TSTAR_GRID_EMBED", env)
    cfg = TSearchConfig()
    for shape, image, p in (((1, 640, 192, 384, 3), 768, 32), ((16, 640, 192, 384, 3), 768, 32),
                            ((1, 640, 192, 384, 3), 768, 48), ((1, 640, 192, 384, 3), 770, 32)):
        got = tge.use_grid_embed_kernel(shape, image, p, 768, cfg)
        geometry = image % 4 == 0 and 128 % p == 0
        want = env != "0" and geometry and (env in ("force", "interpret") or shape[0] >= 8)
        assert got == want, (env, shape, image, p)
        if env == "interpret":
            assert got == jge.use_grid_embed_kernel(shape, image, p, 768, cfg)


# ---------------------------------------------------------------------------
# The composed projection
# ---------------------------------------------------------------------------


def test_composed_projection_matches_reference():
    """Numpy on both sides: the same folded weights; None off the aligned
    geometries.  Then the embeddings from a cache within f32 rounding."""
    rng = np.random.default_rng(5)
    hwio = (rng.normal(size=(16, 16, 3, 24)) * 0.05).astype(np.float32)
    nones = []
    for cache_hw, p in (((32, 64), 16), ((32, 128), 16), ((21, 40), 8)):
        k = hwio[:p, :p]
        want = jimg.composed_patch_projection(k, cache_hw, (16, 16), p)
        got = timg.composed_patch_projection(k, cache_hw, (16, 16), p)
        assert (want is None) == (got is None)
        nones.append(got is None)
        if want is not None:
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-9)
            assert got[2] == want[2]
    assert nones == [False, False, True]
    w, b, src = timg.composed_patch_projection(hwio, (32, 64), (16, 16), 16)
    cache = rng.integers(0, 256, (20, 32, 64, 3), dtype=np.uint8)
    secs = rng.choice(20, 16, replace=False)
    want = jimg.grid_patch_embeddings(
        jnp.asarray(cache), jnp.asarray(secs), jnp.asarray(w), jnp.asarray(b), (4, 4), src,
        dtype=jnp.float32,
    )
    got = timg.grid_patch_embeddings(
        torch.from_numpy(cache), torch.from_numpy(secs), torch.from_numpy(w),
        torch.from_numpy(b), (4, 4), src, dtype=torch.float32,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # and the pixel chain it folds, through the same patch kernel
    grid = timg.build_detector_grid(torch.from_numpy(cache), torch.from_numpy(secs), (4, 4), 64,
                                    dtype=torch.float32)
    chain = torch.matmul(timg.patchify_rect(grid, 16, 16), torch.from_numpy(hwio).reshape(-1, 24))
    np.testing.assert_allclose(got.numpy(), chain.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# The scorer and the search under each route
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair128():
    """The tiny pair of ``tests/test_torch_slice.py`` over a (32, 128) cache,
    which the reference's K7 takes outside interpret mode (ch % 32 == 0,
    cw*3 % 128 == 0)."""
    jmodel = jow.OwlViTDetector(tiny_pair(jow), dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32)
    )
    tmodel = tow.OwlViTDetector(tiny_pair(tow))
    tmodel.load_state_dict(tow.params_from_jax(variables), strict=True)
    tmodel.requires_grad_(False)
    host = tcache.build_frame_cache_host(
        "mem://scene", TSearchConfig(**{**BASE, "cache_hw": (32, 128)}),
        decoder=default_scene(450.0),
    )
    assert host.frames.shape[1:3] == (32, 128)
    return jmodel, variables, tmodel, host


def test_k7_route_scorer_matches_reference(pair128):
    """``use_pallas_preprocess=True``: the reference runs its kernel (TPU
    interpret mode), the port K7's plain version.  The f32 grids agree to
    ~1e-7, so the confidences agree to the slice's 1e-5."""
    with pltpu.force_tpu_interpret_mode():
        js, ts = _scorers(pair128, use_pallas_preprocess=True, cache_hw=(32, 128))
        assert ts.config.use_pallas_preprocess is True
        assert ts.gb_awk is None and ts.grid_proj_w is None
        _assert_scorers_match(js, ts, atol=1e-5)


def test_k7_route_search_matches_reference_exactly(pair128):
    """The K7 route's whole search samples the reference's seconds and
    keyframes (``_search_both`` asserts them equal)."""
    with pltpu.force_tpu_interpret_mode():
        _search_both(pair128, seed=3, use_pallas_preprocess=True, cache_hw=(32, 128))


@pytest.mark.parametrize("route", ["grid_embed", "composed"])
def test_grid_input_routes_scorer_match_reference(pair128, monkeypatch, route):
    """K6 (``TSTAR_GRID_EMBED=interpret`` for the reference, ``force`` for the
    port) and the composed projection (``TSTAR_COMPOSED_PATCH=1``): the
    slice's 1e-5 on the confidences, equal presence.  K6's bf16 embeddings
    are equal but for a rare one-ulp flip (the f32 patch sums run in another
    order before the rounding), which moves this tower's confidences by
    ~4e-7."""
    env, port_env = {"grid_embed": ("TSTAR_GRID_EMBED", "force"),
                     "composed": ("TSTAR_COMPOSED_PATCH", "1")}[route]
    monkeypatch.setenv(env, "interpret" if route == "grid_embed" else "1")
    jcfg, _ = configs(cache_hw=(32, 128))
    jmodel, variables, tmodel, host = pair128
    from tstar_tpu.models.clip_tokenizer import HashTokenizer as JHash
    from tstar_tpu.search import detector_scorer as jds
    from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THash

    js = jds.make_owlvit_scorer(
        jmodel, variables, jnp.asarray(host.frames), TARGETS, CUES, JHash(100, 8), jcfg
    )
    jc, jp = jax.jit(js.score_grid)(jnp.asarray(SECS, jnp.int32))
    monkeypatch.setenv(env, port_env)
    ts = tds.make_owlvit_scorer(
        tmodel, torch.from_numpy(host.frames), TARGETS, CUES, THash(100, 8),
        TSearchConfig(**{**BASE, "cache_hw": (32, 128)}),
    )
    if route == "grid_embed":
        assert ts.gb_awk is not None and ts._use_grid_embed_kernel((1,) + tuple(ts.cache.shape))
        name = "_grid_embeds_kernel"
    else:
        assert ts.grid_proj_opt_in and ts.grid_src_patch == (32, 128)
        name = "_grid_embeds"
    calls, route_fn = [], getattr(ts, name)
    setattr(ts, name, lambda *a: calls.append(1) or route_fn(*a))
    tc, tp = ts.score_grid(torch.from_numpy(SECS))
    assert calls == [1]
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_views_follow_the_switches(pair128, monkeypatch):
    """One heuristic serves searches under different switches: the grid-input
    views follow the switches of each scorer's build, never an earlier one's."""
    from tstar_tpu_torch.framework.heuristics import OwlVitHeuristic

    heur = OwlVitHeuristic(device="cpu", dtype=torch.float32, model_config=tiny_pair(tow))
    cache = torch.from_numpy(pair128[3].frames)
    cfg = TSearchConfig(**{**BASE, "cache_hw": (32, 128)})
    monkeypatch.setenv("TSTAR_GRID_EMBED", "force")
    assert heur.build_scorer(cache, TARGETS, CUES, cfg).gb_awk is not None
    monkeypatch.delenv("TSTAR_GRID_EMBED")
    monkeypatch.setenv("TSTAR_COMPOSED_PATCH", "1")
    s = heur.build_scorer(cache, TARGETS, CUES, cfg)
    assert s.gb_awk is None and s.grid_proj_opt_in
    pallas = heur.build_scorer(cache, TARGETS, CUES, TSearchConfig(
        **{**BASE, "cache_hw": (32, 128), "use_pallas_preprocess": True}))
    assert pallas.grid_proj_w is None and pallas.config.use_pallas_preprocess
    monkeypatch.delenv("TSTAR_COMPOSED_PATCH")
    s = heur.build_scorer(cache, TARGETS, CUES, cfg)
    assert s.gb_awk is None and s.grid_proj_w is None and s.config.use_pallas_preprocess is False
    assert tds.resolve_pallas_preprocess(
        TSearchConfig(use_pallas_preprocess=True), batched=True
    ).use_pallas_preprocess is False

