"""The plain versions of the port's kernels (tstar_tpu_torch/kernels) against
the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held here
against the JAX Pallas kernels run the way the reference's own tests run
them (``interpret=True``).  Inputs come from numpy with fixed seeds.

Tolerances: f32 cases differ only by summation order (atol 2e-5, as the
reference's kernel tests use against their XLA references); bf16 outputs are
rounded to bf16 (8 bits of mantissa, ~4e-3 relative), so a 1-ulp difference
from a different summation order needs ~2e-2 at these magnitudes.

The kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu.kernels.attention import _mha_pallas
from tstar_tpu.kernels.attention import fused_mha_from_qkv as jax_mha
from tstar_tpu.kernels.layernorm import fused_layernorm as jax_ln
from tstar_tpu.kernels.patch_matmul import patch_embed_matmul as jax_patch
from tstar_tpu_torch.kernels import grid_embed, launch_counts, pallas_grid, reset_launch_counts
from tstar_tpu_torch.kernels.attention import flash_mha, fused_mha_from_qkv
from tstar_tpu_torch.kernels.decode import add_rms_norm, decode_attention, silu_mul
from tstar_tpu_torch.kernels import layernorm as layernorm_module
from tstar_tpu_torch.kernels.layernorm import fused_layernorm, supported_width
from tstar_tpu_torch.kernels.ln_matmul import ln_matmul
from tstar_tpu_torch.kernels.mla import mla_decode
from tstar_tpu_torch.kernels.moe import moe_decode, moe_route
from tstar_tpu_torch.kernels.nms import greedy_nms
from tstar_tpu_torch.kernels.patch_matmul import patch_embed_matmul
from tstar_tpu_torch.kernels.quant_matmul import w8a8_matmul


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


# ---- K1: fused MHA -------------------------------------------------------

@pytest.mark.parametrize("b,s,heads", [(2, 80, 4), (1, 577, 2)])
def test_mha_plain_matches_pallas_f32(b, s, heads):
    rng = np.random.default_rng(0)
    qkv = rng.normal(size=(b, s, 3 * heads * 64)).astype(np.float32)
    want = np.asarray(jax_mha(jnp.asarray(qkv), heads, interpret=True))
    got = fused_mha_from_qkv(_t(qkv), heads)
    np.testing.assert_allclose(_np(got), want, atol=2e-5)


def test_mha_plain_matches_pallas_bf16():
    rng = np.random.default_rng(1)
    qkv = rng.normal(size=(2, 80, 3 * 4 * 64)).astype(np.float32)
    want = jax_mha(jnp.asarray(qkv, jnp.bfloat16), 4, interpret=True)
    got = fused_mha_from_qkv(_t(qkv, torch.bfloat16), 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=2e-2)


def test_mha_plain_p16_matches_pallas_bf16(monkeypatch):
    """``TSTAR_MHA_P16=1``: the probabilities rounded to bf16 and the row sum
    taken from the rounded values, as the reference kernel's p16 branch
    (``_mha_pallas`` called directly: the jitted entry caches its trace by
    static arguments only).  Within one bf16 ulp plus 1e-3 everywhere and bit
    for bit on 99.9% of the outputs (the f32 sums run in other orders); the
    default mode agrees bit for bit on fewer than 99%, so the mode is what
    matches."""
    rng = np.random.default_rng(11)
    qkv = rng.normal(size=(2, 80, 3 * 4 * 64)).astype(np.float32)
    x = _t(qkv, torch.bfloat16)
    monkeypatch.setenv("TSTAR_MHA_P16", "0")
    default = _np(fused_mha_from_qkv(x, 4))
    monkeypatch.setenv("TSTAR_MHA_P16", "1")
    want = np.asarray(_mha_pallas(jnp.asarray(qkv, jnp.bfloat16), 4, interpret=True), np.float32)
    got = fused_mha_from_qkv(x, 4)
    assert got.dtype == torch.bfloat16
    got = _np(got)
    err = np.abs(got - want)
    assert (err <= 1e-3 + 2.0 ** -7 * np.abs(want)).all(), err.max()
    assert (got == want).mean() >= 0.999
    assert (default == want).mean() < 0.99


# ---- K2: patchify + patch-embed matmul ------------------------------------

@pytest.mark.parametrize("b,hw,p,c,d", [(2, 64, 16, 3, 32), (1, 96, 32, 3, 128)])
def test_patch_plain_matches_pallas_f32(b, hw, p, c, d):
    rng = np.random.default_rng(2)
    px = rng.normal(size=(b, hw, hw, c)).astype(np.float32)
    w = (rng.normal(size=(p, p, c, d)) * 0.05).astype(np.float32)
    want = np.asarray(jax_patch(jnp.asarray(px), jnp.asarray(w), interpret=True))
    got = patch_embed_matmul(_t(px), _t(w))
    assert got.shape == (b, (hw // p) ** 2, d)
    np.testing.assert_allclose(_np(got), want, atol=2e-5)


def test_patch_plain_matches_pallas_bf16():
    rng = np.random.default_rng(3)
    px = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    w = (rng.normal(size=(32, 32, 3, 128)) * 0.05).astype(np.float32)
    want = jax_patch(
        jnp.asarray(px, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), interpret=True
    )
    got = patch_embed_matmul(_t(px, torch.bfloat16), _t(w, torch.bfloat16))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=5e-2, rtol=2e-2)


# ---- K3: layernorm --------------------------------------------------------

@pytest.mark.parametrize("shape", [(33, 128), (3, 97, 768)])
def test_layernorm_plain_matches_pallas_f32(shape):
    rng = np.random.default_rng(4)
    d = shape[-1]
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    s, b = rng.normal(size=(2, d)).astype(np.float32)
    want = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), interpret=True))
    got = fused_layernorm(_t(x), _t(s), _t(b))
    np.testing.assert_allclose(_np(got), want, atol=2e-6, rtol=1e-6)


def test_layernorm_plain_matches_pallas_bf16():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 577, 256)).astype(np.float32)
    s, b = rng.normal(size=(2, 256)).astype(np.float32)
    want = jax_ln(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s), jnp.asarray(b), interpret=True)
    got = fused_layernorm(_t(x, torch.bfloat16), _t(s), _t(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=0.15, rtol=0.02)


@pytest.mark.parametrize("d,dtype,ok", [
    (768, torch.bfloat16, True), (512, torch.bfloat16, True), (768, torch.float16, True),
    (768, torch.float32, True), (512, torch.float32, True), (128, torch.float32, True),
    (2048, torch.bfloat16, True), (1024, torch.float32, True),
    (384, torch.bfloat16, True), (100, torch.float32, False), (2304, torch.bfloat16, True),
    (1152, torch.float32, True), (64, torch.bfloat16, False), (1152, torch.bfloat16, True),
    (1160, torch.float32, False), (768, torch.float64, False),
])
def test_layernorm_kernel_widths(d, dtype, ok):
    """K3 takes the widths the reference's kernel takes, a multiple of 128
    (``tstar_tpu/kernels/layernorm.py``; the towers' 768 and 512, SigLIP's
    1152), in bf16, f16 and f32; the wrapper raises on the others (card
    test)."""
    assert supported_width(d, dtype) is ok


def test_layernorm_module_has_no_triton():
    """K3 is CUDA C++ in the kernel library; its module names no Triton."""
    import inspect

    assert "triton" not in inspect.getsource(layernorm_module).lower()


def test_grid_pack_module_has_no_triton():
    """K7 is CUDA C++ in the kernel library; its module names no Triton."""
    import inspect

    assert "triton" not in inspect.getsource(pallas_grid).lower()


def _imported_modules(tree):
    """Top-level names of every module an AST imports: ``import`` and
    ``from`` statements, and ``importlib.import_module`` / ``__import__``
    calls on a string."""
    import ast

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                yield node.args[0].value.split(".")[0]


def _module_scope_imports(tree):
    """``_imported_modules`` of the statements that run when the module is
    imported: everything outside function bodies."""
    import ast

    class Scope(ast.NodeVisitor):
        def __init__(self):
            self.nodes = []

        def visit_FunctionDef(self, node):
            self.nodes.extend(node.decorator_list)

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, node):
            pass

        def generic_visit(self, node):
            if isinstance(node, (ast.Import, ast.ImportFrom, ast.Call)):
                self.nodes.append(node)
            super().generic_visit(node)

    scope = Scope()
    scope.visit(tree)
    return set(_imported_modules(ast.Module(body=scope.nodes, type_ignores=[])))


# Host libraries the card's machine lacks that the port may use only when a
# function needs them (the artifact sinks, the OpenAI backend): never at
# module scope.
LAZY_IMPORTS = {"PIL", "matplotlib", "imageio", "openai"}


# Nothing the card's machine lacks: JAX and the JAX package (the port stands
# alone), Triton (every kernel is CUDA C++), the reference's host libraries
# (``regex``, ``cv2``, ``safetensors``, ``transformers``), and packages of
# finished detection kernels (``torchvision``'s NMS, ``mmcv``'s).
FORBIDDEN_IMPORTS = {"jax", "flax", "tstar_tpu", "regex", "cv2", "safetensors", "transformers",
                     "triton", "torchvision", "mmcv"}


def test_no_port_module_imports_triton():
    """No file under ``tstar_tpu_torch/`` and not ``chip_smoke.py`` imports a
    module of ``FORBIDDEN_IMPORTS`` (AST scan, imports inside functions
    included), nor one of ``LAZY_IMPORTS`` at module scope."""
    import ast
    from pathlib import Path

    import tstar_tpu_torch

    root = Path(tstar_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        mods = set(_imported_modules(ast.parse(path.read_text(), str(path))))
        bad = mods & FORBIDDEN_IMPORTS
        assert not bad, f"{path.relative_to(root.parent)} imports {sorted(bad)}"
        eager = _module_scope_imports(ast.parse(path.read_text(), str(path))) & LAZY_IMPORTS
        assert not eager, f"{path.relative_to(root.parent)} imports {sorted(eager)} at module scope"
    # the scan sees function-level and dotted imports, and each name
    for src in ("def f():\n    import triton.language\n", "import regex as re\n",
                "from cv2 import resize\n", "import importlib\nimportlib.import_module('safetensors.torch')\n",
                "def g():\n    from transformers import AutoModel\n", "import jax.numpy\n",
                "from flax import linen\n", "from tstar_tpu.models import qwen2vl\n",
                "from torchvision.ops import batched_nms\n", "import mmcv.ops\n"):
        assert set(_imported_modules(ast.parse(src))) & FORBIDDEN_IMPORTS, src
    assert not set(_imported_modules(ast.parse("import re\nimport tstar_tpu_torch\n"))) & FORBIDDEN_IMPORTS
    for src in ("from PIL import Image\n", "import matplotlib.pyplot as plt\n",
                "if True:\n    import imageio\n", "class A:\n    import openai\n",
                "try:\n    from PIL import ImageDraw\nexcept ImportError:\n    pass\n"):
        assert _module_scope_imports(ast.parse(src)) & LAZY_IMPORTS, src
    for src in ("def f():\n    from PIL import Image\n",
                "class A:\n    def f(self):\n        import openai\n",
                "async def g():\n    import matplotlib\n"):
        assert not _module_scope_imports(ast.parse(src)) & LAZY_IMPORTS, src


def test_cpu_wrappers_run_the_plain_versions():
    """A CPU tensor never reaches a kernel: no launch is counted."""
    reset_launch_counts()
    fused_mha_from_qkv(torch.zeros(1, 8, 3 * 64), 1)
    patch_embed_matmul(torch.zeros(1, 32, 32, 3), torch.zeros(16, 16, 3, 8))
    fused_layernorm(torch.zeros(4, 8), torch.ones(8), torch.zeros(8))
    w8a8_matmul(torch.ones(4, 16), torch.ones(16, 16, dtype=torch.int8), torch.ones(16),
                torch.zeros(16), torch.float32)
    ln_matmul(torch.ones(1, 4, 32), torch.ones(32), torch.zeros(32), torch.ones(32, 16),
              torch.zeros(16), 1e-5)
    cache, secs = torch.zeros(1, 4, 16, 32, 3, dtype=torch.uint8), torch.zeros(1, 4, dtype=torch.long)
    awk, gbias = (torch.from_numpy(t) for t in grid_embed._width_affine(32, 16))
    grid_embed.grid_cell_embed(cache, secs, awk, gbias, None, torch.zeros(8, 8, 3, 8),
                               grid_shape=(2, 2), cell_hw=(16, 16), patch_size=8)
    pallas_grid.build_detector_grid_pallas(cache[0], secs[0], (2, 2), 32)
    flash_mha(*(torch.zeros(1, 8, 2, 64) for _ in range(3)))
    greedy_nms(torch.zeros(2, 5, 4), torch.arange(5).expand(2, 5), 0.7, 3)
    x = torch.zeros(1, 1, 256, dtype=torch.bfloat16)
    add_rms_norm(x, x, torch.ones(256, dtype=torch.bfloat16), 1e-6)
    silu_mul(x, x)
    qkv = torch.zeros(1, 1, 128, dtype=torch.bfloat16)
    cache = tuple(torch.zeros(1, 4, 1, 128, dtype=torch.bfloat16) for _ in range(2))
    rope = torch.zeros(1, 1, 1, 128)
    decode_attention(qkv, qkv, qkv, None, None, None, rope, rope, None, cache, 0, 1, 1)
    h = torch.zeros(1, 16, dtype=torch.bfloat16)
    ids, weights = moe_route(h, torch.zeros(4, 16, dtype=torch.bfloat16),
                             torch.zeros(4, dtype=torch.bfloat16), 2, 1.0)
    moe_decode(h, ids, weights, torch.zeros(4, 16, 16, dtype=torch.bfloat16),
               torch.zeros(4, 16, 8, dtype=torch.bfloat16), torch.zeros(32, 16, dtype=torch.bfloat16),
               torch.zeros(16, 16, dtype=torch.bfloat16))
    y = torch.zeros(1, 1, 2 * (8 + 4) + 16 + 4, dtype=torch.bfloat16)
    rope = torch.zeros(1, 1, 1, 4)
    mla_decode(y, rope, rope, torch.ones(16, dtype=torch.bfloat16), 1e-6,
               torch.zeros(1, 4, 20, dtype=torch.bfloat16), 0,
               torch.zeros(2, 8, 16, dtype=torch.bfloat16), torch.zeros(2, 16, 8, dtype=torch.bfloat16))
    assert launch_counts() == {
        "fused_mha_from_qkv": 0, "patch_embed_matmul": 0, "fused_layernorm": 0,
        "w8a8_matmul": 0, "w8a8_matmul_rowpar": 0, "ln_matmul": 0, "grid_cell_embed": 0,
        "build_detector_grid_pallas": 0, "flash_mha": 0, "greedy_nms": 0,
        "add_rms_norm": 0, "decode_attention": 0, "silu_mul": 0, "moe_decode": 0,
        "moe_route": 0, "mla_decode": 0,
    }
