"""The quantized detector under Megatron tensor parallelism, on the CPU:
K4's row-parallel mode's plain version (``kernels/quant_matmul``) and
``quantize_vision_tower`` on sharded models (``models/owlvit_quant``).

  * Row-parallel W8A8: x's K columns and the weight's K rows split into T
    shards; each shard quantized with the whole rows' scales (its absmax
    the max of the shards') gives an int32 partial product; the partials sum
    exactly to ``w8a8_matmul_plain``'s accumulator, and one dequantization
    equals ``w8a8_matmul_plain`` and the reference's ``dense_w8a8`` bit for
    bit.
  * ``quantize_vision_tower`` on each rank of a model group sharded by
    ``shard_module`` (ranks simulated in this process: ``fake_mesh``, and
    the one collective the quantization runs, the MAX all-reduce of a
    row-parallel layer's column absmax, taken over the ranks' own values in
    two passes), gathered back, equals the whole model's int8 weights,
    transposes, scales and biases exactly; the route plan at B/32's widths
    is the one K4 takes at T = 2 and 4.

The four-rank gloo runs (the sharded towers' forwards and searches) are in
``tests/test_torch_parallel.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mesh import fake_mesh
from tests.test_torch_owlvit import tiny_pair
from tstar_tpu.ops import quant as jops
from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
from tstar_tpu_torch.kernels.quant_matmul import (
    activation_scale,
    dequantize,
    quantize_activation,
    row_absmax,
    w8a8_matmul_plain,
    w8a8_matmul_rowpar,
    w8a8_matmul_rowpar_plain,
)
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import owlvit_quant as tq
from tstar_tpu_torch.ops.quant import quantize_weight
from tstar_tpu_torch.parallel.shardings import shard_module


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layer(seed, rows, k, n, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(rows, k)) * 3).astype(np.float32)).to(dtype)
    w = (rng.normal(size=(k, n)) * 0.03).astype(np.float32)
    w_i8, ws = quantize_weight(w)
    b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    return x, torch.from_numpy(w_i8), torch.from_numpy(ws), torch.from_numpy(b)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("xd,od", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("rows,k,n", [(37, 512, 256), (5, 1024, 128)])
def test_row_parallel_partials_sum_to_the_whole_product(shards, xd, od, rows, k, n):
    x, w, ws, b = _layer(rows * k + shards, rows, k, n, xd)
    q, xs = quantize_activation(x)
    acc = torch.matmul(q.double(), w.double()).to(torch.int32)    # the whole accumulator
    cols = np.split(np.arange(k), shards)
    # step 1: each shard's row absmax, then their max: the whole rows' scale
    amax = torch.stack([row_absmax(x[:, c]) for c in cols]).amax(0)
    xs_group = activation_scale(amax)
    assert torch.equal(xs_group, xs)
    # steps 2-3: the int32 partials (the wrapper runs the plain version on
    # a CPU tensor) and their exact sum
    reset_launch_counts()
    parts = [w8a8_matmul_rowpar(x[:, c].contiguous(), xs_group, w[c], w_t=w[c].T.contiguous())
             for c in cols]
    assert launch_counts()["w8a8_matmul_rowpar"] == 0
    assert all(p.dtype == torch.int32 for p in parts)
    for c, p in zip(cols, parts):
        assert torch.equal(p, w8a8_matmul_rowpar_plain(x[:, c], xs_group, w[c]))
    total = torch.stack(parts).sum(0, dtype=torch.int32)
    assert torch.equal(total, acc)
    # step 4: one dequantization, bit-equal to one rank and to the reference
    got = dequantize(total, xs_group, ws, b, od)
    assert torch.equal(got, w8a8_matmul_plain(x, w, ws, b, od))
    jdt = jnp.bfloat16 if xd == torch.bfloat16 else jnp.float32
    want = jops.dense_w8a8(jnp.asarray(x.float().numpy(), jdt), jnp.asarray(w.numpy()),
                           jnp.asarray(ws.numpy()), jnp.asarray(b.numpy()),
                           out_dtype=jnp.bfloat16 if od == torch.bfloat16 else jnp.float32)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_row_parallel_wrapper_checks_the_transpose():
    x, w, _, _ = _layer(0, 3, 256, 128, torch.float32)
    _, xs = quantize_activation(x)
    with pytest.raises(ValueError, match="transpose"):
        w8a8_matmul_rowpar(x, xs, w, w_t=w)


def _sharded_towers(make_model, t):
    """``quantize_vision_tower`` on each of ``t`` ranks of one model group,
    simulated in this process: a first pass records each rank's inputs to
    the MAX all-reduce, the second hands every rank their max."""
    shards = [shard_module(make_model(), fake_mesh(t, r)) for r in range(t)]
    calls = [[] for _ in range(t)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tq, "agree", lambda *a, **k: None)     # the plans are compared below
        for r, model in enumerate(shards):
            mp.setattr(tq, "all_reduce_max_", lambda x, tp, r=r: calls[r].append(x.clone()) or x)
            tq.quantize_vision_tower(model)
        group_max = [torch.stack(c).amax(0) for c in zip(*calls)]
        towers = []
        for model in shards:
            given = iter(group_max)
            mp.setattr(tq, "all_reduce_max_", lambda x, tp, given=given: x.copy_(next(given)))
            towers.append(tq.quantize_vision_tower(model))
    return towers


def _gather(parts, name, key):
    """One dense layer's ``key`` of every rank, put back into the whole
    layer's layout: q|k|v by sections, fc1 by columns, out_proj / fc2 by
    rows (their scales and biases are whole on every rank)."""
    if name in ("o", "fc2"):
        if key in ("s", "b"):
            assert all(torch.equal(p, parts[0]) for p in parts)
            return parts[0]
        return torch.cat(parts, dim=-1 if key == "wt" else 0)
    if name == "qkv":
        sections = [p.chunk(3, dim=0 if key == "wt" else -1) for p in parts]
        return torch.cat([torch.cat([s[j] for s in sections], dim=0 if key == "wt" else -1)
                          for j in range(3)], dim=0 if key == "wt" else -1)
    return torch.cat(parts, dim=0 if key == "wt" else -1)


@pytest.mark.parametrize("t", [2, 4])
def test_sharded_quantized_tower_gathers_to_the_whole(t):
    cfg = tiny_pair(tow)
    make = lambda: tow.init_params(tow.OwlViTDetector(cfg), 0).requires_grad_(False)  # noqa: E731
    whole = tq.quantize_vision_tower(make())
    towers = _sharded_towers(make, t)
    assert "tp" not in whole and "heads" not in whole
    for r, tower in enumerate(towers):
        assert tower["heads"] == cfg.vision.num_heads // t and tower["tp"].index == r
        assert tower["routes"] == towers[0]["routes"]
        for key in ("patch_kernel", "cls", "pos"):
            assert torch.equal(tower[key], whole[key])
    for i, want in enumerate(whole["layers"]):
        for name in tq.DENSE:
            for key in ("w", "wt", "s", "b"):
                got = _gather([tw["layers"][i][name][key] for tw in towers], name, key)
                assert got.dtype == want[name][key].dtype, (i, name, key)
                assert torch.equal(got, want[name][key]), (i, name, key)
            assert ("reduce" in towers[0]["layers"][i][name]) == (name in ("o", "fc2"))


def test_route_plan_at_b32_widths():
    """B/32 (one layer): at T = 2 q|k|v (768, 1152) and fc1 (768, 1536) on
    K4, fc2 (1536, 768) on its row-parallel mode, out_proj (384, 768) in
    plain ops (K not a multiple of 256); at T = 4 fc1 (768, 768) on K4, fc2
    (768, 768) on the row-parallel mode, q|k|v (768, 576) and out_proj
    (192, 768) in plain ops."""
    base = tow.owlvit_base_patch32()
    cfg = dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_layers=1),
        text=dataclasses.replace(base.text, num_layers=1, hidden_size=64, num_heads=4,
                                 intermediate_size=128),
        projection_dim=64)
    make = lambda: tow.init_params(tow.OwlViTDetector(cfg), 0).requires_grad_(False)  # noqa: E731
    plans = {2: {"qkv": "k4", "o": "plain", "fc1": "k4", "fc2": "k4_row"},
             4: {"qkv": "plain", "o": "plain", "fc1": "k4", "fc2": "k4_row"}}
    for t, plan in plans.items():
        for tower in _sharded_towers(make, t):
            assert tower["routes"] == (plan,), t
            assert tower["heads"] == 12 // t


def test_verify_view_of_a_sharded_model_imports_no_dynamo():
    """``resize_detector`` (the verification view a quantized scorer builds
    with ``verify_image_size``) shards a meta-device view: that must not
    reach ``torch.cat``'s meta kernel, which imports ``torch._dynamo`` and,
    where it is installed, ``triton`` (the port imports no Triton).  In a
    fresh interpreter, as the card's smoke run checks."""
    import subprocess
    import sys

    from pathlib import Path

    code = (
        "import sys, torch\n"
        "from tests.torch_mesh_ranks import tiny_owlvit\n"
        "from tstar_tpu_torch.models import owlvit as ow\n"
        "from tstar_tpu_torch.parallel.mesh import Mesh\n"
        "from tstar_tpu_torch.parallel.shardings import shard_module\n"
        "mesh = Mesh(data=1, model=2, rank=1, device=torch.device('cpu'), backend='gloo',\n"
        "            device_mesh=None)\n"
        "m = shard_module(ow.init_params(ow.OwlViTDetector(tiny_owlvit(ow)), 0), mesh)\n"
        "before = 'torch._dynamo' in sys.modules\n"
        "v = ow.resize_detector(m, 48)\n"
        "print(before, 'torch._dynamo' in sys.modules, v.vision.encoder.layers[0].self_attn.num_heads)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(Path(__file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "False", "2"], out.stdout
