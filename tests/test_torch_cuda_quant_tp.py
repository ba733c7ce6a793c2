"""K4's row-parallel mode and the sharded int8 tower on the card
(``chip_smoke.py`` phases 3 and 15 at smaller sizes).  Skipped without
CUDA; no JAX.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_quant_tp.py

  * ``w8a8_matmul_rowpar`` against its plain version, exactly: f32 and
    bf16 x, K of a rank's fc2 shard at T = 2 and 4 (1536, 768) and the
    smallest K4 takes (256), ragged rows, all-zero rows, rows' scales taken
    from a wider x (as the MAX all-reduce gives them); one launch counted a
    call, on the mode's own count;
  * the int8 tower of B/32 cut to two layers, sharded at model = 1 over a
    one-rank NCCL group: features equal to the unsharded tower's bit for
    bit, with 2 column and 2 row-parallel K4 launches a layer.
"""

import dataclasses

import pytest
import torch

from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
from tstar_tpu_torch.kernels.quant_matmul import (
    activation_scale,
    row_absmax,
    w8a8_matmul_rowpar,
    w8a8_matmul_rowpar_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 33, 577, 8 * 577])
@pytest.mark.parametrize("k,n", [(1536, 768), (768, 768), (256, 128), (768, 1152)])
def test_rowpar_mode_exact(cuda, dtype, rows, k, n):
    g = torch.Generator(device=cuda).manual_seed(rows * k + n)
    whole = (torch.randn(rows, 2 * k, generator=g, device=cuda) * 3).to(dtype)
    whole[rows // 2] = 0                      # a zero row: its scale is 1e-12 / 127
    x = whole[:, :k].contiguous()
    xs = activation_scale(row_absmax(whole))
    w = torch.randint(-127, 128, (k, n), generator=g, device=cuda).to(torch.int8)
    reset_launch_counts()
    got = w8a8_matmul_rowpar(x, xs, w, w_t=w.T.contiguous())
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["w8a8_matmul_rowpar"] == 1 and counts["w8a8_matmul"] == 0
    assert got.dtype == torch.int32 and got.shape == (rows, n)
    assert torch.equal(got, w8a8_matmul_rowpar_plain(x, xs, w))


def test_rowpar_mode_raises_without_transpose(cuda):
    x = torch.randn(4, 256, device=cuda)
    w = torch.zeros(256, 128, dtype=torch.int8, device=cuda)
    xs = activation_scale(row_absmax(x))
    with pytest.raises(ValueError, match="w_t"):
        w8a8_matmul_rowpar(x, xs, w)
    with pytest.raises(ValueError, match="xs"):
        w8a8_matmul_rowpar(x, xs[:2], w, w_t=w.T.contiguous())


def test_int8_tower_sharded_at_model_1_is_exact(cuda):
    import torch.distributed as dist

    from tstar_tpu_torch.models import owlvit as tow
    from tstar_tpu_torch.models import owlvit_quant as tq
    from tstar_tpu_torch.parallel import make_mesh, shard_module

    base = tow.owlvit_base_patch32()
    cfg = dataclasses.replace(base, vision=dataclasses.replace(base.vision, num_layers=2),
                              text=dataclasses.replace(base.text, num_layers=1))
    whole = tow.init_params(tow.OwlViTDetector(cfg), 0).to(cuda, torch.bfloat16)
    px = torch.randn(2, 768, 768, 3, generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        want = tq.encode_image_int8(tq.quantize_vision_tower(whole), px, cfg)
    mesh = make_mesh(1, 1, device=cuda)
    try:
        sharded = shard_module(tow.init_params(tow.OwlViTDetector(cfg), 0).to(cuda, torch.bfloat16),
                               mesh)
        qp = tq.quantize_vision_tower(sharded)
        assert tq.route_counts(qp) == {"k4": 4, "k4_row": 4}
        reset_launch_counts()
        with torch.no_grad():
            got = tq.encode_image_int8(qp, px, cfg)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        dist.destroy_process_group()
    assert counts["w8a8_matmul"] == 4 and counts["w8a8_matmul_rowpar"] == 4
    assert torch.equal(got, want)
