"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: K1 ``attention.fused_mha_from_qkv`` (CUDA), K2
``patch_matmul.patch_embed_matmul`` (CUDA), K3 ``layernorm.fused_layernorm``
(CUDA), K4 ``quant_matmul.w8a8_matmul`` (CUDA), K5 ``ln_matmul.ln_matmul``
(CUDA), K6 ``grid_embed.grid_cell_embed`` (CUDA), K7
``pallas_grid.build_detector_grid_pallas`` (CUDA) and K8
``attention.flash_mha`` (CUDA): every TPU kernel of the reference has its
counterpart.  ``nms.greedy_nms`` (CUDA) is the loop of the reference's
class-aware NMS, an XLA ``fori_loop`` there, not a Pallas kernel.  ``image.py`` (the pixel chain and the composed projection) and
``attention.bf16_probs_attention`` are plain PyTorch (the reference's are
XLA code).

Each wrapper counts its kernel launches in a plain integer attribute
``launches``; ``launch_counts`` / ``reset_launch_counts`` read and clear them,
and ``add_launch_counts`` adds a graph replay's launches
(``search/step_graphs.py``).  A second mode of a kernel has a wrapper of its
own, counted apart: ``quant_matmul.w8a8_matmul_rowpar``, K4's row-parallel
mode (``w8a8_matmul`` counts the first mode only).
"""

from typing import Dict


def _wrappers():
    from tstar_tpu_torch.kernels.attention import flash_mha, fused_mha_from_qkv
    from tstar_tpu_torch.kernels.grid_embed import grid_cell_embed
    from tstar_tpu_torch.kernels.layernorm import fused_layernorm
    from tstar_tpu_torch.kernels.ln_matmul import ln_matmul
    from tstar_tpu_torch.kernels.nms import greedy_nms
    from tstar_tpu_torch.kernels.pallas_grid import build_detector_grid_pallas
    from tstar_tpu_torch.kernels.patch_matmul import patch_embed_matmul
    from tstar_tpu_torch.kernels.quant_matmul import w8a8_matmul, w8a8_matmul_rowpar

    return {
        "fused_mha_from_qkv": fused_mha_from_qkv,
        "patch_embed_matmul": patch_embed_matmul,
        "fused_layernorm": fused_layernorm,
        "w8a8_matmul": w8a8_matmul,
        "w8a8_matmul_rowpar": w8a8_matmul_rowpar,
        "ln_matmul": ln_matmul,
        "grid_cell_embed": grid_cell_embed,
        "build_detector_grid_pallas": build_detector_grid_pallas,
        "flash_mha": flash_mha,
        "greedy_nms": greedy_nms,
    }


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` to the named wrappers' counts: a CUDA graph replay runs
    again the launches its capture recorded."""
    wrappers = _wrappers()
    for name, n in delta.items():
        wrappers[name].launches += n
