"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: K1 ``attention.fused_mha_from_qkv`` (CUDA), K2
``patch_matmul.patch_embed_matmul`` (CUDA), K3 ``layernorm.fused_layernorm``
(Triton), K4 ``quant_matmul.w8a8_matmul`` (CUDA) and K5
``ln_matmul.ln_matmul`` (CUDA).  ``image.py`` is plain PyTorch (the
reference's is XLA code).

Each wrapper counts its kernel launches in a plain integer attribute
``launches``; ``launch_counts`` / ``reset_launch_counts`` read and clear them.
"""

from typing import Dict


def _wrappers():
    from tstar_tpu_torch.kernels.attention import fused_mha_from_qkv
    from tstar_tpu_torch.kernels.layernorm import fused_layernorm
    from tstar_tpu_torch.kernels.ln_matmul import ln_matmul
    from tstar_tpu_torch.kernels.patch_matmul import patch_embed_matmul
    from tstar_tpu_torch.kernels.quant_matmul import w8a8_matmul

    return {
        "fused_mha_from_qkv": fused_mha_from_qkv,
        "patch_embed_matmul": patch_embed_matmul,
        "fused_layernorm": fused_layernorm,
        "w8a8_matmul": w8a8_matmul,
        "ln_matmul": ln_matmul,
    }


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
