"""K2: patchify fused into the patch-embedding matmul (port of
``tstar_tpu/kernels/patch_matmul.py`` ``patch_embed_matmul``).

The CUDA kernel is ``csrc/patch_embed.cu``: in bf16 an implicit GEMM on
wgmma whose A tiles are TMA boxes of the NHWC pixels and whose B operand is
the HWIO kernel read as stored (no transposed copy); f32, and bf16 shapes
whose (pw, c) run is not a multiple of 32 values, take its CUDA-core kernel
(design and H100 bounds in its header).  ``patch_embed_matmul_plain`` is
``patchify(pixels) @ kernel.reshape(-1, D)`` in plain PyTorch.  The wrapper
runs the plain version for a CPU tensor, and for a CUDA tensor launches the
kernel or raises; the TPU's batch gate does not carry over.
"""

from __future__ import annotations

import torch

from tstar_tpu_torch.kernels import _build


def patchify(pixels: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, P, p*p*C) patches in (ph, pw, c) minor order
    (the order of an HWIO kernel flattened to (p*p*C, D))."""
    b, h, w, ch = pixels.shape
    p = patch_size
    x = pixels.reshape(b, h // p, p, w // p, p, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * ch)


def patch_embed_matmul_plain(pixels: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) pixels, (p, p, C, D) HWIO kernel -> (B, P, D)."""
    p, d = kernel.shape[0], kernel.shape[-1]
    return torch.matmul(patchify(pixels, p), kernel.reshape(-1, d))


def _launch(pixels: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    b, h, w, c = pixels.shape
    p, p2, kc, d = kernel.shape
    if p != p2 or kc != c or h % p or w % p:
        raise ValueError(
            f"patch kernel shapes disagree: pixels {tuple(pixels.shape)}, "
            f"kernel {tuple(kernel.shape)}"
        )
    if pixels.dtype != kernel.dtype:
        raise TypeError(f"pixels {pixels.dtype} vs kernel {kernel.dtype}")
    if pixels.device != kernel.device:
        raise ValueError(f"pixels on {pixels.device}, kernel on {kernel.device}")
    if not (pixels.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("patch kernel needs contiguous NHWC pixels and HWIO kernel")
    if pixels.dtype == torch.bfloat16:
        fn = _build.load().tstar_patch_embed_bf16
    elif pixels.dtype == torch.float32:
        fn = _build.load().tstar_patch_embed_f32
    else:
        raise TypeError(f"patch kernel takes bf16 or f32, got {pixels.dtype}")
    out = torch.empty(b, (h // p) * (w // p), d, dtype=pixels.dtype, device=pixels.device)
    status = _build.call(
        fn, pixels.get_device(), pixels.data_ptr(), kernel.data_ptr(), out.data_ptr(),
        b, h, w, c, p, d,
    )
    _build.check(status, "tstar_patch_embed")
    patch_embed_matmul.launches += 1
    return out


def patch_embed_matmul(pixels: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``patchify(pixels) @ kernel.reshape(-1, D)``: (B, P, D).

    CPU tensor: the plain version.  CUDA tensor: the K2 kernel, or raise.
    """
    if pixels.ndim != 4 or kernel.ndim != 4:
        raise ValueError("expected (B, H, W, C) pixels and a (p, p, C, D) kernel")
    if pixels.device.type == "cpu":
        return patch_embed_matmul_plain(pixels, kernel)
    if pixels.device.type != "cuda":
        raise ValueError(f"no patch kernel for device {pixels.device}")
    return _launch(pixels, kernel)


patch_embed_matmul.launches = 0  # kernel launches (not plain-version calls)
