"""K6: uint8 frame cache -> detector patch embeddings in one pass (port of
``tstar_tpu/kernels/grid_embed.py`` ``grid_cell_embed``).

For each video: gather the sampled frames, resize them bilinearly as a
height matrix and a channel-interleaved width matrix with the CLIP
``/255`` + normalize folded in (``_width_affine``, ``_height_matrix``), and
run the patchify -> patch-embed GEMM on the resulting bf16 canvas, which
never exists in device memory.  The output is bf16 whatever the model dtype,
in canvas patch order.

The CUDA kernels are in ``csrc/grid_embed.cu`` (design, rounding points and
H100 bounds in its header): a wgmma kernel that builds each canvas tile in
shared memory, where the patch's (pw, c) run is a multiple of 16 values
(patch 32 and 16), and the WMMA kernel for other patches (e.g. 8), chosen
by shape in the C entry point;
``grid_embed_config`` reads the choice.  ``grid_cell_embed_plain`` is the
reference's math in plain PyTorch, rounding where it does.  The wrapper
runs the plain version for a CPU tensor, and for a CUDA tensor launches the
kernel or raises.

What differs from the reference: its 4-lane channel pad (``c_pad = 128 //
p``) existed only for the TPU's 128-lane layout, so this module's
``_width_affine`` has no pad columns (the values are the reference's on the
unpadded lanes); and the gate ``use_grid_embed_kernel`` drops the TPU-only
conditions (backend, ``ch % 32``, ``cw*3 % 128``, ``D % 128``, the VMEM
budget), keeping those that decide whether the path applies.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tstar_tpu_torch.kernels import _build
from tstar_tpu_torch.kernels.image import CLIP_MEAN, CLIP_STD, _interp_matrix
from tstar_tpu_torch.kernels.pallas_grid import _device_taps
from tstar_tpu_torch.kernels.patch_matmul import patchify

_MIN_BATCH = 8          # the reference's batch gate under TSTAR_GRID_EMBED=1


@functools.lru_cache(maxsize=16)
def _width_affine(cw: int, cell_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Channel-interleaved width-resize matrix with the CLIP normalization
    folded in: (awk (cw*3, cell_w*3) f32, bias (cell_w*3,) f32), so that
    ``uint8_row @ awk + bias`` is the normalized resized row."""
    aw = _interp_matrix(cw, cell_w)                        # (cell_w, cw)
    scale = (1.0 / (255.0 * CLIP_STD)).astype(np.float32)
    kron = np.zeros((cw * 3, cell_w * 3), np.float32)
    for c in range(3):
        kron[c::3, c::3] = aw.T * scale[c]
    bias = np.tile((-CLIP_MEAN / CLIP_STD).astype(np.float32), cell_w)
    return kron, bias


@functools.lru_cache(maxsize=16)
def _height_matrix(ch: int, cell_h: int) -> Optional[np.ndarray]:
    """(cell_h, ch) height interpolation, or None when it is the identity."""
    ah = _interp_matrix(ch, cell_h)
    if ch == cell_h and np.allclose(ah, np.eye(ch), atol=1e-6):
        return None
    return ah


def grid_cell_embed_plain(
    cache: torch.Tensor,          # (B, N_pad, ch, cw, 3) uint8
    secs: torch.Tensor,           # (B, R*C)
    awk: torch.Tensor,            # (cw*3, cell_w*3)
    bias: torch.Tensor,           # (cell_w*3,)
    ah: Optional[torch.Tensor],   # (cell_h, ch) or None (identity height)
    patch_kernel: torch.Tensor,   # (p, p, 3, D) HWIO
    *,
    grid_shape: Tuple[int, int],
    cell_hw: Tuple[int, int],
    patch_size: int,
) -> torch.Tensor:
    """The kernel's math in plain PyTorch -> (B, P, D) bf16.  Every bf16
    product is formed in f32 (exact), so each rounding is the reference's."""
    bf16 = torch.bfloat16
    b, _, ch, cw, c3 = cache.shape
    rows, cols = grid_shape
    cell_h, cell_w = cell_hw
    d = patch_kernel.shape[-1]
    bidx = torch.arange(b, device=cache.device)[:, None]
    x = cache[bidx, secs.long()].reshape(b, rows * cols, ch, cw * c3).to(torch.float32)
    if ah is not None:
        x = torch.matmul(ah.to(bf16).float(), x).to(bf16).float()
    y = (torch.matmul(x, awk.to(bf16).float()) + bias.float()).to(bf16)
    canvas = (
        y.reshape(b, rows, cols, cell_h, cell_w, c3)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(b, rows * cell_h, cols * cell_w, c3)
    )
    w = patch_kernel.to(bf16).float().reshape(-1, d)
    return torch.matmul(patchify(canvas.float(), patch_size), w).to(bf16)


def _launch(cache, secs, awk, bias, ah, patch_kernel, grid_shape, cell_hw, p):
    if cache.ndim != 5 or cache.shape[-1] != 3 or cache.dtype != torch.uint8:
        raise ValueError(f"grid-embed kernel takes a (B, N, ch, cw, 3) uint8 cache, got "
                         f"{tuple(cache.shape)} {cache.dtype}")
    b, n, ch, cw, _ = cache.shape
    rows, cols = grid_shape
    cell_h, cell_w = cell_hw
    d = patch_kernel.shape[-1]
    if secs.shape != (b, rows * cols):
        raise ValueError(f"expected ({b}, {rows * cols}) seconds, got {tuple(secs.shape)}")
    if awk.shape != (cw * 3, cell_w * 3) or bias.shape != (cell_w * 3,):
        raise ValueError(f"awk {tuple(awk.shape)} / bias {tuple(bias.shape)} do not match "
                         f"cache width {cw} -> cell width {cell_w}")
    if ah is not None and ah.shape != (cell_h, ch):
        raise ValueError(f"ah {tuple(ah.shape)} does not match {ch} -> {cell_h} rows")
    if ah is None and ch != cell_h:
        raise ValueError(f"no height matrix, but the cache's {ch} rows are not the cell's {cell_h}")
    if patch_kernel.shape != (p, p, 3, d):
        raise ValueError(f"patch kernel {tuple(patch_kernel.shape)} is not ({p}, {p}, 3, D)")
    if cell_h % p or cell_w % p or (p * p) % 16 or d % 8:
        raise ValueError(f"grid-embed kernel needs cells divisible by the patch, p*p % 16 == 0 "
                         f"and D % 8 == 0: cell {cell_hw}, p={p}, D={d}")
    if not cache.is_contiguous():
        raise ValueError("grid-embed kernel needs a contiguous cache")
    dev = cache.device
    tensors = (secs, awk, bias, patch_kernel) + (() if ah is None else (ah,))
    if any(t.device != dev for t in tensors):
        raise ValueError("grid-embed operands must be on the cache's device")
    # the kernel reads int32 or int64 seconds as they are (the search's are int64)
    if secs.dtype not in (torch.int32, torch.int64):
        secs = secs.to(torch.int64)
    secs = secs.contiguous()
    awk16 = awk.to(torch.bfloat16).contiguous()
    bias32 = bias.to(torch.float32).contiguous()
    w16 = patch_kernel.to(torch.bfloat16).contiguous()
    wtap, _ = _device_taps(cw, cell_w, dev)
    if ah is None:
        ah16 = htap = None
    else:
        ah16 = ah.to(torch.bfloat16).contiguous()
        htap, _ = _device_taps(ch, cell_h, dev)
    p_out = rows * (cell_h // p) * cols * (cell_w // p)
    out = torch.empty(b, p_out, d, dtype=torch.bfloat16, device=dev)
    if w16.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("grid-embed kernel needs 16-byte aligned weights and output")
    status = _build.call(
        _build.load().tstar_grid_embed, cache.get_device(), cache.data_ptr(), secs.data_ptr(),
        int(secs.dtype == torch.int64), awk16.data_ptr(), bias32.data_ptr(),
        None if ah16 is None else ah16.data_ptr(), wtap.data_ptr(),
        None if htap is None else htap.data_ptr(), w16.data_ptr(), out.data_ptr(),
        b, n, ch, cw, rows, cols, cell_h, cell_w, p, d,
    )
    _build.check(status, "tstar_grid_embed")
    grid_cell_embed.launches += 1
    return out


def grid_cell_embed(
    cache: torch.Tensor,          # (B, N_pad, ch, cw, 3) uint8 frame caches
    secs: torch.Tensor,           # (B, R*C) sampled seconds
    awk: torch.Tensor,            # (cw*3, cell_w*3) folded width + normalize
    bias: torch.Tensor,           # (cell_w*3,) folded normalize bias
    ah: Optional[torch.Tensor],   # (cell_h, ch) height matrix, or None
    patch_kernel: torch.Tensor,   # (p, p, 3, D) HWIO patch-embedding weights
    *,
    grid_shape: Tuple[int, int],
    cell_hw: Tuple[int, int],
    patch_size: int,
) -> torch.Tensor:
    """Fused cache -> detector patch embeddings, (B, P, D) bf16.

    CPU tensor: the plain version.  CUDA tensor: the K6 kernel, or raise.
    Seconds must index the cache (the kernel clamps them, it does not check).
    """
    if cache.device.type == "cpu":
        return grid_cell_embed_plain(
            cache, secs, awk, bias, ah, patch_kernel,
            grid_shape=grid_shape, cell_hw=cell_hw, patch_size=patch_size,
        )
    if cache.device.type != "cuda":
        raise ValueError(f"no grid-embed kernel for device {cache.device}")
    return _launch(cache, secs, awk, bias, ah, patch_kernel, grid_shape, cell_hw, patch_size)


grid_cell_embed.launches = 0  # kernel launches (not plain-version calls)


def grid_embed_config(batch, cache_hw, grid_shape, cell_hw, patch_size, d, height):
    """The wgmma kernel's launch configuration for a call's shape on the
    current device: {CTAs, output columns per CTA, CTAs per cluster
    splitting K, stages, dynamic shared memory bytes, values per K chunk},
    all 0 when the shape takes the WMMA kernel.  ``height``: the height
    taps apply.  Needs a CUDA device."""
    import ctypes

    cfg = (ctypes.c_int * 6)()
    _build.check(_build.load().tstar_grid_embed_config(
        batch, 1, *cache_hw, *grid_shape, *cell_hw, patch_size, d, int(height), cfg),
        "tstar_grid_embed_config")
    keys = ("ctas", "columns", "split", "stages", "smem", "pk")
    return dict(zip(keys, list(cfg)))


def use_grid_embed_kernel(
    cache_shape: Tuple[int, ...], image_size: int, patch_size: int, d: int, config
) -> bool:
    """Gate of the fused cache -> embedding path, read at call time.

    ``TSTAR_GRID_EMBED``: unset or "0" is off; "force" applies at any image
    batch; "interpret" is taken like "force" (the port has no interpret
    mode: a CPU tensor already takes the plain version); any other value
    (the reference's "1") applies from an image batch of 8, which the
    single-video search never reaches.  The geometry must divide: image by
    the grid, cell by the patch, ``128 % p == 0`` and ``3 <= 128 // p`` (the
    reference's conditions, kept so that both packages take the same branch
    for the same configuration).  ``d`` is unused: the reference's
    ``d % 128`` is a TPU lane rule.
    """
    env = os.environ.get("TSTAR_GRID_EMBED", "0")
    if env == "0" or len(cache_shape) != 5:
        return False
    b, _, _, _, c3 = cache_shape
    rows, cols = config.grid_rows, config.grid_cols
    if image_size % rows or image_size % cols:
        return False
    cell_h, cell_w = image_size // rows, image_size // cols
    p = patch_size
    if 128 % p or c3 > 128 // p or cell_h % p or cell_w % p:
        return False
    return env in ("force", "interpret") or b >= _MIN_BATCH
