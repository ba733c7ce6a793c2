"""K7: fused frame gather -> bilinear resize -> CLIP normalize -> grid pack
(port of ``tstar_tpu/kernels/pallas_grid.py`` ``build_detector_grid_pallas``),
a CUDA kernel.

For every value of the (1, S, S, 3) detector canvas: find its cell k
(row-major), gather ``cache[secs[k]]``, take the height taps (skipped when
the height resize is the identity), then the width taps, in f32, then
``y * scale + bias`` with the folded ``1/(255 std)`` and ``-mean/std``
(``_norm_vectors``; not ``build_detector_grid``'s ``(x/255 - mean)/std``,
so both packages differ from the pixel chain by the same ~1e-7), and cast
to the model dtype.  Each tap's weight is an entry of ``_interp_matrix``:
at the edges cv2's clamp folds both taps onto one source pixel, and the
matrix holds their sum, so the taps are read from the matrix, never
recomputed from a fraction.

The kernel is ``csrc/grid_pack.cu`` (design and H100 bounds in its
header): it is bound by memory, the gathered frames in and the canvas out
(3.54 MB of uint8 and 3.54 MB of bf16 at the main geometry), and is one C
call in the kernel library, so its host path is short.  No matrix product
is worth a tensor core here.

What differs from the reference: its ``ch % 32`` / ``cw*3 % 128`` check is
a TPU DMA-tiling rule and is left out; any cache geometry runs.  The
wrapper runs ``build_detector_grid_pallas_plain`` for a CPU tensor and for
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from tstar_tpu_torch.kernels import _build
from tstar_tpu_torch.kernels.image import (
    CLIP_MEAN, CLIP_STD, _interp_matrix, device_constant, pack_grid,
)

# output dtype -> the C entry point's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=16)
def _width_kron_matrix(w_in: int, w_out: int) -> np.ndarray:
    """(w_in*3, w_out*3) channel-preserving width-resize matrix."""
    return np.kron(_interp_matrix(w_in, w_out).T, np.eye(3, dtype=np.float32))


def _norm_vectors(w_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-lane CLIP normalization folded with the /255 rescale, (1, w_out*3)."""
    scale = (1.0 / (255.0 * CLIP_STD)).astype(np.float32)
    bias = (-CLIP_MEAN / CLIP_STD).astype(np.float32)
    return np.tile(scale, w_out)[None, :], np.tile(bias, w_out)[None, :]


@functools.lru_cache(maxsize=64)
def _height_identity(ch: int, cell_h: int) -> bool:
    return ch == cell_h and bool(
        np.allclose(_interp_matrix(ch, cell_h), np.eye(cell_h), atol=1e-6)
    )


@functools.lru_cache(maxsize=64)
def _taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The nonzero entries of ``_interp_matrix(n_in, n_out)``, two per output:
    (n_out, 2) int32 source indices and (n_out, 2) f32 weights.  Where only
    one entry is nonzero (an edge clamp, or an exact hit) the second tap is
    the same index with weight 0."""
    a = _interp_matrix(n_in, n_out)
    idx = np.zeros((n_out, 2), np.int32)
    wts = np.zeros((n_out, 2), np.float32)
    for o in range(n_out):
        nz = np.flatnonzero(a[o])
        if not 1 <= nz.size <= 2:
            raise ValueError(f"row {o} of the {n_out}x{n_in} resize has {nz.size} taps")
        idx[o] = (nz[0], nz[-1])
        wts[o, : nz.size] = a[o, nz]
    return idx, wts


# Device copies of the small per-geometry tables, made once: a copy from
# host memory in every call would stall the host loop.
_ON_DEVICE: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def _device_taps(n_in: int, n_out: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    key = ("taps", n_in, n_out, str(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = tuple(torch.from_numpy(t).to(device) for t in _taps(n_in, n_out))
    return _ON_DEVICE[key]


def _device_norm(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (3,) f32 ``1/(255 std)`` and ``-mean/std``."""
    key = ("norm", str(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = tuple(torch.from_numpy(v[0, :3].copy()).to(device)
                                for v in _norm_vectors(1))
    return _ON_DEVICE[key]


def build_detector_grid_pallas_plain(
    cache: torch.Tensor,        # (N_pad, ch, cw, 3) uint8
    secs: torch.Tensor,         # (R*C,)
    grid_shape: Tuple[int, int],
    detector_size: int = 768,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """K7's math in plain PyTorch: f32 height matmul (skipped at identity),
    f32 width (x) I3 matmul, ``* scale + bias``, pack, cast -> (1, S, S, 3)."""
    rows, cols = grid_shape
    n, ch, cw, _ = cache.shape
    cell_h, cell_w = detector_size // rows, detector_size // cols
    dev = cache.device
    x = cache[secs].to(torch.float32).reshape(-1, ch, cw * 3)
    if not _height_identity(ch, cell_h):
        x = torch.matmul(
            device_constant(("interp", ch, cell_h), lambda: _interp_matrix(ch, cell_h), dev), x
        )
    y = torch.matmul(
        x, device_constant(("kron", cw, cell_w), lambda: _width_kron_matrix(cw, cell_w), dev)
    )
    scale, bias = (
        device_constant(("norm", cell_w, i), lambda i=i: _norm_vectors(cell_w)[i], dev)
        for i in (0, 1)
    )
    y = y * scale + bias                                  # (K, cell_h, cell_w*3)
    cells = y.reshape(-1, cell_h, cell_w, 3)
    return pack_grid(cells, rows, cols)[None].to(dtype)


def _launch(cache, secs, grid_shape, detector_size, dtype):
    rows, cols = grid_shape
    if cache.ndim != 4 or cache.shape[-1] != 3 or cache.dtype != torch.uint8:
        raise ValueError(f"grid kernel takes a (N, ch, cw, 3) uint8 cache, got "
                         f"{tuple(cache.shape)} {cache.dtype}")
    if secs.shape != (rows * cols,):
        raise ValueError(f"expected {rows * cols} seconds, got shape {tuple(secs.shape)}")
    if dtype not in _DTYPES:
        raise TypeError(f"grid kernel writes bf16 or f32, got {dtype}")
    if not cache.is_contiguous():
        raise ValueError("grid kernel needs a contiguous cache")
    if detector_size % rows or detector_size % cols:
        raise ValueError(f"detector size {detector_size} not divisible by the grid {grid_shape}")
    n, ch, cw, _ = cache.shape
    cell_h, cell_w = detector_size // rows, detector_size // cols
    dev = cache.device
    wtap, wwt = _device_taps(cw, cell_w, dev)
    htap, hwt = _device_taps(ch, cell_h, dev)
    scale, bias = _device_norm(dev)
    # the kernel reads int32 or int64 seconds: no cast for the search's int64
    if secs.device != dev or secs.dtype not in (torch.int32, torch.int64):
        secs = secs.to(device=dev, dtype=torch.int64)
    secs = secs.contiguous()
    out = torch.empty(1, rows * cell_h, cols * cell_w, 3, dtype=dtype, device=dev)
    status = _build.call(
        _build.load().tstar_grid_pack, cache.get_device(), cache.data_ptr(), secs.data_ptr(),
        int(secs.dtype == torch.int64), htap.data_ptr(), hwt.data_ptr(), wtap.data_ptr(),
        wwt.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n, ch, cw, rows,
        cols, cell_h, cell_w, int(_height_identity(ch, cell_h)), _DTYPES[dtype],
    )
    _build.check(status, "tstar_grid_pack")
    build_detector_grid_pallas.launches += 1
    return out


def build_detector_grid_pallas(
    cache: torch.Tensor,        # (N_pad, ch, cw, 3) uint8
    secs: torch.Tensor,         # (R*C,) sampled seconds
    grid_shape: Tuple[int, int],
    detector_size: int = 768,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Fused equivalent of ``image.build_detector_grid`` -> (1, S, S, 3).

    CPU tensor: the plain version.  CUDA tensor: the K7 kernel, or raise.
    Seconds must index the cache (the kernel clamps them, it does not check).
    """
    if cache.device.type == "cpu":
        return build_detector_grid_pallas_plain(cache, secs, grid_shape, detector_size, dtype)
    if cache.device.type != "cuda":
        raise ValueError(f"no grid kernel for device {cache.device}")
    return _launch(cache, secs, grid_shape, detector_size, dtype)


build_detector_grid_pallas.launches = 0  # kernel launches (not plain-version calls)
