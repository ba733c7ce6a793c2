"""Greedy NMS over score-sorted boxes (the loop of ``tstar_tpu/ops/nms.py``
``nms``, :33), a CUDA kernel beside its plain version.

The reference's loop is no Pallas kernel: a ``lax.fori_loop`` over all N
candidates through a dense (N, N) f32 IoU matrix, which XLA keeps on the
TPU.  In plain PyTorch that is N dependent steps an image (8,400 at 640^2),
tens of thousands of launches for every detector forward, so the port runs
it as ``csrc/nms.cu`` (design and H100 bounds in its header): a suppression
bitmask over the upper triangle, then one warp an image scanning the rows in
score order.  The sort is no part of the loop: the caller passes a stable
descending order (``torch.argsort(-scores, stable=True)``, as ``jnp.argsort``
is stable).
"""

from __future__ import annotations

import ctypes

import torch

from tstar_tpu_torch.kernels import _build


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between two xyxy box sets: (..., N, 4) x (..., M, 4) -> (..., N, M),
    the reference's f32 formula operation for operation."""
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def greedy_nms_plain(
    boxes: torch.Tensor, order: torch.Tensor, iou_threshold: float, max_outputs: int
):
    """The kernel's function in plain PyTorch, as the reference computes it:
    boxes (B, N, 4) f32, order (B, N) -> (keep (B, max_outputs) int32,
    valid (B, max_outputs) bool); invalid slots hold index 0."""
    b, n = order.shape
    rows = torch.arange(b, device=boxes.device)[:, None]
    boxes_sorted = boxes[rows, order]
    suppress = box_iou(boxes_sorted, boxes_sorted) > iou_threshold
    later = torch.arange(n, device=boxes.device)
    alive = torch.ones(b, n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        kill = suppress[:, i] & (later > i) & alive[:, i:i + 1]
        alive &= ~kill
    # compact the survivors (score order) into max_outputs slots
    rank = torch.cumsum(alive, dim=1) - 1
    slot = torch.where(alive & (rank < max_outputs), rank, max_outputs)
    keep_sorted = torch.full((b, max_outputs + 1), n, dtype=torch.int64, device=boxes.device)
    keep_sorted.scatter_(1, slot, later.expand(b, n).clone())
    keep_sorted = keep_sorted[:, :max_outputs]
    valid = keep_sorted < n
    keep = order.gather(1, keep_sorted.clamp(0, n - 1))
    return torch.where(valid, keep, 0).to(torch.int32), valid


def _launch(boxes: torch.Tensor, order: torch.Tensor, iou_threshold: float, max_outputs: int):
    if boxes.dtype != torch.float32 or boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms kernel takes (B, N, 4) f32 boxes, got {tuple(boxes.shape)} {boxes.dtype}")
    b, n, _ = boxes.shape
    if order.shape != (b, n) or order.dtype != torch.int64:
        raise ValueError(f"nms kernel takes a (B, N) int64 order, got {tuple(order.shape)} {order.dtype}")
    if order.get_device() != boxes.get_device():
        raise ValueError("nms order must be on the boxes' device")
    if max_outputs < 1 or n < 1 or b < 1:
        raise ValueError(f"nms kernel got B={b} N={n} max_outputs={max_outputs}")
    boxes, order = boxes.contiguous(), order.contiguous()
    words = -(-n // 64)
    mask = torch.empty(b * n * words, dtype=torch.int64, device=boxes.device)
    keep = torch.empty(b, max_outputs, dtype=torch.int32, device=boxes.device)
    valid = torch.empty(b, max_outputs, dtype=torch.bool, device=boxes.device)
    status = _build.call(
        _build.load().tstar_nms, boxes.get_device(), boxes.data_ptr(), order.data_ptr(),
        ctypes.c_float(iou_threshold), b, n, max_outputs, mask.data_ptr(), keep.data_ptr(),
        valid.data_ptr(),
    )
    _build.check(status, "tstar_nms")
    greedy_nms.launches += 1
    return keep, valid


def greedy_nms(boxes: torch.Tensor, order: torch.Tensor, iou_threshold: float, max_outputs: int):
    """Greedy NMS of B images: boxes (B, N, 4) f32, order (B, N) a stable
    descending score order -> (keep (B, max_outputs) int32, valid (B,
    max_outputs) bool).  CPU tensors: the plain version.  CUDA tensors: the
    kernel, or raise."""
    if not boxes.is_cuda:
        if boxes.device.type == "cpu":
            return greedy_nms_plain(boxes, order, iou_threshold, max_outputs)
        raise ValueError(f"no nms kernel for device {boxes.device}")
    return _launch(boxes, order, iou_threshold, max_outputs)


greedy_nms.launches = 0  # kernel launches (not plain-version calls)
