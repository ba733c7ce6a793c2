"""Seeded weights, made on the device in a few large draws.

A few large ``torch.randn`` draws from a generator on the device, cut into
leaves and scaled by each leaf's kind: a projection kernel
(in, out) by 1/sqrt(fan_in), an embedding by 0.02, a bias by 0.02, a
LayerNorm scale 1 + 0.1 N(0, 1).  Biases and scales are not left at 0 and
1, so that the comparison sees every term.  The same seed gives the same
weights on any card; the program and the reference are handed the same
tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


def leaf_std(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of a parameter, by the last part of its name."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        return 1.0, 0.1
    if leaf.endswith("bias"):
        return 0.0, 0.02
    if leaf.endswith("embedding") or leaf == "image_newline":
        return 0.0, 0.02
    if leaf.endswith("kernel"):
        return 0.0, 1.0 / math.sqrt(math.prod(shape[:-1]))
    raise ValueError(f"no initializer for parameter {name}")


def seeded_weights(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int, device,
                   dtype=torch.bfloat16, chunk: int = 1 << 28) -> Dict[str, torch.Tensor]:
    """{name: tensor} for (name, shape) pairs, in ``dtype`` on ``device``:
    one draw for each run of leaves of up to ``chunk`` elements (a larger
    leaf alone), so that the float32 draw of a 7B model never stands whole."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    group, size = [], 0

    def draw():
        flat = torch.randn(size, generator=gen, device=device, dtype=torch.float32)
        at = 0
        for name, shape in group:
            n = math.prod(shape)
            mean, std = leaf_std(name, shape)
            out[name] = (flat[at:at + n] * std + mean).reshape(shape).to(dtype)
            at += n

    for name, shape in shapes:
        n = math.prod(shape)
        if group and size + n > chunk:
            draw()
            group, size = [], 0
        group.append((name, shape))
        size += n
    if group:
        draw()
    return out
