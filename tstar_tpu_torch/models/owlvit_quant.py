"""Int8-quantized OWL-ViT vision tower (port of ``tstar_tpu/models/owlvit_quant.py``).

The six dense matmuls of every encoder layer (q|k|v fused into one, out_proj,
fc1, fc2) run as W8A8 (``ops/quant.dense_w8a8``, kernel K4 on the card) or,
with ``weight_only``, as W8A16 (``dense_w8a16``).  Which W8A8 layers take
K4 is a plan fixed when the weights are quantized (``qparams["routes"]``,
one name a dense layer): "k4" where K4 takes the (K, N) weight (every layer
of B/32 and B/16), "k4_row" where K4's row-parallel mode takes a
row-parallel shard's (K/T, N) weight, "plain" where K4 takes neither (the
knob A/B's scaled detector, hidden 64; L/14's fc2, K = 4096; B/32's
out_proj shard (384, 768) at T = 2), which then computes K4's math in plain
tensor ops on either device.  ``route_counts`` sums the plan.

On a model ``parallel/shardings.shard_module`` sharded, the int8 tower is
sharded alike (the reference replicates its int8 weights instead):
column-parallel layers (q|k|v as [q_r | k_r | v_r], fc1) quantize their
local columns, whose scales are the whole model's (a column's absmax runs
over the whole K, which every rank holds); row-parallel layers (out_proj,
fc2) quantize their local K rows with the whole columns' scales (the local
absmax all-reduced, MAX) and run as ``ops/quant.dense_w8a8_row_parallel``
(exact int32 sums over the model group: the one-rank tower bit for bit) or,
under ``weight_only``, ``dense_w8a16`` summed over the group before the
bias (within rounding of one rank).  Attention runs at the rank's heads.

What stays in floating point, as in the reference: the patch embedding
(compute dtype, K2), the LayerNorms and softmax statistics (f32), and
attention (the reference's order: K1 on the fused q|k|v projection unless
``TSTAR_FUSED_MHA=0``, else K8 ``flash_mha`` under ``use_flash_attention``,
else plain attention; this tower has no bf16-probabilities branch).
``SearchConfig.detector_quant`` selects it.

Numerics follow the reference: its two-pass-variance LayerNorm that returns
f32 (``_layernorm``, not K3's ``use_fast_variance`` formula), fc1 writing f32
and fc2 reading it.  The port's model holds its weights in its compute dtype,
so a bf16 model is quantized from its bf16 weights.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, Optional

import torch

from tstar_tpu_torch.kernels.attention import (
    HEAD_DIM,
    flash_mha,
    fused_mha_from_qkv,
    use_flash_attention,
    use_fused_mha,
)
from tstar_tpu_torch.kernels.patch_matmul import patch_embed_matmul
from tstar_tpu_torch.kernels.quant_matmul import supported_shape, w8a8_matmul_plain
from tstar_tpu_torch.models.owlvit import OwlViTConfig, OwlViTDetector
from tstar_tpu_torch.models.tensor_parallel import agree, all_reduce_max_, tensor_parallel
from tstar_tpu_torch.models.transformer import ACTIVATIONS, LayerNorm, dot_product_attention
from tstar_tpu_torch.ops.quant import (
    dense_w8a8,
    dense_w8a8_row_parallel,
    dense_w8a16,
    quantize_weight,
)


DENSE = ("qkv", "o", "fc1", "fc2")
ROUTES = ("plain", "k4", "k4_row")


def _qlinear(kernel: torch.Tensor, bias: torch.Tensor, reduce=None) -> Dict[str, Any]:
    """One dense layer's int8 weights: the (K, N) kernel ``"w"`` (the CPU
    plain version and ``dense_w8a16`` read it) and its (N, K) transpose
    ``"wt"``, made here once: K4's integer wgmma reads the weight K-major.
    ``reduce``: a row-parallel shard's ``TensorParallel`` (its columns'
    absmax is all-reduced, MAX, and kept as ``"reduce"``; a layer that is
    not row-parallel has no such key)."""
    w = kernel.detach().float()
    absmax = w.abs().amax(dim=0)
    if reduce is not None:
        all_reduce_max_(absmax, reduce)
    w_i8, scale = quantize_weight(w.cpu().numpy(), absmax=absmax.cpu().numpy())
    dev = kernel.device
    w = torch.from_numpy(w_i8).to(dev)
    out = {
        "w": w,
        "wt": w.T.contiguous(),
        "s": torch.from_numpy(scale).to(dev),
        "b": bias.detach().float(),
    }
    if reduce is not None:
        out["reduce"] = reduce
    return out


def _route(p: Dict[str, Any]) -> str:
    if not supported_shape(*p["w"].shape):
        return "plain"
    return "k4_row" if "reduce" in p else "k4"


def _ln_params(ln: LayerNorm) -> Dict[str, torch.Tensor]:
    return {"scale": ln.scale.detach().float(), "bias": ln.bias.detach().float()}


@torch.no_grad()
def quantize_vision_tower(model: OwlViTDetector) -> Dict[str, Any]:
    """Quantize the vision-tower weights once -> dict of int8 kernels (each
    also transposed, for K4), f32 scales, biases and LayerNorm params, on the
    model's device, and the route plan ``"routes"``: per layer, "k4",
    "k4_row" or "plain" for each dense layer (the module docstring).  On a
    sharded model the weights are this rank's shards, and the dict also
    holds ``"heads"``, the rank's heads, and ``"tp"``, the model's
    ``TensorParallel``; every rank of the model group must hold the same
    plan (checked).

    The port's q|k|v projection is already the fused (D, 3D) kernel that the
    reference builds by concatenating q_proj, k_proj and v_proj; per-channel
    scales make the fused quantization equal to three separate ones.
    """
    v = model.vision
    tp = tensor_parallel(model)
    layers = []
    for lyr in v.encoder.layers:
        attn = lyr.self_attn
        layers.append({
            "ln1": _ln_params(lyr.layer_norm1),
            "ln2": _ln_params(lyr.layer_norm2),
            "qkv": _qlinear(attn.qkv_kernel, attn.qkv_bias),
            "o": _qlinear(attn.out_proj.kernel, attn.out_proj.bias, attn.out_proj.reduce),
            "fc1": _qlinear(lyr.mlp.fc1.kernel, lyr.mlp.fc1.bias),
            "fc2": _qlinear(lyr.mlp.fc2.kernel, lyr.mlp.fc2.bias, lyr.mlp.fc2.reduce),
        })
    routes = tuple({name: _route(lyr[name]) for name in DENSE} for lyr in layers)
    sharded = {}
    if tp is not None:
        agree([ROUTES.index(r[name]) for r in routes for name in DENSE], tp,
              "the int8 tower's route plan", model.device)
        sharded = {"heads": v.encoder.layers[0].self_attn.num_heads, "tp": tp}
    return {
        "patch_kernel": v.patch_embedding.kernel.detach(),   # shared, not copied
        "cls": v.class_embedding.detach().float(),
        "pos": v.position_embedding.detach().float(),
        "pre_ln": _ln_params(v.pre_layernorm),
        "layers": tuple(layers),
        "post_ln": _ln_params(model.post_layernorm),
        "merged_ln": _ln_params(model.merged_layernorm),
        "routes": routes,
        **sharded,
    }


def route_counts(qparams: Dict[str, Any]) -> Dict[str, int]:
    """The route plan summed: {"k4": layers on K4, "k4_row": row-parallel
    shards on K4's row-parallel mode, "plain": layers in plain ops}."""
    return dict(Counter(r for lyr in qparams["routes"] for r in lyr.values()))


def _layernorm(x: torch.Tensor, ln: Dict[str, torch.Tensor], eps: float) -> torch.Tensor:
    """LayerNorm with f32 two-pass statistics (``jnp.var``); returns f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    centered = xf - mu
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    return y * ln["scale"] + ln["bias"]


@torch.no_grad()
def encode_image_int8(
    qparams: Dict[str, Any],
    pixels: Optional[torch.Tensor],   # (B, S, S, 3) CLIP-normalized, or None
    cfg: OwlViTConfig,
    dtype: torch.dtype = torch.bfloat16,
    weight_only: bool = False,
    patch_embeds: Optional[torch.Tensor] = None,   # (B, P, D) precomputed
) -> torch.Tensor:
    """Quantized counterpart of ``OwlViTDetector.encode_image``:
    (B, S, S, 3) pixels -> merged per-patch features (B, P, D) in ``dtype``.

    ``weight_only`` (``detector_quant='w8a16'``) runs the same int8 weights
    through ``dense_w8a16`` with activations in ``dtype``.  With
    ``patch_embeds`` (the composed projection or K6) ``pixels`` is ignored
    and the tower starts after the patch-embedding matmul.  Sharded
    ``qparams`` run at their ``"heads"`` and all-reduce their row-parallel
    layers (the module docstring).
    """
    if weight_only:
        def dense(x, p, route, out_dtype):
            return dense_w8a16(x.to(dtype), p["w"], p["s"], p["b"], out_dtype=out_dtype,
                               reduce=p.get("reduce"))
    else:
        def dense(x, p, route, out_dtype):
            if "reduce" in p:
                return dense_w8a8_row_parallel(x, p["w"], p["s"], p["b"], p["reduce"],
                                               out_dtype, w_t=p["wt"], kernel=route == "k4_row")
            if route == "plain":       # the plan's choice: a shape K4 does not take
                return w8a8_matmul_plain(x, p["w"], p["s"], p["b"], out_dtype)
            return dense_w8a8(x, p["w"], p["s"], p["b"], out_dtype=out_dtype, w_t=p["wt"])
    c = cfg.vision
    eps = c.eps
    if patch_embeds is not None:
        patches = patch_embeds.to(dtype)
    else:
        patches = patch_embed_matmul(
            pixels.to(dtype).contiguous(), qparams["patch_kernel"].to(dtype).contiguous()
        )
    b, seq = patches.shape[0], patches.shape[1] + 1
    head_dim = c.hidden_size // c.num_heads
    heads = qparams.get("heads", c.num_heads)      # this rank's, on a sharded tower
    width = heads * head_dim
    cls = qparams["cls"].to(dtype).expand(b, 1, c.hidden_size)
    x = torch.cat([cls, patches], dim=1) + qparams["pos"].to(dtype)[None]
    x = _layernorm(x, qparams["pre_ln"], eps).to(dtype)

    act = ACTIVATIONS[c.activation]
    for lyr, route in zip(qparams["layers"], qparams["routes"]):
        h = _layernorm(x, lyr["ln1"], eps)
        qkv = dense(h, lyr["qkv"], route["qkv"], out_dtype=dtype)
        # K1 has one head width; others take the split-head routes, as in
        # the float tower (models/transformer.py) and the reference's plan
        if head_dim == HEAD_DIM and use_fused_mha():
            attn = fused_mha_from_qkv(qkv, heads)
        else:
            q, k, v = (t.reshape(b, seq, heads, head_dim) for t in qkv.split(width, -1))
            if use_flash_attention(q, None):
                attn = flash_mha(q, k, v)
            else:
                attn = dot_product_attention(q, k, v, None)
            attn = attn.reshape(b, seq, width)
        x = x + dense(attn, lyr["o"], route["o"], out_dtype=dtype)
        h = _layernorm(x, lyr["ln2"], eps)
        h = dense(h, lyr["fc1"], route["fc1"], out_dtype=torch.float32)
        h = act(h)
        x = x + dense(h, lyr["fc2"], route["fc2"], out_dtype=dtype)

    hidden = _layernorm(x, qparams["post_ln"], eps)    # (B, 1+P, D) f32
    feats = hidden[:, 1:, :] * hidden[:, :1, :]
    feats = _layernorm(feats, qparams["merged_ln"], eps)
    return feats.to(dtype)
