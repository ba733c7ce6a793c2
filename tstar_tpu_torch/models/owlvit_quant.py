"""Int8-quantized OWL-ViT vision tower (port of ``tstar_tpu/models/owlvit_quant.py``).

The six dense matmuls of every encoder layer (q|k|v fused into one, out_proj,
fc1, fc2) run as W8A8 (``ops/quant.dense_w8a8``, kernel K4 on the card) or,
with ``weight_only``, as W8A16 (``dense_w8a16``).  Which W8A8 layers take
K4 is a plan fixed when the weights are quantized (``qparams["routes"]``,
one name a dense layer): "k4" where K4 takes the (K, N) weight (every layer
of B/32 and B/16), "plain" where it does not (the knob A/B's scaled
detector, hidden 64; L/14's fc2, K = 4096), which then computes K4's math
in plain tensor ops on either device.  ``route_counts`` sums the plan.

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
from tstar_tpu_torch.models.transformer import ACTIVATIONS, LayerNorm, dot_product_attention
from tstar_tpu_torch.ops.quant import dense_w8a8, dense_w8a16, quantize_weight


DENSE = ("qkv", "o", "fc1", "fc2")


def _qlinear(kernel: torch.Tensor, bias: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One dense layer's int8 weights: the (K, N) kernel ``"w"`` (the CPU
    plain version and ``dense_w8a16`` read it) and its (N, K) transpose
    ``"wt"``, made here once: K4's integer wgmma reads the weight K-major."""
    w_i8, scale = quantize_weight(kernel.detach().float().cpu().numpy())
    dev = kernel.device
    w = torch.from_numpy(w_i8).to(dev)
    return {
        "w": w,
        "wt": w.T.contiguous(),
        "s": torch.from_numpy(scale).to(dev),
        "b": bias.detach().float(),
    }


def _ln_params(ln: LayerNorm) -> Dict[str, torch.Tensor]:
    return {"scale": ln.scale.detach().float(), "bias": ln.bias.detach().float()}


@torch.no_grad()
def quantize_vision_tower(model: OwlViTDetector) -> Dict[str, Any]:
    """Quantize the vision-tower weights once -> dict of int8 kernels (each
    also transposed, for K4), f32 scales, biases and LayerNorm params, on the
    model's device, and the route plan ``"routes"``: per layer, "k4" or
    "plain" for each dense layer (the module docstring).

    The port's q|k|v projection is already the fused (D, 3D) kernel that the
    reference builds by concatenating q_proj, k_proj and v_proj; per-channel
    scales make the fused quantization equal to three separate ones.
    """
    v = model.vision
    layers = []
    for lyr in v.encoder.layers:
        attn = lyr.self_attn
        layers.append({
            "ln1": _ln_params(lyr.layer_norm1),
            "ln2": _ln_params(lyr.layer_norm2),
            "qkv": _qlinear(attn.qkv_kernel, attn.qkv_bias),
            "o": _qlinear(attn.out_proj.kernel, attn.out_proj.bias),
            "fc1": _qlinear(lyr.mlp.fc1.kernel, lyr.mlp.fc1.bias),
            "fc2": _qlinear(lyr.mlp.fc2.kernel, lyr.mlp.fc2.bias),
        })
    routes = tuple(
        {name: "k4" if supported_shape(*lyr[name]["w"].shape) else "plain" for name in DENSE}
        for lyr in layers
    )
    return {
        "patch_kernel": v.patch_embedding.kernel.detach(),   # shared, not copied
        "cls": v.class_embedding.detach().float(),
        "pos": v.position_embedding.detach().float(),
        "pre_ln": _ln_params(v.pre_layernorm),
        "layers": tuple(layers),
        "post_ln": _ln_params(model.post_layernorm),
        "merged_ln": _ln_params(model.merged_layernorm),
        "routes": routes,
    }


def route_counts(qparams: Dict[str, Any]) -> Dict[str, int]:
    """The route plan summed: {"k4": layers on K4, "plain": layers in plain ops}."""
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
    and the tower starts after the patch-embedding matmul.
    """
    if weight_only:
        def dense(x, p, route, out_dtype):
            return dense_w8a16(x.to(dtype), p["w"], p["s"], p["b"], out_dtype=out_dtype)
    else:
        def dense(x, p, route, out_dtype):
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
            attn = fused_mha_from_qkv(qkv, c.num_heads)
        else:
            q, k, v = (
                t.reshape(b, seq, c.num_heads, head_dim) for t in qkv.split(c.hidden_size, -1)
            )
            if use_flash_attention(q, None):
                attn = flash_mha(q, k, v)
            else:
                attn = dot_product_attention(q, k, v, None)
            attn = attn.reshape(b, seq, c.hidden_size)
        x = x + dense(attn, lyr["o"], route["o"], out_dtype=dtype)
        h = _layernorm(x, lyr["ln2"], eps)
        h = dense(h, lyr["fc1"], route["fc1"], out_dtype=torch.float32)
        h = act(h)
        x = x + dense(h, lyr["fc2"], route["fc2"], out_dtype=dtype)

    hidden = _layernorm(x, qparams["post_ln"], eps)    # (B, 1+P, D) f32
    feats = hidden[:, 1:, :] * hidden[:, :1, :]
    feats = _layernorm(feats, qparams["merged_ln"], eps)
    return feats.to(dtype)
