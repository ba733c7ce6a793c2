"""CLIP-style pre-norm transformer blocks (port of ``tstar_tpu/models/transformer.py``).

Layouts follow the reference: Dense kernels are (in, out), and the q/k/v
projections run as ONE (D, 3D) matmul whose (B, S, 3D) output the fused
attention kernel (K1) reads directly.  A module computes in the dtype of its
parameters (``model.to(torch.bfloat16)`` for the card, float32 for parity
tests).  LayerNorms go through K3 at the widths it takes (``supported_width``:
the reference kernel's, a multiple of 128) and through the same f32 math in
plain tensor ops at the others, as the reference sends those to XLA.  Self-attention takes the reference's
order: K1 when there is no bias, the head width is K1's (64) and
``use_fused_mha`` (off under ``TSTAR_FUSED_MHA=0``); otherwise the heads are
split and the call goes to
K8 ``flash_mha`` if ``use_flash_attention``, else to
``bf16_probs_attention`` if ``use_bf16_probs``, else to plain masked softmax
attention, which the text tower's causal + padding bias always takes.  Each
pre-norm LayerNorm is handed to the projection it
feeds (ln1 -> qkv, ln2 -> fc1), which folds it into its matmul through K5
when ``use_ln_matmul`` says so (``TSTAR_LN_MATMUL``); otherwise it is K3,
then ``torch.matmul``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from tstar_tpu_torch.kernels.attention import (
    HEAD_DIM,
    bf16_probs_attention,
    flash_mha,
    fused_mha_from_qkv,
    use_bf16_probs,
    use_flash_attention,
    use_fused_mha,
)
from tstar_tpu_torch.kernels.layernorm import (
    fused_layernorm,
    fused_layernorm_plain,
    supported_width,
)
from tstar_tpu_torch.kernels.ln_matmul import ln_matmul, use_ln_matmul
from tstar_tpu_torch.models.tensor_parallel import all_gather_last, all_reduce_


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS: Dict[str, Callable] = {
    "quick_gelu": quick_gelu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with a (in, out) kernel, as flax's Dense.

    Under tensor parallelism (``parallel/shardings.shard_module``) a
    row-parallel layer (``reduce``) all-reduces its product over the model
    group before its whole bias is added once; a vocabulary-parallel head
    (``gather``) all-gathers its columns."""

    reduce = None       # TensorParallel of a row-parallel layer
    gather = None       # TensorParallel of a vocabulary-parallel head

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.kernel)
        if self.reduce is not None:
            all_reduce_(y, self.reduce)
        if self.gather is not None:
            y = all_gather_last(y, self.gather)
        return y if self.bias is None else y + self.bias


def apply_layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm in ``scale``'s dtype: f32 stats, ``use_fast_variance`` math
    (K3 on a CUDA tensor, its plain version on a CPU tensor).  A width K3
    does not take (not a multiple of 128) runs the same math in plain tensor
    ops on either device, as the reference's gate sends it to XLA."""
    x = x.to(scale.dtype).contiguous()
    if not supported_width(x.shape[-1], x.dtype):
        return fused_layernorm_plain(x, scale, bias, eps)
    return fused_layernorm(x, scale, bias, eps)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_layernorm(x, self.scale, self.bias, self.eps)


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor]
) -> torch.Tensor:
    """(B, S, H, Dh) attention with an additive bias, as
    ``jax.nn.dot_product_attention``: f32 logits and softmax, probs cast to
    the value dtype for the AV product."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, vh).permute(0, 2, 1, 3)


class MultiHeadAttention(nn.Module):
    """Self-attention with the fused (D, 3D) q|k|v projection.  Under tensor
    parallelism the projection holds this rank's [q_r | k_r | v_r] sections
    and ``num_heads`` its heads (``parallel/shardings.shard_module``), and
    ``out_proj`` is row-parallel."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"width {d} not divisible by {num_heads} heads")
        self.num_heads, self.head_dim = num_heads, d // num_heads
        self.qkv_kernel = nn.Parameter(torch.empty(d, 3 * d))
        self.qkv_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Dense(d, d)

    def forward(
        self, x: torch.Tensor, ln: "LayerNorm", attn_bias: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """``x`` is the residual stream; ``ln``, the pre-norm applied to it
        first, folds into the q|k|v projection when it may."""
        d = self.num_heads * self.head_dim       # this rank's q|k|v width
        if use_ln_matmul(x, 3 * d):
            qkv = ln_matmul(x, ln.scale, ln.bias, self.qkv_kernel, self.qkv_bias, ln.eps)
        else:
            qkv = torch.matmul(ln(x), self.qkv_kernel) + self.qkv_bias   # (B, S, 3D)
        # K1 has one head width; others (SigLIP's 72) take the split-head
        # routes below, as the reference's gate sends them to XLA
        if attn_bias is None and self.head_dim == HEAD_DIM and use_fused_mha():
            return self.out_proj(fused_mha_from_qkv(qkv, self.num_heads))
        q, k, v = (
            t.reshape(*t.shape[:-1], self.num_heads, self.head_dim)
            for t in qkv.split(d, dim=-1)
        )
        if use_flash_attention(q, attn_bias):
            out = flash_mha(q, k, v)
        elif use_bf16_probs(q, attn_bias):
            out = bf16_probs_attention(q, k, v)
        else:
            out = dot_product_attention(q, k, v, attn_bias)
        return self.out_proj(out.reshape(*x.shape[:-1], d))


class TransformerMLP(nn.Module):
    def __init__(self, d: int, intermediate_size: int, activation: str = "quick_gelu"):
        super().__init__()
        self.fc1 = Dense(d, intermediate_size)
        self.fc2 = Dense(intermediate_size, d)
        self.activation = activation

    def forward(self, x: torch.Tensor, ln: "LayerNorm") -> torch.Tensor:
        """``x`` is the residual stream; ``ln``, the pre-norm applied to it
        first, folds into fc1 when it may (see MultiHeadAttention)."""
        fc1 = self.fc1
        if use_ln_matmul(x, fc1.kernel.shape[1]):
            h = ln_matmul(x, ln.scale, ln.bias, fc1.kernel, fc1.bias, ln.eps)
        else:
            h = fc1(ln(x))
        return self.fc2(ACTIVATIONS[self.activation](h))


class EncoderLayer(nn.Module):
    """Pre-norm block: x += attn(ln1(x)); x += mlp(ln2(x))."""

    def __init__(self, d, num_heads, intermediate_size, activation="quick_gelu", eps=1e-5):
        super().__init__()
        self.layer_norm1 = LayerNorm(d, eps)
        self.self_attn = MultiHeadAttention(d, num_heads)
        self.layer_norm2 = LayerNorm(d, eps)
        self.mlp = TransformerMLP(d, intermediate_size, activation)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None):
        x = x + self.self_attn(x, self.layer_norm1, attn_bias)
        return x + self.mlp(x, self.layer_norm2)


class Encoder(nn.Module):
    def __init__(self, num_layers, d, num_heads, intermediate_size,
                 activation="quick_gelu", eps=1e-5):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d, num_heads, intermediate_size, activation, eps)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None):
        for layer in self.layers:
            x = layer(x, attn_bias)
        return x


def causal_bias(seq_len: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask (1, 1, S, S)."""
    mask = torch.tril(torch.ones(seq_len, seq_len, dtype=torch.bool, device=device))
    neg = torch.finfo(dtype).min
    return torch.where(mask, 0.0, neg).to(dtype)[None, None]


def padding_bias(attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Additive key-padding mask (B, 1, 1, S) from a 0/1 mask (B, S)."""
    neg = torch.finfo(dtype).min
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg).to(dtype)
