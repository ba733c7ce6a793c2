"""SigLIP vision tower (port of ``tstar_tpu/models/siglip.py``), LLaVA-OneVision's
image encoder.

HF ``SiglipVisionModel``: a strided patch embedding (no CLS token), learned
position embeddings, pre-LN encoder layers with tanh-approximated GELU.  The
tower returns the selected layer's hidden states without the final
post-layernorm (LLaVA-OV's ``vision_feature_layer``).  The reference
computes ``post_layernorm`` and drops the result, which XLA removes: the port
keeps the parameter and never applies it, so a forward runs K3 exactly twice
a layer (D = 1152 = 9 x 128 is a width K3 takes).  The patch embedding is an
``nn.Conv`` in the reference, which XLA computes (not K2): here it is one
matmul over the flattened patches.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping

import torch
from torch import nn

from tstar_tpu_torch.kernels.image import patchify_rect
from tstar_tpu_torch.models.convert import Rule, rule
from tstar_tpu_torch.models.transformer import EncoderLayer, LayerNorm


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    patch_size: int = 14
    image_size: int = 384
    eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class PatchEmbedding(nn.Module):
    """flax ``nn.Conv`` with stride = kernel, VALID: kernel (p, p, 3, D)."""

    def __init__(self, patch_size: int, d: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(patch_size, patch_size, 3, d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, (S // p)^2, D); the remainder rows and
        columns are dropped, as VALID does."""
        p = self.kernel.shape[0]
        side = pixels.shape[1] // p * p
        x = patchify_rect(pixels[:, :side, :side], p, p)
        return torch.matmul(x, self.kernel.reshape(-1, self.kernel.shape[-1])) + self.bias


class SiglipVisionTower(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_embedding = PatchEmbedding(cfg.patch_size, d)
        self.position_embedding = nn.Parameter(torch.empty(cfg.num_patches, d))
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg.num_heads, cfg.intermediate_size, "gelu_tanh", cfg.eps)
            for _ in range(cfg.num_layers)
        )
        self.post_layernorm = LayerNorm(d, cfg.eps)   # in checkpoints; never applied

    def forward(self, pixels: torch.Tensor, feature_layer: int = -1) -> torch.Tensor:
        """pixels (B, S, S, 3) normalized -> hidden states of the selected
        layer (B, P, D); ``feature_layer`` indexes [embeddings, layer 1, ...]
        as HF's ``hidden_states`` do.  Layers after it are not run."""
        dtype = self.position_embedding.dtype
        x = self.patch_embedding(pixels.to(dtype)) + self.position_embedding
        n = len(self.layers) + 1
        stop = feature_layer if feature_layer >= 0 else n + feature_layer
        if not 0 <= stop < n:
            raise ValueError(f"feature_layer {feature_layer} outside {n} hidden states")
        for layer in self.layers[:stop]:
            x = layer(x)
        return x


def siglip_rules(cfg: SiglipVisionConfig, prefix: str, port: str = "") -> List[Rule]:
    """HF ``SiglipVisionModel`` names under ``prefix`` -> the tower's
    parameters under ``port`` (the reference's ``convert_hf_siglip``)."""

    def lin(name, hf):
        return [rule(f"{port}{name}.kernel", f"{prefix}{hf}.weight", kind="T"),
                rule(f"{port}{name}.bias", f"{prefix}{hf}.bias")]

    def ln(name, hf):
        return [rule(f"{port}{name}.scale", f"{prefix}{hf}.weight"),
                rule(f"{port}{name}.bias", f"{prefix}{hf}.bias")]

    rules = [
        rule(f"{port}patch_embedding.kernel", f"{prefix}embeddings.patch_embedding.weight", kind="hwio"),
        rule(f"{port}patch_embedding.bias", f"{prefix}embeddings.patch_embedding.bias"),
        rule(f"{port}position_embedding", f"{prefix}embeddings.position_embedding.weight"),
        *ln("post_layernorm", "post_layernorm"),
    ]
    for i in range(cfg.num_layers):
        lp, hp = f"layers.{i}.", f"encoder.layers.{i}."
        attn = f"{prefix}{hp}self_attn."
        rules += [
            *ln(lp + "layer_norm1", hp + "layer_norm1"),
            *ln(lp + "layer_norm2", hp + "layer_norm2"),
            rule(f"{port}{lp}self_attn.qkv_kernel", *(f"{attn}{t}_proj.weight" for t in "qkv"), kind="catT"),
            rule(f"{port}{lp}self_attn.qkv_bias", *(f"{attn}{t}_proj.bias" for t in "qkv"), kind="cat"),
            *lin(lp + "self_attn.out_proj", hp + "self_attn.out_proj"),
            *lin(lp + "mlp.fc1", hp + "mlp.fc1"),
            *lin(lp + "mlp.fc2", hp + "mlp.fc2"),
        ]
    return rules


def convert_hf_siglip(sd: Mapping[str, torch.Tensor], cfg: SiglipVisionConfig, prefix: str):
    """HF SiglipVisionModel weights (under ``prefix``) -> a state dict for
    ``SiglipVisionTower``."""
    from tstar_tpu_torch.models.convert import convert_state_dict

    return convert_state_dict(sd, siglip_rules(cfg, prefix))
