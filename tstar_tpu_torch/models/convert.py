"""Name tables between Hugging Face checkpoints and the port's state dicts.

A model's table is a list of ``Rule``: a port parameter, the checkpoint
names it is made from (each given as a tuple of alternatives, the first
present is read), and how.  The same table converts a checkpoint into a
state dict (``convert_state_dict``, as the reference's ``convert_hf_*``
do) and writes a state dict back under the checkpoint's names
(``export_state_dict``: what a checkpoint of the same weights would hold).

Kinds:
  ``=``     copy;
  ``T``     a ``nn.Linear`` weight (out, in) -> a Dense kernel (in, out);
  ``hwio``  a conv weight (O, I, H, W) -> flax's (H, W, I, O);
  ``flat``  a conv weight (O, ...) -> one matmul kernel (prod(...), O);
  ``cat``   several vectors concatenated (fused q|k|v bias);
  ``catT``  several Linear weights, each transposed, side by side (fused
            q|k|v kernel, columns [q | k | v]).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Rule:
    port: str
    sources: Tuple[Tuple[str, ...], ...]   # per source tensor, its alternative names
    kind: str = "="
    shape: Tuple[int, ...] = ()            # ``flat``: the checkpoint tensor's shape


def rule(port: str, *names, kind: str = "=", shape: Sequence[int] = ()) -> Rule:
    """One source tensor: ``names`` are its alternatives; ``cat``/``catT``:
    each of ``names`` is a tuple of alternatives for one part."""
    if kind in ("cat", "catT"):
        sources = tuple(tuple(n) if isinstance(n, tuple) else (n,) for n in names)
    else:
        sources = (tuple(names),)
    return Rule(port, sources, kind, tuple(shape))


def _pick(sd: Mapping[str, torch.Tensor], names: Tuple[str, ...]) -> torch.Tensor:
    for n in names:
        if n in sd:
            return sd[n]
    raise KeyError(f"checkpoint has none of {names}")


def convert_state_dict(sd: Mapping[str, torch.Tensor], rules: List[Rule]) -> Dict[str, torch.Tensor]:
    """Checkpoint tensors -> the port's state dict (dtype and device kept)."""
    out: Dict[str, torch.Tensor] = {}
    for r in rules:
        parts = [_pick(sd, names) for names in r.sources]
        w = parts[0]
        if r.kind == "=":
            out[r.port] = w
        elif r.kind == "T":
            out[r.port] = w.t().contiguous()
        elif r.kind == "hwio":
            out[r.port] = w.permute(2, 3, 1, 0).contiguous()
        elif r.kind == "flat":
            out[r.port] = w.reshape(w.shape[0], -1).t().contiguous()
        elif r.kind == "cat":
            out[r.port] = torch.cat(parts, dim=0)
        elif r.kind == "catT":
            out[r.port] = torch.cat([p.t() for p in parts], dim=1).contiguous()
        else:
            raise ValueError(f"unknown rule kind {r.kind!r}")
    return out


def export_state_dict(state: Mapping[str, torch.Tensor], rules: List[Rule]) -> Dict[str, torch.Tensor]:
    """The port's state dict -> checkpoint tensors under each source's first
    name (the inverse of ``convert_state_dict``)."""
    out: Dict[str, torch.Tensor] = {}
    for r in rules:
        w = state[r.port]
        names = [alts[0] for alts in r.sources]
        if r.kind == "=":
            parts = [w]
        elif r.kind == "T":
            parts = [w.t()]
        elif r.kind == "hwio":
            parts = [w.permute(3, 2, 0, 1)]
        elif r.kind == "flat":
            parts = [w.t().reshape(r.shape)]
        elif r.kind == "cat":
            parts = list(w.chunk(len(names), dim=0))
        elif r.kind == "catT":
            parts = [p.t() for p in w.chunk(len(names), dim=1)]
        else:
            raise ValueError(f"unknown rule kind {r.kind!r}")
        for n, p in zip(names, parts):
            out[n] = p.contiguous()
    return out


# ---------------------------------------------------------------------------
# CLIP encoders (OWL-ViT's towers, YOLO-World's text tower)
# ---------------------------------------------------------------------------

def clip_encoder_rules(port: str, hf: str, num_layers: int) -> List[Rule]:
    """A CLIP encoder's layers: HF ``{hf}.layers.i`` (separate q/k/v
    projections, ``nn.Linear`` weights) -> the port's ``{port}.layers.i``
    (one fused (D, 3D) q|k|v kernel, Dense kernels (in, out))."""
    rules: List[Rule] = []
    for i in range(num_layers):
        p, h = f"{port}.layers.{i}", f"{hf}.layers.{i}"
        a = f"{h}.self_attn"
        rules += [
            *layernorm_rules(f"{p}.layer_norm1", f"{h}.layer_norm1"),
            *layernorm_rules(f"{p}.layer_norm2", f"{h}.layer_norm2"),
            rule(f"{p}.self_attn.qkv_kernel", f"{a}.q_proj.weight", f"{a}.k_proj.weight",
                 f"{a}.v_proj.weight", kind="catT"),
            rule(f"{p}.self_attn.qkv_bias", f"{a}.q_proj.bias", f"{a}.k_proj.bias",
                 f"{a}.v_proj.bias", kind="cat"),
            *linear_rules(f"{p}.self_attn.out_proj", f"{a}.out_proj"),
            *linear_rules(f"{p}.mlp.fc1", f"{h}.mlp.fc1"),
            *linear_rules(f"{p}.mlp.fc2", f"{h}.mlp.fc2"),
        ]
    return rules


def linear_rules(port: str, hf: str) -> List[Rule]:
    return [rule(f"{port}.kernel", f"{hf}.weight", kind="T"), rule(f"{port}.bias", f"{hf}.bias")]


def layernorm_rules(port: str, hf: str) -> List[Rule]:
    return [rule(f"{port}.scale", f"{hf}.weight"), rule(f"{port}.bias", f"{hf}.bias")]


def clip_text_rules(port: str, hf: str, num_layers: int) -> List[Rule]:
    """HF ``CLIPTextTransformer`` under ``hf`` -> the port's ``TextTower``."""
    return [
        rule(f"{port}.token_embedding", f"{hf}.embeddings.token_embedding.weight"),
        rule(f"{port}.position_embedding", f"{hf}.embeddings.position_embedding.weight"),
        *clip_encoder_rules(f"{port}.encoder", f"{hf}.encoder", num_layers),
        *layernorm_rules(f"{port}.final_layer_norm", f"{hf}.final_layer_norm"),
    ]


def owlvit_rules(cfg, base: str = "owlvit") -> List[Rule]:
    """HF ``OwlViTForObjectDetection`` (``base`` "owlvit") or
    ``Owlv2ForObjectDetection`` ("owlv2") -> the port's ``OwlViTDetector``.
    OWLv2's objectness head is not read: the T* scoring path uses the class
    logits only."""
    v, t = f"{base}.vision_model", f"{base}.text_model"
    return [
        rule("vision.patch_embedding.kernel", f"{v}.embeddings.patch_embedding.weight",
             kind="hwio"),
        rule("vision.class_embedding", f"{v}.embeddings.class_embedding"),
        rule("vision.position_embedding", f"{v}.embeddings.position_embedding.weight"),
        *layernorm_rules("vision.pre_layernorm", f"{v}.pre_layernorm"),
        *clip_encoder_rules("vision.encoder", f"{v}.encoder", cfg.vision.num_layers),
        *clip_text_rules("text", t, cfg.text.num_layers),
        rule("text_projection.kernel", f"{base}.text_projection.weight", kind="T"),
        *layernorm_rules("post_layernorm", f"{v}.post_layernorm"),
        *layernorm_rules("merged_layernorm", "layer_norm"),
        *(r for d in ("dense0", "dense1", "dense2")
          for r in linear_rules(f"box_head.{d}", f"box_head.{d}")),
        *(r for d in ("dense0", "logit_shift", "logit_scale")
          for r in linear_rules(f"class_head.{d}", f"class_head.{d}")),
    ]


def convert_hf_owlvit_state_dict(sd: Mapping[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """An HF OWL-ViT / OWLv2 detection state dict (the ``owlv2.`` prefix is
    detected) -> a state dict for ``OwlViTDetector``."""
    base = "owlv2" if any(k.startswith("owlv2.") for k in sd) else "owlvit"
    return convert_state_dict(sd, owlvit_rules(cfg, base))
