"""Local Hugging Face checkpoints for the port's detectors and VLMs (port of
``tstar_tpu/models/loader.py``).  No network.

A checkpoint directory holds ``config.json``, the weights
(``model.safetensors``, shards listed by ``model.safetensors.index.json``,
or ``pytorch_model.bin``) and the tokenizer's ``vocab.json`` /
``merges.txt``.  ``model.safetensors`` is parsed here, without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header naming each tensor's dtype, shape and byte range, then the bytes,
mapped from the file and viewed with ``torch.frombuffer``.  The model is
made on the meta device and takes the converted tensors, each moved to the
requested device and dtype (bf16 by default, as in the reference) one at a
time: no full-size copy is made on the host.  ``load_owlvit_checkpoint``
reads OWL-ViT (and OWLv2) detection checkpoints with the CLIP tokenizer;
``save_owlvit_checkpoint`` and ``save_vlm_checkpoint`` write a model back
under the checkpoint's names.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Dict, Mapping, Optional

import torch

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
for _name, _attr in (("U16", "uint16"), ("U32", "uint32"), ("U64", "uint64")):
    if hasattr(torch, _attr):
        SAFETENSORS_DTYPES[_name] = getattr(torch, _attr)
_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors viewing the
    file's mapped bytes (copied only where a tensor's offset is not a
    multiple of its element size)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else b""
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=base + begin)
        if (base + begin) % dtype.itemsize:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` as a ``.safetensors`` file (the format
    ``read_safetensors`` and the ``safetensors`` package read)."""
    header: Dict[str, Any] = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under {path}")


def _read_sharded_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Single-file and sharded (``model.safetensors.index.json``) checkpoints."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        out: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            out.update(read_safetensors(os.path.join(path, shard)))
        return out
    return _read_state_dict(path)


def config_from_hf_json(cfg: Dict[str, Any]):
    """An HF OWL-ViT ``config.json`` -> ``OwlViTConfig``."""
    from tstar_tpu_torch.models.owlvit import OwlViTConfig, TextConfig, VisionConfig

    v, t = cfg["vision_config"], cfg["text_config"]
    return OwlViTConfig(
        vision=VisionConfig(
            hidden_size=v.get("hidden_size", 768),
            num_layers=v.get("num_hidden_layers", 12),
            num_heads=v.get("num_attention_heads", 12),
            intermediate_size=v.get("intermediate_size", 3072),
            patch_size=v.get("patch_size", 32),
            image_size=v.get("image_size", 768),
            activation=v.get("hidden_act", "quick_gelu"),
            eps=v.get("layer_norm_eps", 1e-5),
        ),
        text=TextConfig(
            vocab_size=t.get("vocab_size", 49408),
            hidden_size=t.get("hidden_size", 512),
            num_layers=t.get("num_hidden_layers", 12),
            num_heads=t.get("num_attention_heads", 8),
            intermediate_size=t.get("intermediate_size", 2048),
            max_length=t.get("max_position_embeddings", 16),
            activation=t.get("hidden_act", "quick_gelu"),
            eps=t.get("layer_norm_eps", 1e-5),
        ),
        projection_dim=cfg.get("projection_dim", 512),
    )


def _owlvit_hf_config(cfg) -> Dict[str, Any]:
    """The ``config.json`` that ``config_from_hf_json`` reads back as ``cfg``."""
    v, t = cfg.vision, cfg.text
    return {
        "model_type": "owlvit", "projection_dim": cfg.projection_dim,
        "vision_config": {"hidden_size": v.hidden_size, "num_hidden_layers": v.num_layers,
                          "num_attention_heads": v.num_heads,
                          "intermediate_size": v.intermediate_size, "patch_size": v.patch_size,
                          "image_size": v.image_size, "hidden_act": v.activation,
                          "layer_norm_eps": v.eps},
        "text_config": {"vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
                        "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
                        "intermediate_size": t.intermediate_size,
                        "max_position_embeddings": t.max_length, "hidden_act": t.activation,
                        "layer_norm_eps": t.eps},
    }


def load_owlvit_checkpoint(checkpoint_dir: str, device="cuda", dtype=torch.bfloat16):
    """-> (OwlViTDetector, ClipTokenizer) from a local HF OWL-ViT / OWLv2
    detection checkpoint directory."""
    from tstar_tpu_torch.models.clip_tokenizer import ClipTokenizer
    from tstar_tpu_torch.models.convert import convert_hf_owlvit_state_dict
    from tstar_tpu_torch.models.owlvit import OwlViTDetector

    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        cfg = config_from_hf_json(json.load(f))
    sd = _read_state_dict(checkpoint_dir)
    # strip the framework prefix some exports carry
    sd = {(k[6:] if k.startswith("model.") else k): v for k, v in sd.items()}
    model = build_model(OwlViTDetector, cfg, convert_hf_owlvit_state_dict(sd, cfg), device, dtype)
    return model, ClipTokenizer.from_dir(checkpoint_dir, context=cfg.text.max_length)


def save_owlvit_checkpoint(model, checkpoint_dir: str) -> None:
    """Write an ``OwlViTDetector`` as an HF OWL-ViT checkpoint: ``config.json``
    and ``model.safetensors`` under HF's names (the tokenizer files are the
    caller's)."""
    from tstar_tpu_torch.models.convert import export_state_dict, owlvit_rules

    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, "config.json"), "w") as f:
        json.dump(_owlvit_hf_config(model.cfg), f)
    write_safetensors(export_state_dict(model.state_dict(), owlvit_rules(model.cfg)),
                      os.path.join(checkpoint_dir, "model.safetensors"))


def qwen2vl_config_from_hf_json(cfg: Dict[str, Any]):
    """An HF Qwen2-VL or Qwen2.5-VL ``config.json`` -> ``Qwen2VLConfig``
    (with a ``Qwen25VisionConfig`` for Qwen2.5-VL: a vision ``window_size``
    or ``out_hidden_size``, or a ``qwen2_5`` model type)."""
    from tstar_tpu_torch.models.qwen2vl import Qwen2VLConfig, Qwen2VLTextConfig, Qwen2VLVisionConfig

    t = cfg.get("text_config", cfg)
    v = cfg["vision_config"]
    rope_scaling = t.get("rope_scaling") or cfg.get("rope_scaling") or {}
    if "window_size" in v or "out_hidden_size" in v or cfg.get("model_type", "").startswith("qwen2_5"):
        from tstar_tpu_torch.models.qwen25_vision import Qwen25VisionConfig

        vision = Qwen25VisionConfig(
            depth=v.get("depth", 32),
            embed_dim=v.get("hidden_size", v.get("embed_dim", 1280)),
            num_heads=v.get("num_heads", 16),
            intermediate_size=v.get("intermediate_size", 3456),
            patch_size=v.get("patch_size", 14),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            hidden_size=v.get("out_hidden_size", t.get("hidden_size", 3584)),
            window_size=v.get("window_size", 112),
            fullatt_block_indexes=tuple(v.get("fullatt_block_indexes", (7, 15, 23, 31))),
        )
    else:
        vision = Qwen2VLVisionConfig(
            depth=v.get("depth", 32),
            embed_dim=v.get("embed_dim", 1280),
            num_heads=v.get("num_heads", 16),
            mlp_ratio=v.get("mlp_ratio", 4.0),
            patch_size=v.get("patch_size", 14),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            hidden_size=v.get("hidden_size", t.get("hidden_size", 3584)),
        )
    return Qwen2VLConfig(
        vision=vision,
        text=Qwen2VLTextConfig(
            vocab_size=t.get("vocab_size", 152064),
            hidden_size=t.get("hidden_size", 3584),
            num_layers=t.get("num_hidden_layers", 28),
            num_heads=t.get("num_attention_heads", 28),
            num_kv_heads=t.get("num_key_value_heads", 4),
            intermediate_size=t.get("intermediate_size", 18944),
            rms_norm_eps=t.get("rms_norm_eps", 1e-6),
            rope_theta=t.get("rope_theta", 1e6),
            mrope_section=tuple(rope_scaling.get("mrope_section", (16, 24, 24))),
            tie_word_embeddings=t.get("tie_word_embeddings", cfg.get("tie_word_embeddings", False)),
        ),
        image_token_id=cfg.get("image_token_id", 151655),
        video_token_id=cfg.get("video_token_id", 151656),
        vision_start_token_id=cfg.get("vision_start_token_id", 151652),
    )


def llava_onevision_config_from_hf_json(cfg: Dict[str, Any]):
    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionConfig
    from tstar_tpu_torch.models.qwen2vl import Qwen2VLTextConfig
    from tstar_tpu_torch.models.siglip import SiglipVisionConfig

    t = cfg["text_config"]
    v = cfg["vision_config"]
    head_dim = t.get("hidden_size", 3584) // t.get("num_attention_heads", 28)
    return LlavaOnevisionConfig(
        vision=SiglipVisionConfig(
            hidden_size=v.get("hidden_size", 1152),
            num_layers=v.get("num_hidden_layers", 27),
            num_heads=v.get("num_attention_heads", 16),
            intermediate_size=v.get("intermediate_size", 4304),
            patch_size=v.get("patch_size", 14),
            image_size=v.get("image_size", 384),
        ),
        text=Qwen2VLTextConfig(
            vocab_size=t.get("vocab_size", 152064),
            hidden_size=t.get("hidden_size", 3584),
            num_layers=t.get("num_hidden_layers", 28),
            num_heads=t.get("num_attention_heads", 28),
            num_kv_heads=t.get("num_key_value_heads", 4),
            intermediate_size=t.get("intermediate_size", 18944),
            rms_norm_eps=t.get("rms_norm_eps", 1e-6),
            rope_theta=t.get("rope_theta", 1e6),
            mrope_section=(head_dim // 2, 0, 0),   # plain 1-D rope
            tie_word_embeddings=t.get("tie_word_embeddings", False),
        ),
        image_token_id=cfg.get("image_token_index", 151646),
        video_token_id=cfg.get("video_token_index", 151647),
        vision_feature_layer=cfg.get("vision_feature_layer", -1),
        vision_feature_select_strategy=cfg.get("vision_feature_select_strategy", "full"),
        projector_bias=cfg.get("multimodal_projector_bias", True),
    )


def build_model(model_cls, cfg, state: Mapping[str, torch.Tensor], device="cuda",
                dtype: Optional[torch.dtype] = torch.bfloat16):
    """``model_cls(cfg)`` made on the meta device, holding ``state``'s
    tensors moved to ``device`` in ``dtype`` (strict: every parameter)."""
    with torch.device("meta"):
        model = model_cls(cfg)
    moved = {k: v.to(device=device, dtype=dtype) for k, v in state.items()}
    model.load_state_dict(moved, strict=True, assign=True)
    return model.requires_grad_(False).eval()


def _load(checkpoint_dir, config_fn, model_cls, convert_fn, device, dtype):
    from tstar_tpu_torch.models.qwen_tokenizer import QwenTokenizer

    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        cfg = config_fn(json.load(f))
    state = convert_fn(_read_sharded_state_dict(checkpoint_dir), cfg)
    model = build_model(model_cls, cfg, state, device, dtype)
    return model, QwenTokenizer.from_dir(checkpoint_dir)


def load_qwen2vl_checkpoint(checkpoint_dir: str, device="cuda", dtype=torch.bfloat16):
    """-> (Qwen2VLModel, QwenTokenizer) from a local HF directory."""
    from tstar_tpu_torch.models.qwen2vl import Qwen2VLModel, convert_hf_qwen2vl_state_dict

    return _load(checkpoint_dir, qwen2vl_config_from_hf_json, Qwen2VLModel,
                 convert_hf_qwen2vl_state_dict, device, dtype)


def load_llava_onevision_checkpoint(checkpoint_dir: str, device="cuda", dtype=torch.bfloat16):
    """-> (LlavaOnevisionModel, QwenTokenizer) from a local HF directory."""
    from tstar_tpu_torch.models.llava_onevision import (
        LlavaOnevisionModel, convert_hf_llava_onevision_state_dict,
    )

    return _load(checkpoint_dir, llava_onevision_config_from_hf_json, LlavaOnevisionModel,
                 convert_hf_llava_onevision_state_dict, device, dtype)


def load_vlm_checkpoint(checkpoint_dir: str, device="cuda", dtype=torch.bfloat16):
    """Family dispatch on ``config.json``'s ``model_type``."""
    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        model_type = json.load(f).get("model_type", "")
    if model_type.startswith("llava_onevision"):
        return load_llava_onevision_checkpoint(checkpoint_dir, device, dtype)
    return load_qwen2vl_checkpoint(checkpoint_dir, device, dtype)


def _hf_config(cfg) -> Dict[str, Any]:
    """The ``config.json`` that ``*_config_from_hf_json`` reads back as ``cfg``."""
    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionConfig

    t = cfg.text
    text = {"vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
            "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
            "num_key_value_heads": t.num_kv_heads, "intermediate_size": t.intermediate_size,
            "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta,
            "tie_word_embeddings": t.tie_word_embeddings}
    v = cfg.vision
    if isinstance(cfg, LlavaOnevisionConfig):
        return {
            "model_type": "llava_onevision", "text_config": dict(text, model_type="qwen2"),
            "vision_config": {"model_type": "siglip_vision_model", "hidden_size": v.hidden_size,
                              "num_hidden_layers": v.num_layers, "num_attention_heads": v.num_heads,
                              "intermediate_size": v.intermediate_size,
                              "patch_size": v.patch_size, "image_size": v.image_size},
            "image_token_index": cfg.image_token_id, "video_token_index": cfg.video_token_id,
            "vision_feature_layer": cfg.vision_feature_layer,
            "vision_feature_select_strategy": cfg.vision_feature_select_strategy,
            "multimodal_projector_bias": cfg.projector_bias,
        }
    if hasattr(v, "window_size"):      # Qwen2.5-VL: HF's vision names
        model_type = "qwen2_5_vl"
        vision = {"depth": v.depth, "hidden_size": v.embed_dim, "num_heads": v.num_heads,
                  "intermediate_size": v.intermediate_size, "patch_size": v.patch_size,
                  "temporal_patch_size": v.temporal_patch_size,
                  "spatial_merge_size": v.spatial_merge_size, "out_hidden_size": v.hidden_size,
                  "window_size": v.window_size,
                  "fullatt_block_indexes": list(v.fullatt_block_indexes)}
    else:
        model_type = "qwen2_vl"
        vision = {"depth": v.depth, "embed_dim": v.embed_dim, "num_heads": v.num_heads,
                  "mlp_ratio": v.mlp_ratio, "patch_size": v.patch_size,
                  "temporal_patch_size": v.temporal_patch_size,
                  "spatial_merge_size": v.spatial_merge_size, "hidden_size": v.hidden_size}
    return {
        "model_type": model_type,
        "text_config": dict(text, rope_scaling={"type": "mrope",
                                                "mrope_section": list(t.mrope_section)}),
        "vision_config": vision,
        "image_token_id": cfg.image_token_id, "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
    }


def save_vlm_checkpoint(model, checkpoint_dir: str) -> None:
    """Write ``model`` as a Hugging Face checkpoint: ``config.json`` and
    ``model.safetensors`` under the checkpoint's names (the tokenizer files
    are the caller's)."""
    from tstar_tpu_torch.models.convert import export_state_dict
    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionModel, llava_rules
    from tstar_tpu_torch.models.qwen2vl import qwen2vl_rules

    rules = (llava_rules if isinstance(model, LlavaOnevisionModel) else qwen2vl_rules)(model.cfg)
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, "config.json"), "w") as f:
        json.dump(_hf_config(model.cfg), f)
    write_safetensors(export_state_dict(model.state_dict(), rules),
                      os.path.join(checkpoint_dir, "model.safetensors"))
