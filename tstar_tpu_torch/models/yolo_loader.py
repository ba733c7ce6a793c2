"""mmdet/mmyolo YOLO-World v2 checkpoints (port of ``tstar_tpu/models/yolo_loader.py``).

Reads the reference's production detector checkpoint format (an mmyolo
``.pth`` state dict, e.g. ``yolo_world_v2_xl_obj365v1_goldg_cc3mlite_pretrain-
5daf1395.pth``) with ``torch.load(weights_only=True)``, without mmdet or
mmcv (``load_pth``: the non-tensor metadata such a file carries loads as
inert placeholders; no code from the file runs), onto the port's
``YoloWorldDetector`` and ``YoloTextEncoder``.  Every BatchNorm folds into
the inference-time ``bn_scale`` / ``bn_bias`` (eps ``BN_EPS``).  Names:

  backbone.image_model.stem                     -> stem
  backbone.image_model.stage{i}.0 / .1          -> stage{i}_down / stage{i}_csp
  backbone.image_model.stage4.2                 -> sppf
  neck.top_down_layers.{k} / bottom_up_layers.{k} / downsample_layers.{k}
                                                -> top_down{k} / bottom_up{k} / downsample{k}
  bbox_head.head_module.{cls,reg}_preds.{l}.{b} -> {cls,reg}_pred{l}_{b}
  bbox_head.head_module.cls_contrasts.{l}       -> contrast{l}_* (BN folded)
  backbone.text_model.model.text_model          -> YoloTextEncoder.text
  backbone.text_model.model.text_projection     -> YoloTextEncoder.text_projection

The same table, read backwards, writes a model under mmyolo's names
(``export_mmyolo_state_dict``; each BN as scale, bias, mean 0 and a variance
whose ``+ BN_EPS`` is 1).  Conversion consumes every checkpoint tensor
exactly once: a tensor missing, read twice or left over (beyond the
allowlisted buffers) raises ``ConversionError``, and so does a converted
tensor whose shape is not the model's.  A directory without a ``.pth`` may
hold the reference's native ``yolo_world.npz`` / ``text_tower.npz`` (flax
parameters flattened with ``|``), read with numpy.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from tstar_tpu_torch.models.convert import Rule, clip_text_rules, rule

BN_EPS = 1e-3  # mmyolo norm_cfg dict(type='BN', momentum=0.03, eps=0.001)

# Non-parameter checkpoint entries that are correct to drop.
_IGNORED_SUFFIXES = ("num_batches_tracked", "position_ids")
_IGNORED_KEYS = ("bbox_head.head_module.proj",)      # DFL arange buffer
_IGNORED_PREFIXES = ("data_preprocessor.",)          # mean/std buffers (inputs are /255)


class ConversionError(ValueError):
    pass


class _TrackedDict:
    """State-dict wrapper that records consumption for exactly-once checks."""

    def __init__(self, sd: Mapping[str, torch.Tensor]):
        self.sd = sd
        self.used: set = set()

    def take(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise ConversionError(f"checkpoint is missing tensor {key!r}")
        if key in self.used:
            raise ConversionError(f"tensor {key!r} consumed twice")
        self.used.add(key)
        return torch.as_tensor(self.sd[key]).detach().to("cpu", torch.float32)

    def leftovers(self) -> List[str]:
        return [k for k in self.sd if k not in self.used and not k.endswith(_IGNORED_SUFFIXES)
                and k not in _IGNORED_KEYS and not k.startswith(_IGNORED_PREFIXES)]


# ---- the table ---------------------------------------------------------------
# Detector entries: (kind, port prefix, mmyolo prefix).  Kinds: "convbn" (conv
# weight + folded BN), "conv" (weight + bias), "dense" (nn.Linear -> Dense),
# "param" (one tensor, reshaped to the port's), "bn" (a BN folded into
# {port}_bn_scale / {port}_bn_bias).

def _csp_entries(port: str, mm: str, depth: int, attn: bool, embed_conv: bool):
    out = [("convbn", f"{port}.main_conv", f"{mm}.main_conv"),
           ("convbn", f"{port}.final_conv", f"{mm}.final_conv")]
    for j in range(depth):
        out += [("convbn", f"{port}.blocks_{j}.conv1", f"{mm}.blocks.{j}.conv1"),
                ("convbn", f"{port}.blocks_{j}.conv2", f"{mm}.blocks.{j}.conv2")]
    if attn:
        a, am = f"{port}.attn_block", f"{mm}.attn_block"
        out += [("dense", f"{a}.guide_fc", f"{am}.guide_fc"), ("param", f"{a}.bias", f"{am}.bias"),
                ("convbn", f"{a}.project_conv", f"{am}.project_conv")]
        if embed_conv:
            out.append(("convbn", f"{a}.embed_conv", f"{am}.embed_conv"))
    return out


def detector_entries(cfg) -> List[Tuple[str, str, str]]:
    bb, hm = "backbone.image_model", "bbox_head.head_module"
    w, e = cfg.widths, cfg.neck_embed
    out = [("convbn", "stem", f"{bb}.stem")]
    for i, depth in enumerate(cfg.depths, start=1):
        out.append(("convbn", f"stage{i}_down", f"{bb}.stage{i}.0"))
        out += _csp_entries(f"stage{i}_csp", f"{bb}.stage{i}.1", depth, False, False)
    out += [("convbn", "sppf.conv1", f"{bb}.stage4.2.conv1"),
            ("convbn", "sppf.conv2", f"{bb}.stage4.2.conv2")]
    # each fusion block's mid width and embed width (embed_conv iff they differ)
    fusions = {"top_down0": (w[3] // 2, e[1]), "top_down1": (w[2] // 2, e[0]),
               "bottom_up0": (w[3] // 2, e[1]), "bottom_up1": (w[4] // 2, e[2])}
    for k in range(2):
        for port, mm in ((f"top_down{k}", f"neck.top_down_layers.{k}"),
                         (f"bottom_up{k}", f"neck.bottom_up_layers.{k}")):
            mid, embed = fusions[port]
            out += _csp_entries(port, mm, cfg.neck_depth, True, embed != mid)
        out.append(("convbn", f"downsample{k}", f"neck.downsample_layers.{k}"))
    for l in range(3):
        for b in range(2):
            out += [("convbn", f"cls_pred{l}_{b}", f"{hm}.cls_preds.{l}.{b}"),
                    ("convbn", f"reg_pred{l}_{b}", f"{hm}.reg_preds.{l}.{b}")]
        cc = f"{hm}.cls_contrasts.{l}"
        out += [("conv", f"cls_pred{l}_2", f"{hm}.cls_preds.{l}.2"),
                ("conv", f"reg_pred{l}_2", f"{hm}.reg_preds.{l}.2"),
                ("bn", f"contrast{l}", f"{cc}.norm"),
                ("param", f"contrast{l}_bias", f"{cc}.bias"),
                ("param", f"contrast{l}_logit_scale", f"{cc}.logit_scale")]
    return out


def text_rules(num_layers: int) -> List[Rule]:
    """HF ``CLIPTextModelWithProjection`` inside the backbone -> ``YoloTextEncoder``."""
    tm = "backbone.text_model.model"
    return [*clip_text_rules("text", f"{tm}.text_model", num_layers),
            rule("text_projection.kernel", f"{tm}.text_projection.weight", kind="T")]


def _fold_bn(sd: _TrackedDict, prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """scale = gamma / sqrt(var + eps), bias = beta - mean * scale, in numpy
    f32 as the reference folds (``torch.sqrt`` on the CPU rounds a few
    values apart from the correctly rounded square root)."""
    gamma, beta, mean, var = (
        sd.take(f"{prefix}.{n}").numpy() for n in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / np.sqrt(var + np.float32(BN_EPS))
    return torch.from_numpy(scale), torch.from_numpy(beta - mean * scale)


def _convert_entry(sd: _TrackedDict, kind: str, port: str, mm: str, out: Dict, shapes: Mapping):
    if kind == "convbn":
        out[f"{port}.conv.weight"] = sd.take(f"{mm}.conv.weight")
        out[f"{port}.bn_scale"], out[f"{port}.bn_bias"] = _fold_bn(sd, f"{mm}.bn")
    elif kind == "conv":
        out[f"{port}.weight"], out[f"{port}.bias"] = sd.take(f"{mm}.weight"), sd.take(f"{mm}.bias")
    elif kind == "dense":
        out[f"{port}.kernel"] = sd.take(f"{mm}.weight").t().contiguous()
        out[f"{port}.bias"] = sd.take(f"{mm}.bias")
    elif kind == "param":
        t = sd.take(mm)
        if t.numel() != shapes[port].numel():
            raise ConversionError(f"{mm}: {tuple(t.shape)} does not fit {port} {tuple(shapes[port])}")
        out[port] = t.reshape(shapes[port])
    elif kind == "bn":
        out[f"{port}_bn_scale"], out[f"{port}_bn_bias"] = _fold_bn(sd, mm)
    else:
        raise ValueError(f"unknown entry kind {kind!r}")


def _count_text_layers(sd: Mapping) -> int:
    t = "backbone.text_model.model.text_model.encoder.layers"
    n = 0
    while f"{t}.{n}.layer_norm1.weight" in sd:
        n += 1
    return n


def _shapes(cls, *args) -> Dict[str, torch.Size]:
    with torch.device("meta"):
        return {k: v.shape for k, v in cls(*args).state_dict().items()}


def _check_shapes(state: Mapping[str, torch.Tensor], want: Mapping[str, torch.Size], what: str):
    missing, extra = sorted(set(want) - set(state)), sorted(set(state) - set(want))
    if missing or extra:
        raise ConversionError(f"{what}: converted tree mismatch; missing={missing[:8]} "
                              f"extra={extra[:8]}")
    bad = [(k, tuple(state[k].shape), tuple(want[k])) for k in want if state[k].shape != want[k]]
    if bad:
        raise ConversionError(f"{what}: shape mismatches {bad[:8]}")


def convert_mmyolo_yolo_world_state_dict(raw_sd: Mapping[str, torch.Tensor], cfg, strict: bool = True):
    """-> (detector state dict, text encoder state dict), f32 CPU tensors.
    ``cfg`` is the ``YoloWorldConfig`` of the checkpoint's architecture."""
    from tstar_tpu_torch.models.convert import convert_state_dict
    from tstar_tpu_torch.models.yoloworld import YoloWorldDetector

    sd = _TrackedDict(raw_sd)
    shapes = _shapes(YoloWorldDetector, cfg)
    det: Dict[str, torch.Tensor] = {}
    for kind, port, mm in detector_entries(cfg):
        _convert_entry(sd, kind, port, mm, det, shapes)
    n_layers = _count_text_layers(raw_sd)
    if n_layers == 0:
        raise ConversionError("no CLIP text layers found under backbone.text_model.model — "
                              "is this a YOLO-World checkpoint?")
    rules = text_rules(n_layers)
    for r in rules:
        for names in r.sources:
            sd.take(names[0])          # record each source once (missing -> ConversionError)
    text = {k: v.float() for k, v in convert_state_dict(raw_sd, rules).items()}
    if strict:
        left = sd.leftovers()
        if left:
            raise ConversionError(f"{len(left)} checkpoint tensors were not consumed "
                                  f"(first 10: {left[:10]}); architecture/config mismatch?")
    return det, text


def validate_converted_shapes(cfg, text_cfg, det_state, text_state) -> None:
    """Structural check: the converted tensors are the models' parameters,
    name for name and shape for shape."""
    from tstar_tpu_torch.models.yoloworld import YoloTextEncoder, YoloWorldDetector

    _check_shapes(det_state, _shapes(YoloWorldDetector, cfg), "detector")
    _check_shapes(text_state, _shapes(YoloTextEncoder, text_cfg, cfg.text_dim), "text encoder")


def export_mmyolo_state_dict(det_state: Mapping[str, torch.Tensor],
                             text_state: Mapping[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """The port's state dicts -> tensors under mmyolo's names, which
    ``convert_mmyolo_yolo_world_state_dict`` reads back to the same values:
    each folded BN is written as weight = scale, bias = bias, mean 0 and a
    variance v with f32(v + BN_EPS) = 1."""
    from tstar_tpu_torch.models.convert import export_state_dict
    from tstar_tpu_torch.models.yoloworld import text_config_from_state

    out: Dict[str, torch.Tensor] = {}

    unit_var = torch.tensor(1.0 - BN_EPS, dtype=torch.float32)
    if float(np.sqrt(unit_var.numpy() + np.float32(BN_EPS))) != 1.0:
        raise ConversionError("no f32 variance folds to a unit scale")

    def bn(prefix, scale, bias):
        # mean and variance in f32, whatever the weights' dtype
        out.update({f"{prefix}.weight": scale, f"{prefix}.bias": bias,
                    f"{prefix}.running_mean": torch.zeros(scale.shape, device=scale.device),
                    f"{prefix}.running_var": unit_var.to(scale.device).expand(scale.shape)})

    for kind, port, mm in detector_entries(cfg):
        if kind == "convbn":
            out[f"{mm}.conv.weight"] = det_state[f"{port}.conv.weight"]
            bn(f"{mm}.bn", det_state[f"{port}.bn_scale"], det_state[f"{port}.bn_bias"])
        elif kind == "conv":
            out[f"{mm}.weight"], out[f"{mm}.bias"] = det_state[f"{port}.weight"], det_state[f"{port}.bias"]
        elif kind == "dense":
            out[f"{mm}.weight"] = det_state[f"{port}.kernel"].t().contiguous()
            out[f"{mm}.bias"] = det_state[f"{port}.bias"]
        elif kind == "param":
            out[mm] = det_state[port]
        elif kind == "bn":
            bn(mm, det_state[f"{port}_bn_scale"], det_state[f"{port}_bn_bias"])
    layers = text_config_from_state(text_state).num_layers
    out.update(export_state_dict(text_state, text_rules(layers)))
    return {k: v.detach().contiguous() for k, v in out.items()}


def save_yolo_world_checkpoint(model, text_model, checkpoint_dir: str) -> str:
    """``torch.save`` the models as an mmyolo checkpoint (``{"state_dict":
    ...}``) in ``checkpoint_dir``; the tokenizer files are the caller's."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    sd = export_mmyolo_state_dict(model.state_dict(), text_model.state_dict(), model.cfg)
    path = os.path.join(checkpoint_dir, "yolo_world.pth")
    torch.save({"state_dict": sd}, path)
    return path


def _read_npz_params(path: str) -> Dict:
    """A flax params file of the reference's ``save_flax_params`` (keys joined
    with ``|``) -> the nested dict."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("|")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


class _Inert:
    """What a non-tensor global of a checkpoint (mmengine's message hub, a
    numpy array in its metadata) loads as: never imported, never called."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


def load_pth(path: str):
    """``torch.load`` of a ``.pth`` with ``weights_only=True``.  Globals that
    unpickler refuses (mmengine training metadata) are read as ``_Inert``
    placeholders; modules it blocks outright (``os``, ``subprocess``, ...)
    still raise ``pickle.UnpicklingError``.  The reference falls back to
    ``weights_only=False``, which runs code from the file; this never does."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        names = torch.serialization.get_unsafe_globals_in_checkpoint(path)
    with torch.serialization.safe_globals([(_Inert, name) for name in names]):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_yolo_world_checkpoint(checkpoint_dir: str, size: str = "xl", device="cuda",
                               dtype=torch.bfloat16):
    """Load a YOLO-World checkpoint directory: an mmyolo ``.pth`` plus the CLIP
    tokenizer's ``vocab.json`` / ``merges.txt`` (the ``.pth`` holds no
    tokenizer), or the native ``yolo_world.npz`` / ``text_tower.npz``.

    -> (YoloWorldDetector, YoloTextEncoder, ClipTokenizer)."""
    from tstar_tpu_torch.models.clip_tokenizer import ClipTokenizer
    from tstar_tpu_torch.models.loader import build_model
    from tstar_tpu_torch.models.owlvit import params_from_jax as text_params_from_jax
    from tstar_tpu_torch.models.yoloworld import (
        YoloTextEncoder, YoloWorldDetector, params_from_jax, text_config_from_state,
        yoloworld_small, yoloworld_xl,
    )

    cfg = yoloworld_small() if size == "small" else yoloworld_xl()
    pths = sorted(f for f in os.listdir(checkpoint_dir) if f.endswith(".pth"))
    if pths:
        path = os.path.join(checkpoint_dir, pths[0])
        ckpt = load_pth(path)
        raw_sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
        det, text = convert_mmyolo_yolo_world_state_dict(raw_sd, cfg)
        text_cfg = text_config_from_state(text)
        validate_converted_shapes(cfg, text_cfg, det, text)
    else:
        det = params_from_jax(_read_npz_params(os.path.join(checkpoint_dir, "yolo_world.npz")))
        text = text_params_from_jax(_read_npz_params(os.path.join(checkpoint_dir, "text_tower.npz")))
        text_cfg = text_config_from_state(text)
    model = build_model(YoloWorldDetector, cfg, det, device, torch.float32).cast(dtype)
    text_model = build_model(lambda c: YoloTextEncoder(c, cfg.text_dim), text_cfg, text, device, dtype)
    tokenizer = ClipTokenizer.from_dir(checkpoint_dir, context=text_cfg.max_length)
    return model, text_model, tokenizer
