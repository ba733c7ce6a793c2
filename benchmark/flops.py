"""The yardstick's operation and byte counts, from shapes alone, and the
card's published peaks.

Every product counts its multiply-adds twice.  A ViT layer: the q|k|v,
output and MLP projections, and attention's two products over all S x S
positions (the encoders attend without a mask).  The counts follow the
arithmetic of the program's ``chip_smoke.bound_ms`` / ``vlm_work`` and the
JAX benchmark's per-forward figure ("17 forwards ~1.87 TFLOP", about 0.11
TFLOP a 768^2 OWL-ViT B/32 forward), frozen here.
"""

from __future__ import annotations

from typing import Mapping

# NVIDIA H100 SXM data sheet, dense rates (the card at its full 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def encoder_flops(tokens: int, width: int, mlp: int, layers: int, seq: int) -> float:
    """A pre-norm transformer encoder over ``tokens`` rows in sequences of
    ``seq``: projections plus full attention."""
    proj = 2 * tokens * (4 * width * width + 2 * width * mlp)
    attn = 4 * tokens * seq * width
    return float(layers * (proj + attn))


def owlvit_image_flops(vision: Mapping, projection_dim: int, queries: int,
                       image_size: int) -> float:
    """One OWL-ViT image forward at ``image_size``: patch embedding, the
    vision tower, the box head (three denses) and the class head (its
    projection, logit shift / scale and the query products)."""
    d, mlp, p = vision["hidden_size"], vision["intermediate_size"], vision["patch_size"]
    patches = (image_size // p) ** 2
    seq = patches + 1
    embed = 2 * patches * (p * p * 3) * d
    tower = encoder_flops(seq, d, mlp, vision["num_hidden_layers"], seq)
    box = 2 * patches * (2 * d * d + 4 * d)
    cls = 2 * patches * (d * projection_dim + 2 * d + projection_dim * queries)
    return float(embed + tower + box + cls)


def owlvit_text_flops(text: Mapping, projection_dim: int, queries: int) -> float:
    """Encoding one search's ``queries`` prompts at the text tower's
    context length, and their projection."""
    seq = text["max_position_embeddings"]
    w, mlp = text["hidden_size"], text["intermediate_size"]
    tower = encoder_flops(queries * seq, w, mlp, text["num_hidden_layers"], seq)
    return float(tower + 2 * queries * w * projection_dim)


def attention_launch_bound_s(batch: int, seq: int, heads: int, head_dim: int,
                             itemsize: int = 2):
    """The least time one fused attention launch (K1) could take over a
    (batch, seq, 3 x heads x head_dim) q|k|v buffer: its bytes (q|k|v read
    once, the output written once) over HBM's rate, or its operations (the
    two products) over the bf16 peak, whichever is larger.
    -> (seconds, "bytes" | "operations")."""
    width = heads * head_dim
    n_bytes = 4 * batch * seq * width * itemsize
    n_ops = 4 * batch * heads * seq * seq * head_dim
    t_bytes, t_ops = n_bytes / PEAK_HBM_BYTES_PER_S, n_ops / PEAK_BF16_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def llava_request_flops(cfg: Mapping, frames: int, prompt: int, new: int) -> float:
    """One LLaVA-OneVision request: SigLIP over ``frames`` frames, the
    projector, the prefill of a ``prompt``-token prompt (causal attention on
    its lower triangle, the output head at its last position) and the
    ``new - 1`` decode steps its further tokens need (each over the cache so
    far, and the output head)."""
    v, t = cfg["vision_config"], cfg["text_config"]
    patches = (v["image_size"] // v["patch_size"]) ** 2
    rows = frames * patches
    d, i = v["hidden_size"], v["intermediate_size"]
    siglip = 2 * rows * (v["patch_size"] ** 2 * 3) * d + v["num_hidden_layers"] * (
        2 * rows * (4 * d * d + 2 * d * i) + 4 * frames * patches * patches * d)
    h = t["hidden_size"]
    kv = t["num_key_value_heads"] * (h // t["num_attention_heads"])
    per_token = 2 * (2 * h * h + 2 * h * kv + 3 * h * t["intermediate_size"])
    layers, head = t["num_hidden_layers"], 2 * h * t["vocab_size"]
    proj = 2 * rows * (d * h + h * h)
    prefill = layers * (prompt * per_token + 2 * prompt * (prompt + 1) * h) + head
    decode = sum(layers * (per_token + 4 * (prompt + j + 1) * h) + head for j in range(new - 1))
    return float(siglip + proj + prefill + decode)


def llava_decode_bound_s(cfg: Mapping, lm_params: int, prompt: int, new: int,
                         itemsize: int = 2) -> float:
    """The least time the ``new - 1`` decode steps of a request could take:
    each reads the language model's weights once (``lm_params`` without the
    embedding table, and one row of it) and the cache so far, at HBM's
    rate."""
    t = cfg["text_config"]
    h = t["hidden_size"]
    kv = t["num_key_value_heads"] * (h // t["num_attention_heads"])
    per_step = (lm_params + h) * itemsize
    cache = sum(t["num_hidden_layers"] * 2 * (prompt + j + 1) * kv * itemsize
                for j in range(new - 1))
    return ((new - 1) * per_step + cache) / PEAK_HBM_BYTES_PER_S
