"""Kimi-VL-A3B's operations and bytes, from the configuration's shapes alone
(``benchmark/configs/kimi-vl-a3b-instruct.json``: the language model's keys
at the top level, MoonViT's under ``vision_config``).

Every product counts its multiply-adds twice.  A token of the language
model does, in each layer, the latent attention's four projections (q, the
kv down-projection, the kv up-projection, the output) and, in layer 0, the
dense SwiGLU MLP, in layers 1-26 the router and the chosen 6 experts plus
the 2 shared ones; the prefill makes k / v per head from the latent
(expanded form) and attends over the causal prefix, a decode step takes
the absorbed form (q_nope through W_UK, the scores over the 576 latent
values a slot, P . c_kv, W_UV) over the cache so far.  The head runs at
the prefill's last position and at every step.  MoonViT: the patch
embedding, 27 layers over each frame's patches (projections and full
attention within the frame), the projector over the merged tokens.

The decode's byte bound: each step reads the weights a token touches once
(every layer's attention, the dense MLP, the routers, the chosen and the
shared experts, the final norm, the head and one row of the embedding) and
the latent cache so far, at HBM's rate.  The MoE decode kernel's: each
launch pair reads the chosen experts' and the shared experts' gate, up and
down rows once, and the token's hidden state and output.
"""

from __future__ import annotations

from typing import Mapping

from benchmark.flops import PEAK_HBM_BYTES_PER_S


def _dims(cfg: Mapping):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                        cfg["kv_lora_rank"])
    return d, h, nope, rope, v, r


def attention_weights(cfg: Mapping) -> int:
    """One layer's latent attention: q, kv down (with its norm), kv up, out."""
    d, h, nope, rope, v, r = _dims(cfg)
    return d * h * (nope + rope) + d * (r + rope) + r + r * h * (nope + v) + h * v * d + 2 * d


def expert_weights(cfg: Mapping) -> int:
    """One routed expert's gate, up and down."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def active_weights(cfg: Mapping) -> int:
    """The language model's weights one decode token reads: every layer's
    attention, the dense MLP, each MoE layer's router and bias, its chosen
    and its shared experts, the final norm, the head and one embedding row."""
    d = cfg["hidden_size"]
    dense = cfg["first_k_dense_replace"]
    moe = cfg["num_hidden_layers"] - dense
    experts = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    per_moe = d * cfg["n_routed_experts"] + cfg["n_routed_experts"] + experts * expert_weights(cfg)
    return (cfg["num_hidden_layers"] * attention_weights(cfg) + dense * 3 * d * cfg["intermediate_size"]
            + moe * per_moe + d + d * cfg["vocab_size"] + d)


def token_flops(cfg: Mapping) -> float:
    """A token's projections, MLPs and experts over every layer (no
    attention products, no head)."""
    d, h, nope, rope, v, r = _dims(cfg)
    attn = 2 * (d * h * (nope + rope) + d * (r + rope) + h * v * d)
    dense = cfg["first_k_dense_replace"]
    moe = cfg["num_hidden_layers"] - dense
    experts = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    mlp = dense * 2 * 3 * d * cfg["intermediate_size"] + moe * 2 * (
        d * cfg["n_routed_experts"] + experts * expert_weights(cfg))
    return float(cfg["num_hidden_layers"] * attn + mlp)


def moonvit_flops(v: Mapping, frames: int, grid_h: int, grid_w: int, text_hidden: int) -> float:
    """MoonViT over ``frames`` frames of a (grid_h, grid_w) patch grid, the
    merge and the projector."""
    d, i, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    mh, mw = v["merge_kernel_size"]
    patches = grid_h * grid_w
    rows = frames * patches
    tower = 2 * rows * p * p * 3 * d + v["num_hidden_layers"] * (
        2 * rows * (4 * d * d + 2 * d * i) + 4 * frames * patches * patches * d)
    tokens = rows // (mh * mw)
    wide = d * mh * mw
    return float(tower + 2 * tokens * (wide * wide + wide * text_hidden))


def request_flops(cfg: Mapping, frames: int, grid_h: int, grid_w: int, prompt: int,
                  new: int) -> float:
    """One request: MoonViT, the prefill of ``prompt`` tokens (the kv
    up-projection of each, causal attention on the lower triangle, the head
    at the last position) and the ``new - 1`` decode steps (absorbed
    attention over the cache so far, the head)."""
    d, h, nope, rope, v, r = _dims(cfg)
    layers = cfg["num_hidden_layers"]
    head = 2 * d * cfg["vocab_size"]
    vision = moonvit_flops(cfg["vision_config"], frames, grid_h, grid_w, d) if frames else 0.0
    per_token = token_flops(cfg)
    prefill = prompt * (per_token + layers * 2 * r * h * (nope + v)) + head + layers * (
        prompt * (prompt + 1) * h * (nope + rope + v))
    absorb = 2 * h * (nope * r + r * v)
    decode = sum(per_token + layers * (absorb + 2 * h * (prompt + j + 1) * (r + rope + r)) + head
                 for j in range(new - 1))
    return float(vision + prefill + decode)


def decode_bound_s(cfg: Mapping, prompt: int, new: int, itemsize: int = 2) -> float:
    """The least time the ``new - 1`` decode steps of a request could take:
    each reads the active weights once and the latent cache so far."""
    width = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    per_step = active_weights(cfg) * itemsize
    cache = sum(cfg["num_hidden_layers"] * (prompt + j + 1) * width * itemsize
                for j in range(new - 1))
    return ((new - 1) * per_step + cache) / PEAK_HBM_BYTES_PER_S


def moe_decode_bytes(cfg: Mapping, tokens: int = 1, itemsize: int = 2) -> int:
    """One MoE decode launch pair's bytes for ``tokens`` tokens whose
    choices share no expert: the chosen and shared experts' rows, the
    tokens' hidden states, ids, weights and outputs."""
    k = cfg["num_experts_per_tok"]
    experts = min(tokens * k, cfg["n_routed_experts"]) + cfg["n_shared_experts"]
    d = cfg["hidden_size"]
    return experts * expert_weights(cfg) * itemsize + tokens * (2 * d * itemsize + k * 12)
