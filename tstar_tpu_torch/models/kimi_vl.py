"""Kimi-VL-A3B (Kimi-VL technical report, arXiv 2504.07491; the published
``config.json`` and ``modeling_kimi_vl.py`` of moonshotai/Kimi-VL-A3B-Instruct):
MoonViT (``models/moonvit.py``) and a DeepSeek-V3-layout language model, on
the surface ``models/generate.py`` runs (``encode_images``, ``embed``,
``decoder``, ``logits``, ``init_cache``, ``step_positions``).  No JAX
counterpart: the reference package has no Kimi-VL.

The language model, as published:

  * latent attention (MLA) with no q compression: q = W_q h, per head a
    128-wide part without position and a 64-wide roped part;
    [c_kv, k_pe] = W_kva h, c_kv RMSNorm-ed (512 wide, eps 1e-6, the
    published module's default) and k_pe roped once for all heads;
    [k_nope, v] = W_kvb c_kv per head; scores over sqrt(192), causal.  The
    rope follows DeepSeek's published layout: the 64 values' interleaved
    pairs are first gathered as [evens, odds], then turned as rotate-half
    halves (theta 800,000), in f32 and rounded back (the published code
    turns them in the model's dtype);
  * layer 0 a SwiGLU MLP of width 11,264; layers 1-26 a mixture of 64
    experts of width 1,408, 6 a token, chosen by sigmoid score plus a
    correction bias, weighted by their scores over their sum times 2.446,
    plus 2 shared experts as one MLP of width 2,816 (``kernels/moe.py``);
  * RMSNorm (eps 1e-5), an untied output head; the 1-D text positions run
    on across the image tokens.

Two routes of the attention, both from the same projections:

  * the expanded form (prefill, any S): k_nope and v made per head from the
    latent c_kv of every slot so far, logits in the working dtype, an f32
    softmax rounded back, P V, the output projection;
  * the absorbed form (one token against the latent cache,
    ``kernels/mla.py``): q_nope . W_UK taken against c_kv and q_pe against
    k_pe as one product over the cache's 576 values a slot, the softmax,
    P . c_kv, then W_UV and W_o.
    The cache holds 512 + 64 values a token and layer (1,152 bytes in bf16)
    in place of 16 heads of K and V (10,240 bytes).

The decode step of a bf16 model on the card takes the port's kernels: the
residual add and RMSNorm (``kernels/decode.add_rms_norm``, D 2,048), the
absorbed attention from the q|kv_a projection to o_proj, rope, latent norm
and cache write included (``kernels/mla.mla_decode``, Kimi-VL's widths, 1 to
4 rows), SwiGLU's ``silu_mul`` in layer 0, and the router and experts of
every MoE layer in ``kernels/moe.moe_route`` and ``moe_decode`` (1 to 4
tokens).  The step's mask stays f32, as the attention reads it.  A
prefill's experts run as ``moe_grouped``'s two grouped products over the
tokens sorted by expert, each MoE layer inside a ``moe.prefill`` span; the
tower runs inside ``vision.encode``.  Every MoE layer counts its
token-expert pairs into the model's ``expert_tokens`` (MoE layers, experts)
int32 device tensor and writes its choices into the cache's route log, also
inside a captured step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tstar_tpu_torch.kernels.decode import (add_rms_norm, add_rms_norm_plain, norm_mlp_supported,
                                            silu_mul, silu_mul_plain)
from tstar_tpu_torch.kernels.image import device_constant
from tstar_tpu_torch.kernels.mla import mla_decode, mla_decode_plain, mla_decode_supported
from tstar_tpu_torch.kernels.moe import (moe_decode, moe_decode_supported, moe_grouped, moe_route,
                                         route)
from tstar_tpu_torch.models.moonvit import MoonViT, MoonViTConfig
from tstar_tpu_torch.models.qwen2vl import Embed, RMSNorm
from tstar_tpu_torch.models.transformer import Dense
from tstar_tpu_torch.utils.profiling import trace

NEG = torch.finfo(torch.float32).min

# Kimi-VL's special tokens as the byte-level tokenizer stand-in holds them
# (``qwen_tokenizer.write_byte_vocab``); that tokenizer reads its pad id under
# ``<|endoftext|>``, here Kimi's [EOS].
KIMI_SPECIAL_TOKENS = {
    "[BOS]": 163584,
    "<|endoftext|>": 163585,
    "<|im_end|>": 163586,
    "<|im_user|>": 163587,
    "<|im_assistant|>": 163588,
    "<|im_system|>": 163594,
    "<|im_middle|>": 163601,
    "<|media_start|>": 163602,
    "<|media_content|>": 163603,
    "<|media_end|>": 163604,
    "<|media_pad|>": 163605,
}


@dataclasses.dataclass(frozen=True)
class KimiVLTextConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    kv_norm_eps: float = 1e-6
    rope_theta: float = 800000.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_width(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    vision: MoonViTConfig = dataclasses.field(default_factory=MoonViTConfig)
    text: KimiVLTextConfig = dataclasses.field(default_factory=KimiVLTextConfig)
    media_token_id: int = 163605
    in_token_limit: int = 4096      # patches a frame before it is scaled down


# ---------------------------------------------------------------------------
# The latent cache
# ---------------------------------------------------------------------------

class LatentCache:
    """Per layer (B, max_len, 576): the normed c_kv then the roped k_pe of
    each slot; ``routes`` (MoE layers, B, max_len, K) int64: each slot's
    chosen experts."""

    def __init__(self, t: KimiVLTextConfig, batch: int, max_len: int, dtype, device):
        self.layers = [torch.zeros(batch, max_len, t.latent_width, dtype=dtype, device=device)
                       for _ in range(t.num_layers)]
        self.routes = torch.zeros(t.moe_layers, batch, max_len, t.num_experts_per_tok,
                                  dtype=torch.int64, device=device)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.layers[i]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """(B, S) positions -> cos and the signed sin (B, S, 1, dim) f32 of
    rotate-half rope: ``x * cos + swap_halves(x) * sin`` turns x."""
    inv = device_constant(("kimi_inv_freq", dim, float(theta)),
                          lambda: 1.0 / (theta ** (np.arange(0, dim, 2, np.float32) / dim)),
                          positions.device)
    freqs = positions[..., None].float() * inv
    sin = torch.sin(freqs)
    return torch.cos(freqs).repeat(1, 1, 2)[:, :, None], torch.cat([-sin, sin], -1)[:, :, None]


def deepseek_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's published rope on x (..., D): the interleaved pairs
    gathered as [evens, odds], then turned as rotate-half halves; f32,
    rounded back.  ``sin`` is ``rope_cos_sin``'s signed sin."""
    xf = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1).float()
    swapped = xf.unflatten(-1, (2, -1)).flip(-2).flatten(-2)
    return torch.addcmul(xf * cos, swapped, sin).to(x.dtype)


class MLAttention(nn.Module):
    """Latent attention.  One projection holds W_q and W_kva, its columns
    ordered [q_nope of every head | c_kv | q_pe of every head | k_pe]
    (``load_weights`` assembles it from ``q_proj`` and ``kv_a_proj``), so
    that one rope turns the 16 query heads' and the key's rope parts."""

    def __init__(self, t: KimiVLTextConfig):
        super().__init__()
        self.t = t
        h = t.num_heads
        self.q_kv_a = Dense(t.hidden_size, h * t.qk_head_dim + t.latent_width, use_bias=False)
        self.kv_a_layernorm = RMSNorm(t.kv_lora_rank, t.kv_norm_eps)
        self.kv_b_proj = Dense(t.kv_lora_rank, h * (t.qk_nope_head_dim + t.v_head_dim),
                               use_bias=False)
        self.o_proj = Dense(h * t.v_head_dim, t.hidden_size, use_bias=False)
        self._absorbed = None

    def absorbed(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W_UK (H, nope, r), W_UV (H, r, v)) from ``kv_b_proj``, made
        again whenever its kernel changed in place."""
        kernel = self.kv_b_proj.kernel
        key = (kernel.data_ptr(), kernel._version)
        if self._absorbed is None or self._absorbed[0] != key:
            t = self.t
            w = kernel.detach().view(t.kv_lora_rank, t.num_heads, -1)
            w_uk = w[:, :, :t.qk_nope_head_dim].permute(1, 2, 0).contiguous()
            w_uv = w[:, :, t.qk_nope_head_dim:].permute(1, 0, 2).contiguous()
            self._absorbed = (key, w_uk, w_uv)
        return self._absorbed[1], self._absorbed[2]

    def forward(self, h: torch.Tensor, cos, sin, attn_bias, cache=None,
                cache_index=None) -> torch.Tensor:
        """h (B, S, D) normed -> (B, S, D).  With a latent ``cache`` this
        step's c_kv / k_pe are written at ``cache_index`` and attention reads
        every slot so far: one token by the absorbed form
        (``kernels/mla.mla_decode``, the kernel where it takes the step, else
        its plain version), else expanded.  ``attn_bias`` is additive, in the
        working dtype or f32."""
        t = self.t
        b, s, _ = h.shape
        nh, nope, rope_d, r = t.num_heads, t.qk_nope_head_dim, t.qk_rope_head_dim, t.kv_lora_rank
        y = self.q_kv_a(h)
        if cache is not None and s == 1:
            w_uk, w_uv = self.absorbed()
            step = mla_decode if mla_decode_supported(y, cache, w_uk, w_uv) else mla_decode_plain
            ln = self.kv_a_layernorm
            return self.o_proj(step(y, cos, sin, ln.scale, ln.eps, cache, cache_index, w_uk,
                                    w_uv, attn_bias))
        q_nope = y[..., :nh * nope].view(b, s, nh, nope)
        pe = deepseek_rope(y[..., nh * nope + r:].view(b, s, nh + 1, rope_d), cos, sin)
        q_pe, k_pe = pe[:, :, :nh], pe[:, :, nh]
        c = add_rms_norm_plain(y[..., nh * nope:nh * nope + r], None, self.kv_a_layernorm.scale,
                               self.kv_a_layernorm.eps)[1]
        if cache is not None:
            cache[:, cache_index:cache_index + s] = torch.cat([c, k_pe], dim=-1).to(cache.dtype)
            end = cache_index + s
            lat = cache[:, :end].to(h.dtype)
            c_all, kpe_all = lat[..., :r], lat[..., r:]
            bias = None if attn_bias is None else attn_bias[..., :end]
        else:
            c_all, kpe_all, bias = c, k_pe, attn_bias
        n = c_all.shape[1]
        kv = self.kv_b_proj(c_all).view(b, n, nh, nope + t.v_head_dim)
        k = torch.cat([kv[..., :nope], kpe_all[:, :, None].expand(b, n, nh, rope_d)], dim=-1)
        qf = torch.cat([q_nope, q_pe], dim=-1)
        logits = torch.matmul(qf.transpose(1, 2), k.permute(0, 2, 3, 1)) * t.qk_head_dim ** -0.5
        if bias is not None:
            logits = logits + bias.to(logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1).to(qf.dtype)
        out = torch.matmul(probs, kv[..., nope:].transpose(1, 2))                    # (B, H, S, v)
        return self.o_proj(out.transpose(1, 2).reshape(b, s, nh * t.v_head_dim))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class DenseMLP(nn.Module):
    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = Dense(d, width, use_bias=False)
        self.up_proj = Dense(d, width, use_bias=False)
        self.down_proj = Dense(width, d, use_bias=False)

    def forward(self, h: torch.Tensor, fused: bool = False, **_) -> torch.Tensor:
        gate, up = self.gate_proj(h), self.up_proj(h)
        return self.down_proj(silu_mul(gate, up) if fused else silu_mul_plain(gate, up))


class MoE(nn.Module):
    """64 routed experts (6 a token) and the shared experts (``kernels/moe.py``
    layouts: rows along the reduced dimension)."""

    def __init__(self, t: KimiVLTextConfig, index: int):
        super().__init__()
        self.t, self.index = t, index           # index among the MoE layers
        d, e, i = t.hidden_size, t.n_routed_experts, t.moe_intermediate_size
        ns = t.n_shared_experts * i
        self.gate = nn.Parameter(torch.empty(e, d))           # the router, (E, D)
        self.e_score_correction_bias = nn.Parameter(torch.zeros(e))
        self.w13 = nn.Parameter(torch.empty(e, 2 * i, d))
        self.w2 = nn.Parameter(torch.empty(e, d, i))
        self.sw13 = nn.Parameter(torch.empty(2 * ns, d))
        self.sw2 = nn.Parameter(torch.empty(d, ns))

    def forward(self, h: torch.Tensor, counts: Optional[torch.Tensor] = None, cache=None,
                cache_index=None, **_) -> torch.Tensor:
        t = self.t
        b, s, d = h.shape
        x = h.reshape(b * s, d)
        if not t.norm_topk_prob:
            raise NotImplementedError("only the published norm_topk_prob=True is implemented")
        step = s == 1 and torch.is_tensor(cache_index) and moe_decode_supported(
            x, t.num_experts_per_tok, t.moe_intermediate_size)
        router = moe_route if step else route
        ids, weights = router(x, self.gate, self.e_score_correction_bias, t.num_experts_per_tok,
                              t.routed_scaling_factor)
        log = None if cache is None else cache.routes[self.index]
        experts = (self.w13, self.w2, self.sw13, self.sw2)
        if step:
            out = moe_decode(x, ids, weights, *experts, counts, log, cache_index)
        else:
            with trace("moe.prefill", device=x.device):
                out = moe_grouped(x, ids, weights, *experts, counts)
            if log is not None:
                slots = cache_index + torch.arange(s, device=x.device)
                log.index_copy_(1, slots, ids.view(b, s, -1))
        return out.view(b, s, d)


class KimiDecoderLayer(nn.Module):
    def __init__(self, t: KimiVLTextConfig, i: int):
        super().__init__()
        self.index = i
        self.input_layernorm = RMSNorm(t.hidden_size, t.rms_norm_eps)
        self.self_attn = MLAttention(t)
        self.post_attention_layernorm = RMSNorm(t.hidden_size, t.rms_norm_eps)
        self.mlp = (DenseMLP(t.hidden_size, t.intermediate_size) if i < t.first_k_dense_replace
                    else MoE(t, i - t.first_k_dense_replace))

    def step(self, x, delta, cos, sin, attn_bias, caches, cache_index, counts,
             fused: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layer on ``x + delta``, its output left as (residual, delta)
        for the next norm to add."""
        norm = add_rms_norm if fused else add_rms_norm_plain
        ln = self.input_layernorm
        x, h = norm(x, delta, ln.scale, ln.eps)
        attn = self.self_attn(h, cos, sin, attn_bias,
                              None if caches is None else caches[self.index], cache_index)
        post = self.post_attention_layernorm
        x, h = norm(x, attn, post.scale, post.eps)
        return x, self.mlp(h, fused=fused, counts=counts, cache=caches, cache_index=cache_index)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class KimiVLModel(nn.Module):
    batched_requests = False        # the backend serves its requests one at a time

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        self.vision_tower = MoonViT(dataclasses.replace(cfg.vision,
                                                        text_hidden_size=t.hidden_size))
        self.embed_tokens = Embed(t.vocab_size, t.hidden_size)
        self.layers = nn.ModuleList(KimiDecoderLayer(t, i) for i in range(t.num_layers))
        self.norm = RMSNorm(t.hidden_size, t.rms_norm_eps)
        self.lm_head = Dense(t.hidden_size, t.vocab_size, use_bias=False)
        self.register_buffer("expert_tokens", torch.zeros(t.moe_layers, t.n_routed_experts,
                                                          dtype=torch.int32), persistent=False)
        self.last_cache: Optional[LatentCache] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.embedding.dtype

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.embedding.device

    # -- generate's surface ---------------------------------------------------
    def encode_images(self, pixels: torch.Tensor, grid_hw=None) -> torch.Tensor:
        """(F, H, W, 3) normalised frames -> (F, tokens, hidden)."""
        del grid_hw
        with trace("vision.encode", device=pixels.device):
            return self.vision_tower(pixels)

    def embed(self, input_ids: torch.Tensor, image_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """Token embeddings, the k-th media placeholder (in (B, S) order)
        taking the k-th row of ``image_embeds``."""
        x = self.embed_tokens(input_ids)
        if image_embeds is None:
            return x
        flat_mask = (input_ids == self.cfg.media_token_id).reshape(-1)
        order = torch.cumsum(flat_mask.to(torch.int64), 0) - 1
        gathered = image_embeds[order.clamp(0, image_embeds.shape[0] - 1)]
        flat = torch.where(flat_mask[:, None], gathered.to(x.dtype), x.reshape(-1, x.shape[-1]))
        return flat.reshape(x.shape)

    def init_cache(self, batch: int, max_len: int, dtype, device) -> LatentCache:
        return LatentCache(self.cfg.text, batch, max_len, dtype, device)

    @staticmethod
    def step_positions(next_pos: torch.Tensor) -> torch.Tensor:
        """A decode step's positions (B, 1) from each sequence's next one."""
        return next_pos[:, None]

    def decoder(self, hidden, position_ids, attn_bias, caches=None, cache_index=None):
        """-> (the final norm's output, caches)."""
        t = self.cfg.text
        cos, sin = rope_cos_sin(position_ids, t.qk_rope_head_dim, t.rope_theta)
        fused = caches is not None and norm_mlp_supported(hidden, t.intermediate_size)
        if caches is not None:
            self.last_cache = caches
        delta = None
        for i, layer in enumerate(self.layers):
            counts = None if i < t.first_k_dense_replace else \
                self.expert_tokens[i - t.first_k_dense_replace]
            hidden, delta = layer.step(hidden, delta, cos, sin, attn_bias, caches, cache_index,
                                       counts, fused)
        norm = add_rms_norm if fused else add_rms_norm_plain
        return norm(hidden, delta, self.norm.scale, self.norm.eps)[1], caches

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.lm_head(hidden).float()

    def forward(self, input_ids, positions, pixels=None) -> torch.Tensor:
        """Full causal forward with no cache -> logits (B, S, vocab) f32."""
        embeds = None
        if pixels is not None:
            enc = self.encode_images(pixels)
            embeds = enc.reshape(-1, enc.shape[-1])
        s = input_ids.shape[1]
        causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=input_ids.device))
        bias = torch.where(causal, 0.0, NEG)[None, None]
        hidden, _ = self.decoder(self.embed(input_ids, embeds), positions, bias)
        return self.logits(hidden)

    def prepare_inputs(self, tokenizer, query: str, frames, max_pixels: int = 0) -> Dict:
        del max_pixels
        return prepare_kimi_inputs(tokenizer, query, frames, self.cfg)


# ---------------------------------------------------------------------------
# Input preparation (processor + chat template)
# ---------------------------------------------------------------------------

def frame_size(h: int, w: int, cfg: KimiVLConfig) -> Tuple[float, int, int]:
    """(scale, padded H, padded W) of an h x w frame: native resolution,
    scaled down (aspect kept) only past ``in_token_limit`` patches, then
    padded below and to the right to whole merge cells."""
    p, (mh, mw) = cfg.vision.patch_size, cfg.vision.merge_kernel
    scale = 1.0
    if (h // p) * (w // p) > cfg.in_token_limit:
        scale = math.sqrt(cfg.in_token_limit / ((h // p) * (w // p)))
    sh, sw = max(1, int(h * scale)), max(1, int(w * scale))
    return scale, -(-sh // (p * mh)) * p * mh, -(-sw // (p * mw)) * p * mw


def preprocess_frames_kimi(frames: Sequence[np.ndarray], cfg: KimiVLConfig) -> np.ndarray:
    """Frames (h x w x 3 uint8, one size) -> (F, H, W, 3) f32 in [-1, 1]:
    scaled as ``frame_size`` says (``resize_cubic``), zero pixels padded
    below and right, then (x / 255 - 0.5) / 0.5."""
    from tstar_tpu_torch.models.qwen2vl_processor import resize_cubic

    h, w = np.asarray(frames[0]).shape[:2]
    scale, ph, pw = frame_size(h, w, cfg)
    out = np.zeros((len(frames), ph, pw, 3), np.float32)
    for i, f in enumerate(frames):
        f = np.asarray(f)
        if f.shape[:2] != (h, w):
            raise ValueError("the frames of one request must share one size")
        if scale != 1.0:
            f = resize_cubic(f, (max(1, int(h * scale)), max(1, int(w * scale))))
        out[i, :f.shape[0], :f.shape[1]] = f
    return (out / 255.0 - 0.5) / 0.5


def tokens_per_frame(h: int, w: int, cfg: KimiVLConfig) -> int:
    _, ph, pw = frame_size(h, w, cfg)
    p, (mh, mw) = cfg.vision.patch_size, cfg.vision.merge_kernel
    return (ph // (p * mh)) * (pw // (p * mw))


def prepare_kimi_inputs(tokenizer, query: str, frames, cfg: KimiVLConfig) -> Dict:
    """-> ``generate`` inputs (host numpy): Kimi-VL's chat template, each
    frame a media block (``<|media_start|>image<|media_content|>``, its
    placeholders, ``<|media_end|>``) where the query's k-th ``<image>`` tag
    stands (blocks beyond the tags first in the turn), 1-D positions."""
    frames = [np.asarray(f) for f in (frames or [])]
    n = tokens_per_frame(*frames[0].shape[:2], cfg) if frames else 0
    block = "<|media_start|>image<|media_content|><MEDIA><|media_end|>"
    parts = query.split("<image>")
    tags = len(parts) - 1
    extra = max(0, len(frames) - tags)
    text = block * extra + parts[0]
    for i, part in enumerate(parts[1:]):
        text += (block if extra + i < len(frames) else "") + part
    chat = ("<|im_system|>system<|im_middle|>You are a helpful assistant<|im_end|>"
            "<|im_user|>user<|im_middle|>" + text.strip() + "<|im_end|>"
            "<|im_assistant|>assistant<|im_middle|>")
    ids: List[int] = []
    for i, piece in enumerate(chat.split("<MEDIA>")):
        if i:
            ids.extend([cfg.media_token_id] * n)
        ids.extend(tokenizer.encode(piece))
    ids_np = np.asarray(ids, np.int32)[None]
    return {
        "input_ids": ids_np,
        "prompt_lens": np.asarray([ids_np.shape[1]], np.int32),
        "position_ids": np.arange(ids_np.shape[1], dtype=np.int32)[None],
        "image_patches": preprocess_frames_kimi(frames, cfg) if frames else None,
        "image_grid_hw": None,
    }


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _expert_names(prefix: str) -> List[str]:
    return [f"{prefix}.{p}.kernel" for p in ("gate_proj", "up_proj", "down_proj")]


def flat_weight_shapes(cfg: KimiVLConfig) -> List[Tuple[str, Tuple[int, ...]]]:
    """The model's weights as a checkpoint holds them: W_q and W_kva apart
    (``q_proj``, ``kv_a_proj``), the router and each expert's gate / up /
    down as kernels of their own, (in, out) as every ``Dense``; every other
    weight under its state-dict name and shape."""
    t = cfg.text
    d, i, ns = t.hidden_size, t.moe_intermediate_size, t.n_shared_experts * t.moe_intermediate_size
    h, r = t.num_heads, t.kv_lora_rank
    with torch.device("meta"):
        model = KimiVLModel(cfg)
    out = []
    for name, p in model.state_dict().items():
        layer, _, leaf = name.rpartition(".")
        if layer.endswith(".q_kv_a"):
            attn = layer.rpartition(".")[0]
            out += [(f"{attn}.q_proj.kernel", (d, h * t.qk_head_dim)),
                    (f"{attn}.kv_a_proj.kernel", (d, t.latent_width))]
        elif leaf == "gate":
            out.append((f"{layer}.router.kernel", (d, t.n_routed_experts)))
        elif leaf == "w13":
            for e in range(t.n_routed_experts):
                g, u, dn = _expert_names(f"{layer}.experts.{e}")
                out += [(g, (d, i)), (u, (d, i)), (dn, (i, d))]
        elif leaf == "sw13":
            g, u, dn = _expert_names(f"{layer}.shared_experts")
            out += [(g, (d, ns)), (u, (d, ns)), (dn, (ns, d))]
        elif leaf not in ("w2", "sw2"):
            out.append((name, tuple(p.shape)))
    return out


def load_weights(model: KimiVLModel, get: Callable[[str], torch.Tensor]) -> KimiVLModel:
    """Copy the weights ``get(name)`` gives under ``flat_weight_shapes``'
    names into ``model``: W_q and W_kva into the one projection's column
    order, the router and the experts transposed into ``kernels/moe.py``'s
    layouts, the experts stacked."""
    t = model.cfg.text
    hn = t.num_heads * t.qk_nope_head_dim
    with torch.no_grad():
        for name, p in model.state_dict().items():
            layer, _, leaf = name.rpartition(".")
            if layer.endswith(".q_kv_a"):
                attn = layer.rpartition(".")[0]
                q = get(f"{attn}.q_proj.kernel").view(p.shape[0], t.num_heads, t.qk_head_dim)
                kv_a = get(f"{attn}.kv_a_proj.kernel")
                p[:, :hn].view(-1, t.num_heads, t.qk_nope_head_dim).copy_(
                    q[..., :t.qk_nope_head_dim])
                p[:, hn:hn + t.kv_lora_rank].copy_(kv_a[:, :t.kv_lora_rank])
                p[:, hn + t.kv_lora_rank:-t.qk_rope_head_dim].view(
                    -1, t.num_heads, t.qk_rope_head_dim).copy_(q[..., t.qk_nope_head_dim:])
                p[:, -t.qk_rope_head_dim:].copy_(kv_a[:, t.kv_lora_rank:])
            elif leaf == "gate":
                p.copy_(get(f"{layer}.router.kernel").t())
            elif leaf == "w13":
                for e in range(t.n_routed_experts):
                    g, u, _ = _expert_names(f"{layer}.experts.{e}")
                    p[e].copy_(torch.cat([get(g).t(), get(u).t()]))
            elif leaf == "w2":
                for e in range(t.n_routed_experts):
                    p[e].copy_(get(_expert_names(f"{layer}.experts.{e}")[2]).t())
            elif leaf == "sw13":
                g, u, _ = _expert_names(f"{layer}.shared_experts")
                p.copy_(torch.cat([get(g).t(), get(u).t()]))
            elif leaf == "sw2":
                p.copy_(get(_expert_names(f"{layer}.shared_experts")[2]).t())
            else:
                p.copy_(get(name))
    return model


def seeded_flat_weights(cfg: KimiVLConfig, seed: int, dtype=torch.float32,
                        device="cpu") -> Dict[str, torch.Tensor]:
    """Random weights under ``flat_weight_shapes``' names, for tests: kernels
    N(0, 1/fan_in), embeddings and biases N(0, 0.02^2), norm scales
    1 + 0.1 N(0, 1), so that every term shows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: seeded_weight(name, shape, gen, dtype)
            for name, shape in flat_weight_shapes(cfg)}


def seeded_weight(name: str, shape: Tuple[int, ...], gen: torch.Generator,
                  dtype=torch.float32) -> torch.Tensor:
    """One of ``seeded_flat_weights``' tensors, drawn from ``gen`` on its
    device (a caller that draws the weights one at a time, as ``load_weights``
    asks for them, never holds more than one in float32)."""
    leaf = name.rsplit(".", 1)[-1]
    x = torch.randn(shape, generator=gen, device=gen.device)
    if leaf == "scale":
        x = 1.0 + 0.1 * x
    elif leaf == "kernel":
        x = x / math.sqrt(math.prod(shape[:-1]))
    else:
        x = 0.02 * x
    return x.to(dtype)


def kimi_model_from(cfg: KimiVLConfig, weights: Mapping[str, torch.Tensor], dtype,
                    device) -> KimiVLModel:
    """A model made on the meta device, given memory on ``device`` in
    ``dtype`` and ``weights`` (``flat_weight_shapes``' names)."""
    with torch.device("meta"):
        model = KimiVLModel(cfg)
    model = model.to(dtype).to_empty(device=device)
    model.expert_tokens.zero_()
    load_weights(model, lambda name: weights[name])
    return model.requires_grad_(False).eval()
