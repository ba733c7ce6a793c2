"""Kimi-VL (``models/kimi_vl.py``, ``models/moonvit.py``, ``kernels/moe.py``)
on the CPU at a tiny size, against the plain float32 reference
(``tests/kimi_vl_reference.py``) on seeded weights:

  * the prefill, then 8 decode steps through the latent cache
    (``generate.prefill`` / ``decode_step``), give the reference's
    full-forward logits over the prompt and the chosen tokens, frames
    through MoonViT included, and record the reference's own expert choice;
  * the MoE block equals a dense loop over every expert (router, correction
    bias, normalisation, 2.446, shared experts), on its grouped (prefill) and
    its decode route, with its counts and route log;
  * the absorbed one-token attention over the latent cache equals the
    expanded attention over the same slots, and its plain version
    (``kernels/mla.mla_decode_plain``) the branch it replaced, cache slot
    included (bit for bit in bf16); the latent norm sums in the kernel's
    order;
  * MoonViT's 2D rotary positions at a known (row, column), and a frame's
    output does not move when another frame's pixels change;
  * the backend serves Kimi-VL through ``TorchVLMBackend``, one request at
    a time.

Tolerances are in float32, where the routes part only by sum order and the
absorbed form's association: 1e-4 of the logits' scale (about 100 f32 ulps
over products of 8 to 96 terms and 27 steps of softmax); the dense-loop
checks 1e-5.  The kernel itself is held to ``moe_grouped`` on the card
(``tests/test_torch_cuda_kimi_vl.py``).
"""

import tempfile

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from tests import kimi_vl_reference as ref
from tstar_tpu_torch.kernels import mla as tmla
from tstar_tpu_torch.kernels import moe as tmoe
from tstar_tpu_torch.kernels.decode import add_rms_norm_plain
from tstar_tpu_torch.models import generate as tgen
from tstar_tpu_torch.models import kimi_vl
from tstar_tpu_torch.models.moonvit import MoonViTConfig, apply_rope_2d, rope_2d_angles

MEDIA = 319
TEXT = kimi_vl.KimiVLTextConfig(
    vocab_size=320, hidden_size=64, intermediate_size=96, moe_intermediate_size=16, num_layers=3,
    num_heads=2, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
    n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=3, first_k_dense_replace=1,
    rope_theta=10000.0)
VISION = MoonViTConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=48,
                       patch_size=2, pos_emb_height=4, pos_emb_width=4)
CFG = kimi_vl.KimiVLConfig(vision=VISION, text=TEXT, media_token_id=MEDIA)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_cfg(cfg: kimi_vl.KimiVLConfig) -> dict:
    """The configuration under the published keys, as the reference reads it."""
    t, v = cfg.text, cfg.vision
    return {
        "hidden_size": t.hidden_size, "num_attention_heads": t.num_heads,
        "num_hidden_layers": t.num_layers, "qk_nope_head_dim": t.qk_nope_head_dim,
        "qk_rope_head_dim": t.qk_rope_head_dim, "v_head_dim": t.v_head_dim,
        "kv_lora_rank": t.kv_lora_rank, "rms_norm_eps": t.rms_norm_eps,
        "rope_theta": t.rope_theta, "first_k_dense_replace": t.first_k_dense_replace,
        "num_experts_per_tok": t.num_experts_per_tok,
        "routed_scaling_factor": t.routed_scaling_factor, "norm_topk_prob": t.norm_topk_prob,
        "media_placeholder_token_id": cfg.media_token_id,
        "vision_config": {"patch_size": v.patch_size, "hidden_size": v.hidden_size,
                          "num_attention_heads": v.num_heads, "layer_norm_eps": v.eps,
                          "merge_kernel_size": list(v.merge_kernel), "rope_theta": v.rope_theta,
                          "num_hidden_layers": v.num_layers},
    }


@pytest.fixture(scope="module")
def tiny():
    weights = kimi_vl.seeded_flat_weights(CFG, 0)
    return kimi_vl.kimi_model_from(CFG, weights, torch.float32, "cpu"), weights


def pixels(n, seed=0, hw=(8, 12)):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-1, 1, (n, *hw, 3)).astype(np.float32))


def close(a, b, rel):
    scale = b.abs().max().item()
    assert (a - b).abs().max().item() <= rel * scale, ((a - b).abs().max().item(), scale)


def test_prefill_then_decode_matches_the_reference_full_forward(tiny):
    model, weights = tiny
    frames = pixels(2)
    n_media = 2 * 6
    rng = np.random.default_rng(1)
    ids = np.concatenate([rng.integers(1, 300, 5), np.full(n_media, MEDIA), rng.integers(1, 300, 7)])
    s = len(ids)
    input_ids = torch.as_tensor(ids)[None]
    lens = torch.tensor([s])
    pos = torch.arange(s)[None]
    max_len = tgen.bucket_len(s + 9)
    steps = 8
    with torch.no_grad():
        logits, caches = tgen.prefill(model, input_ids, lens, pos, frames, None, max_len)
        out, tokens = [logits[0]], []
        valid = torch.arange(max_len)[None] < s
        for t in range(steps):
            token = out[-1].argmax()[None]
            tokens.append(int(token))
            valid[0, s + t] = True
            out.append(tgen.decode_step(model, token, torch.tensor(s + t), torch.tensor([s + t]),
                                        valid, caches)[0])
    got = torch.stack(out)                                   # positions s-1 .. s+7
    seq = torch.as_tensor(np.concatenate([ids, tokens]))
    want, used, gap = ref.forward(seq, frames, weights, ref_cfg(CFG))
    close(got, want[s - 1:], 1e-4)
    # the program recorded the reference's own choice, prompt and steps
    routes = caches.routes[:, 0, :s + steps].sort(dim=-1).values
    assert torch.equal(routes, used.sort(dim=-1).values)
    _, _, gap = ref.forward(seq, frames, weights, ref_cfg(CFG), follow=caches.routes[:, 0, :s + steps])
    assert gap == 0.0
    # every MoE layer counted each token's 3 experts, prefill and steps
    assert model.expert_tokens.sum(dim=1).tolist() == [3 * (s + steps)] * 2


def test_moonvit_matches_the_reference(tiny):
    model, weights = tiny
    frames = pixels(3, seed=4, hw=(8, 8))         # the table's own 4 x 4 grid: no resampling
    with torch.no_grad(), ref.no_tf32():
        for f in (frames, pixels(2, seed=5)):
            got = model.encode_images(f).reshape(-1, TEXT.hidden_size)
            close(got, ref.moonvit(f, weights, ref_cfg(CFG)["vision_config"]), 1e-5)


def dense_moe_loop(x, mlp):
    """Every expert on every token, then the chosen ones kept: the block as
    the published equations write it."""
    t = mlp.t
    scores = torch.sigmoid(x @ mlp.gate.t())
    chosen = torch.topk(scores + mlp.e_score_correction_bias, t.num_experts_per_tok).indices
    w = torch.zeros_like(scores).scatter(1, chosen, scores.gather(1, chosen))
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * t.routed_scaling_factor
    i = t.moe_intermediate_size
    out = torch.zeros_like(x)
    for e in range(t.n_routed_experts):
        gate, up = (x @ mlp.w13[e].t()).split(i, dim=-1)
        out += w[:, e:e + 1] * ((F.silu(gate) * up) @ mlp.w2[e].t())
    gate, up = (x @ mlp.sw13.t()).chunk(2, dim=-1)
    return out + (F.silu(gate) * up) @ mlp.sw2.t(), chosen


@pytest.mark.parametrize("tokens", [1, 3, 11])
def test_moe_block_matches_a_dense_loop_over_every_expert(tiny, tokens):
    """Prefill's grouped route (11 tokens) and the decode route's plain
    version (1 and 3 tokens), with the counts and the route log."""
    model, _ = tiny
    mlp = model.layers[1].mlp
    x = torch.randn(tokens, TEXT.hidden_size, generator=torch.Generator().manual_seed(tokens))
    want, chosen = dense_moe_loop(x, mlp)
    counts = torch.zeros(TEXT.n_routed_experts, dtype=torch.int32)
    ids, weights = tmoe.route(x, mlp.gate, mlp.e_score_correction_bias,
                              TEXT.num_experts_per_tok, TEXT.routed_scaling_factor)
    experts = (mlp.w13, mlp.w2, mlp.sw13, mlp.sw2)
    if tokens <= tmoe.MAX_TOKENS:
        log = torch.zeros(tokens, 6, TEXT.num_experts_per_tok, dtype=torch.int64)
        got = tmoe.moe_decode(x, ids, weights, *experts, counts, log, torch.tensor(4))
        assert torch.equal(log[:, 4], ids) and not log[:, :4].any()
    else:
        got = tmoe.moe_grouped(x, ids, weights, *experts, counts)
    assert torch.equal(ids.sort(-1).values, chosen.sort(-1).values)
    close(got, want, 1e-5)
    assert torch.equal(counts.long(), torch.bincount(chosen.reshape(-1),
                                                     minlength=TEXT.n_routed_experts))


def test_absorbed_decode_equals_expanded_attention(tiny):
    model, _ = tiny
    attn = model.layers[2].self_attn
    s, max_len = 6, 8
    h = torch.randn(1, s + 1, TEXT.hidden_size, generator=torch.Generator().manual_seed(7))
    cos, sin = kimi_vl.rope_cos_sin(torch.arange(s + 1)[None], TEXT.qk_rope_head_dim,
                                    TEXT.rope_theta)
    causal = torch.tril(torch.ones(s + 1, s + 1, dtype=torch.bool))
    bias = torch.where(causal, 0.0, kimi_vl.NEG)[None, None]
    with torch.no_grad():
        expanded = attn(h, cos, sin, bias)[:, -1]
        cache = torch.zeros(1, max_len, TEXT.latent_width)
        attn(h[:, :s], cos[:, :s], sin[:, :s], F.pad(bias[..., :s, :], (0, max_len - s - 1),
                                                      value=kimi_vl.NEG)[..., :s, :], cache, 0)
        step_bias = torch.where(torch.arange(max_len) <= s, 0.0, kimi_vl.NEG)[None, None, None]
        absorbed = attn(h[:, s:], cos[:, s:], sin[:, s:], step_bias, cache, torch.tensor(s))[:, 0]
    close(absorbed, expanded, 1e-5)


def absorbed_as_before(attn, h, cos, sin, attn_bias, cache, cache_index):
    """``MLAttention``'s one-token branch as it was before ``kernels/mla.py``:
    ``deepseek_rope`` (an ``addcmul``), the latent norm by ``mean``, and
    every product, the scores and the probabilities rounded to the working
    dtype."""
    t = attn.t
    b = h.shape[0]
    nh, nope, rope_d, r = t.num_heads, t.qk_nope_head_dim, t.qk_rope_head_dim, t.kv_lora_rank
    y = attn.q_kv_a(h)
    q_nope = y[..., :nh * nope].view(b, 1, nh, nope)
    pe = kimi_vl.deepseek_rope(y[..., nh * nope + r:].view(b, 1, nh + 1, rope_d), cos, sin)
    c = add_rms_norm_plain(y[..., nh * nope:nh * nope + r].contiguous(), None,
                           attn.kv_a_layernorm.scale, attn.kv_a_layernorm.eps)[1]
    cache.index_copy_(1, cache_index.view(1), torch.cat([c, pe[:, :, nh]], dim=-1).to(cache.dtype))
    w_uk, w_uv = attn.absorbed()
    q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk).transpose(0, 1)
    qf = torch.cat([q_lat, pe[:, 0, :nh]], dim=-1)
    kv = cache.to(qf.dtype)
    logits = torch.baddbmm(attn_bias[:, 0].to(qf.dtype), qf, kv.transpose(1, 2),
                           alpha=t.qk_head_dim ** -0.5)
    probs = torch.softmax(logits, dim=-1, dtype=torch.float32).to(qf.dtype)
    out = torch.bmm(torch.matmul(probs, kv[..., :r]).transpose(0, 1), w_uv).transpose(0, 1)
    return attn.o_proj(out.reshape(b, 1, nh * t.v_head_dim))


def step_inputs(dtype, rows=2, max_len=8, index=5, seed=11):
    """A decode step of ``rows`` rows at slot ``index`` of ``max_len``: the
    earlier slots seeded, slot 2 prompt padding (masked), the later slots
    masked."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(rows, 1, TEXT.hidden_size, generator=g).to(dtype)
    cos, sin = kimi_vl.rope_cos_sin(torch.full((rows, 1), index), TEXT.qk_rope_head_dim,
                                    TEXT.rope_theta)
    cache = torch.randn(rows, max_len, TEXT.latent_width, generator=g).to(dtype)
    valid = torch.arange(max_len) <= index
    valid[2] = False
    bias = torch.where(valid, 0.0, kimi_vl.NEG).expand(rows, 1, 1, max_len).contiguous()
    return h, cos, sin, bias, cache, torch.tensor(index)


@pytest.mark.parametrize("route", ["plain", "wrapper"])
def test_mla_decode_plain_equals_the_absorbed_branch_it_replaced(tiny, route):
    """In f32 the two part only by sum order: the output to 1e-5 of its
    scale, the cache slot to f32 rounding (the norm's sum of squares runs in
    the kernel's order, the rope's products are rounded apart)."""
    model, _ = tiny
    attn = model.layers[2].self_attn
    h, cos, sin, bias, cache, index = step_inputs(torch.float32)
    before = cache.clone()
    with torch.no_grad():
        want = absorbed_as_before(attn, h, cos, sin, bias, before, index)
        w_uk, w_uv = attn.absorbed()
        ln = attn.kv_a_layernorm
        step = tmla.mla_decode if route == "wrapper" else tmla.mla_decode_plain
        got = attn.o_proj(step(attn.q_kv_a(h), cos, sin, ln.scale, ln.eps, cache, index, w_uk,
                               w_uv, bias))
    close(got, want, 1e-5)
    torch.testing.assert_close(cache, before, rtol=2e-6, atol=0)
    assert torch.equal(cache[:, :5], before[:, :5]) and torch.equal(cache[:, 6:], before[:, 6:])


def test_the_plain_route_writes_the_same_cache_slot(tiny):
    """bf16, as the card runs it: the slot ``mla_decode_plain`` writes is
    the one the replaced branch wrote (the prefill's arithmetic), bit for
    bit at this seed: only an f32 ulp of a sum's order could round a value
    apart."""
    _, weights = tiny
    model = kimi_vl.kimi_model_from(CFG, weights, torch.bfloat16, "cpu")
    attn = model.layers[1].self_attn
    h, cos, sin, bias, cache, index = step_inputs(torch.bfloat16, seed=12)
    before = cache.clone()
    with torch.no_grad():
        absorbed_as_before(attn, h, cos, sin, bias, before, index)
        attn(h, cos, sin, bias, cache, index)
    assert torch.equal(cache, before)


def test_the_latent_norm_sums_in_the_kernels_order():
    """``rms_norm_plain`` against the kernel's order simulated in numpy f32:
    each thread's 8 squares in turn, the 64 sums halved pairwise; values of
    wide range so that another order would round apart."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 512)) * np.exp2(rng.integers(-9, 9, (3, 512)))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(512)).astype(np.float32)
    sums = []
    for row in x:
        part = np.zeros(64, np.float32)
        for t in range(64):
            for j in range(8):
                part[t] = np.float32(part[t] + np.float32(row[8 * t + j] * row[8 * t + j]))
        while len(part) > 1:
            part = (part[:len(part) // 2] + part[len(part) // 2:]).astype(np.float32)
        sums.append(part[0])
    r = torch.rsqrt(torch.tensor(sums)[:, None] / 512 + 1e-6)
    want = torch.as_tensor(x) * r * torch.as_tensor(scale)
    got = tmla.rms_norm_plain(torch.as_tensor(x), torch.as_tensor(scale), 1e-6)
    assert torch.equal(got, want)
    assert not torch.equal(torch.tensor(sums), torch.as_tensor((x * x).sum(-1)))  # order shows


def test_moonvit_rope_2d_at_a_known_row_and_column():
    gh, gw, hd, theta = 3, 5, 8, 100.0
    ang = rope_2d_angles(gh, gw, hd, theta)
    row, col = 2, 3
    f = np.array([1.0, theta ** (-4 / 8)], np.float32)
    np.testing.assert_allclose(ang[row * gw + col], [col * f[0], row * f[0], col * f[1],
                                                     row * f[1]], rtol=1e-6)
    cis = ref.rope_2d(gh, gw, hd, theta, "cpu")
    np.testing.assert_allclose(np.angle(cis.numpy()), np.angle(np.exp(1j * ang)), atol=1e-5)
    # a unit vector in each pair turns by its angle
    x = torch.zeros(1, gh * gw, 1, hd)
    x[..., 0::2] = 1.0
    a = torch.as_tensor(ang)[:, None]
    y = apply_rope_2d(x, torch.cos(a), torch.sin(a))
    np.testing.assert_allclose(y[0, row * gw + col, 0, 0::2], np.cos(ang[row * gw + col]),
                               atol=1e-6)
    np.testing.assert_allclose(y[0, row * gw + col, 0, 1::2], np.sin(ang[row * gw + col]),
                               atol=1e-6)


def test_a_frame_attends_within_itself_only(tiny):
    model, _ = tiny
    frames = pixels(2, seed=9)
    other = frames.clone()
    other[1] = pixels(1, seed=10)[0]
    with torch.no_grad():
        a, b = model.encode_images(frames), model.encode_images(other)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])


def test_the_backend_serves_kimi_vl_one_request_at_a_time(tiny):
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend
    from tstar_tpu_torch.models.qwen_tokenizer import QwenTokenizer, write_byte_vocab

    model, _ = tiny
    specials = {k: 300 + i for i, k in enumerate(kimi_vl.KIMI_SPECIAL_TOKENS)}
    specials["<|media_pad|>"] = MEDIA
    with tempfile.TemporaryDirectory() as d:
        write_byte_vocab(d, specials)
        tok = QwenTokenizer.from_dir(d)
    backend = TorchVLMBackend.from_model(model, tok)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (6, 10, 3), np.uint8) for _ in range(2)]
    inp = model.prepare_inputs(tok, "Look:\n<image>\n<image>\nWhat is it?", frames)
    assert inp["image_patches"].shape == (2, 8, 12, 3)          # padded to whole 4-pixel cells
    ids = inp["input_ids"][0].tolist()
    assert ids.count(MEDIA) == 2 * 6 and ids[-1] == specials["<|im_middle|>"]
    assert ids.count(specials["<|media_start|>"]) == 2
    np.testing.assert_array_equal(inp["position_ids"][0], np.arange(len(ids)))
    one = backend.inference_with_frames("Look:\n<image>\n<image>\nWhat?", frames, 0.0, 6)
    both = backend.inference_with_frames_batch(["Look:\n<image>\n<image>\nWhat?"] * 2,
                                               [frames, frames], 0.0, 6)
    assert both == [one, one]
