"""Kimi-VL on the card: the MoE decode kernel (``kernels/moe.moe_decode``,
``csrc/moe_decode.cu``) and the router kernel (``moe_route``) against their
plain versions at the published widths (D 2,048, 64 experts of 1,408, 6 a
token, 2 shared) for 1 and 4 tokens, with the counts and route log; the
latent-attention kernel (``kernels/mla.mla_decode``, ``csrc/mla_decode.cu``)
against ``mla_decode_plain`` at the published widths for 1 and 4 rows at 1,
2,401 and 3,500 live slots of a 3,584-slot bucket; the decode loop replayed
from a CUDA graph gives the eager loop's tokens with no host read but the
loop's flag, with MLA at the published widths too; and a full-size step
takes the kernels in all 26 MoE layers and all 27 attention layers.  Every
test here needs a CUDA device and skips without one.  This file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kimi_vl.py

Tolerance of the MoE kernel: two bf16 ulps of the output's largest value
(2^-7 of it).  Kernel and plain version round at the same points, but
their f32 sums run in other orders, so an intermediate bf16 rounding
(a gate, an up or an expert's output) may flip, and the flip carries into
the weighted sum; the route log and the counts are exact.

Tolerance of the MLA kernel: its cache slot exact; each head's output
within ``MLA_ULPS`` bf16 ulps of that head's largest value.  The kernel
rounds its probabilities to bf16 before they are normalised, relative to
the running max of its slots (the plain version rounds the normalised
ones), and its sums (q_lat, the scores, o_lat, the output) run in another
order: each probability's rounding moves the head's output by up to half
an ulp of its weight, and a q_lat value that rounds the other way moves
every score of the head.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tstar_tpu_torch.kernels import mla as tmla
from tstar_tpu_torch.kernels import moe as tmoe
from tstar_tpu_torch.models import generate as tgen
from tstar_tpu_torch.models import kimi_vl
from tstar_tpu_torch.models.moonvit import MoonViTConfig


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the MoE kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def experts(d=2048, i=1408, e=64, ns=2, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=g, device="cuda") / shape[-1] ** 0.5).bfloat16()

    return w(e, 2 * i, d), w(e, d, i), w(2 * ns * i, d), w(d, ns * i)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 4])
def test_moe_kernel_equals_its_plain_version(card, tokens):
    d, e, k = 2048, 64, 6
    w13, w2, sw13, sw2 = experts()
    g = torch.Generator(device="cuda").manual_seed(tokens)
    x = torch.randn(tokens, d, generator=g, device="cuda").bfloat16()
    gate = (torch.randn(e, d, generator=g, device="cuda") / d ** 0.5).bfloat16()
    bias = (torch.randn(e, generator=g, device="cuda") * 0.02).bfloat16()
    ids, weights = tmoe.route(x, gate, bias, k, 2.446)
    if tokens > 1:
        ids[1] = ids[0]                   # two tokens share their experts: each read once
    counts = torch.zeros(e, dtype=torch.int32, device="cuda")
    log = torch.zeros(tokens, 9, k, dtype=torch.int64, device="cuda")
    before = tmoe.moe_decode.launches
    got = tmoe.moe_decode(x, ids, weights, w13, w2, sw13, sw2, counts, log,
                          torch.tensor(5, device="cuda"))
    torch.cuda.synchronize()
    assert tmoe.moe_decode.launches == before + 1
    want = tmoe.moe_grouped(x, ids, weights, w13, w2, sw13, sw2)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -7 * want.float().abs().max().item(), err
    assert torch.equal(log[:, 5], ids) and not log[:, :5].any() and not log[:, 6:].any()
    assert torch.equal(counts.long(), torch.bincount(ids.reshape(-1), minlength=e))


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 4])
def test_router_kernel_equals_its_plain_version(card, tokens):
    """The same experts in the same order, their weights to f32 rounding:
    the kernel's dot products run in another order than the plain product's
    (a choice within an f32 ulp of the next expert could part: none here)."""
    d, e, k = 2048, 64, 6
    g = torch.Generator(device="cuda").manual_seed(10 + tokens)
    x = torch.randn(tokens, d, generator=g, device="cuda").bfloat16()
    gate = (torch.randn(e, d, generator=g, device="cuda") / d ** 0.5).bfloat16()
    bias = (torch.randn(e, generator=g, device="cuda") * 0.02).bfloat16()
    before = tmoe.moe_route.launches
    ids, weights = tmoe.moe_route(x, gate, bias, k, 2.446)
    torch.cuda.synchronize()
    assert tmoe.moe_route.launches == before + 1
    want_ids, want_weights = tmoe.route(x, gate, bias, k, 2.446)
    assert torch.equal(ids, want_ids)
    torch.testing.assert_close(weights, want_weights, rtol=1e-5, atol=1e-6)


MLA_ULPS = 2


def mla_step(rows, live, slots=3584, seed=0):
    """One decode step's inputs at the published widths: the projection's
    output, the rope of the step's position, the latent norm's scale, a
    seeded cache whose slot ``live - 1`` the step writes, a mask hiding a
    run of prompt padding and every later slot, W_UK and W_UV."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).bfloat16()

    index = live - 1
    y = randn(rows, 1, 16 * 192 + 576)
    cos, sin = kimi_vl.rope_cos_sin(torch.full((rows, 1), index, device="cuda"), 64, 800000.0)
    norm = randn(512, std=0.1) + 1.0
    cache = randn(rows, slots, 576)
    valid = torch.arange(slots, device="cuda") <= index
    valid[600:610] = False
    bias = torch.where(valid, 0.0, torch.finfo(torch.float32).min).expand(rows, 1, 1, slots)
    return (y, cos, sin, norm, 1e-6, cache, torch.tensor(index, device="cuda"),
            randn(16, 128, 512, std=128 ** -0.5), randn(16, 512, 128, std=512 ** -0.5),
            bias.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("live", [1, 2401, 3500])
@pytest.mark.parametrize("rows", [1, 4])
def test_mla_kernel_equals_its_plain_version(card, rows, live):
    args = mla_step(rows, live, seed=live + rows)
    cache = args[5]
    plain_cache = cache.clone()
    before = tmla.mla_decode.launches
    got = tmla.mla_decode(*args)
    torch.cuda.synchronize()
    assert tmla.mla_decode.launches == before + 1
    want = tmla.mla_decode_plain(*args[:5], plain_cache, *args[6:])
    assert torch.equal(cache, plain_cache)
    got, want = got.float().view(rows, 16, 128), want.float().view(rows, 16, 128)
    largest = want.abs().amax(dim=-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(largest.clamp_min(2.0 ** -126))) - 7)
    ratio = ((got - want).abs() / ulp).amax().item()
    print(f"mla rows={rows} live={live}: max error {ratio:.3f} bf16 ulps of the head's largest")
    assert ratio <= MLA_ULPS and bool(got.isfinite().all())


@pytest.mark.cuda
def test_mla_kernel_raises_on_what_it_does_not_take(card):
    args = list(mla_step(1, 10, slots=64))
    with pytest.raises(ValueError):
        tmla.mla_decode(args[0].float(), *args[1:])
    args[9] = args[9].bfloat16()
    with pytest.raises(ValueError):
        tmla.mla_decode(*args)


SMALL = kimi_vl.KimiVLConfig(
    vision=MoonViTConfig(hidden_size=64, num_layers=1, num_heads=2, intermediate_size=96,
                         pos_emb_height=8, pos_emb_width=8),
    text=kimi_vl.KimiVLTextConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512, moe_intermediate_size=64,
        num_layers=3, num_heads=2, kv_lora_rank=256, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=3),
    media_token_id=511)


@pytest.mark.cuda
def test_graph_decode_equals_eager_and_takes_the_kernels(card):
    weights = kimi_vl.seeded_flat_weights(SMALL, 0, device="cuda")
    model = kimi_vl.kimi_model_from(SMALL, weights, torch.bfloat16, "cuda")
    ids = np.random.default_rng(0).integers(1, 500, size=(1, 21)).astype(np.int32)
    pos = np.arange(21, dtype=np.int32)[None]
    kw = dict(max_new_tokens=24, eos_token_ids=[510])
    with torch.no_grad():
        eager = tgen.generate(model, ids, np.array([21]), pos, graphs=False, **kw).tolist()
        stats = tgen.GenerateStats()
        graph = tgen.generate(model, ids, np.array([21]), pos, stats=stats, **kw).tolist()
    assert graph == eager
    assert stats.captures == 1 and stats.replays == stats.decode_steps - 1
    assert stats.flag_reads == stats.decode_steps - 1     # the loop's one read a step
    assert stats.moe_layers == 2 and stats.step_launches["moe_decode"] == 2
    assert "decode_attention" not in stats.step_launches and "mla_decode" not in stats.step_launches


# MLA at the published widths (16 heads, kv_lora_rank 512, rope 64, nope and
# v 128) under a narrow hidden state and small experts
MLA_WIDE = dataclasses.replace(SMALL, text=dataclasses.replace(
    SMALL.text, num_heads=16, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128))


@pytest.mark.cuda
def test_graph_decode_with_the_mla_kernel_equals_eager_and_reads_nothing(card):
    """Every layer's attention on ``mla_decode``, eager and replayed: the
    same tokens, and a replay under ``set_sync_debug_mode("error")``."""
    weights = kimi_vl.seeded_flat_weights(MLA_WIDE, 3, device="cuda")
    model = kimi_vl.kimi_model_from(MLA_WIDE, weights, torch.bfloat16, "cuda")
    ids = np.random.default_rng(4).integers(1, 500, size=(1, 150)).astype(np.int32)
    pos = np.arange(150, dtype=np.int32)[None]
    kw = dict(max_new_tokens=40, eos_token_ids=[510])
    with torch.no_grad():
        eager_stats = tgen.GenerateStats()
        eager = tgen.generate(model, ids, np.array([150]), pos, graphs=False, stats=eager_stats,
                              **kw).tolist()
        stats = tgen.GenerateStats()
        graph = tgen.generate(model, ids, np.array([150]), pos, stats=stats, **kw).tolist()
        (bucket,) = [b for b in model._decode_buckets.values() if "step" in b.graphs]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            bucket.run_step(tgen.GenerateStats())
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert graph == eager
    assert eager_stats.step_launches["mla_decode"] == stats.step_launches["mla_decode"] == 3
    assert stats.moe_layers == 2
    assert stats.captures == 1 and stats.replays == stats.decode_steps - 1


@pytest.mark.cuda
def test_prefill_and_replay_read_nothing_from_the_host(card):
    """The prefill's grouped experts and a replayed step under
    ``set_sync_debug_mode("error")``: a host read there raises."""
    weights = kimi_vl.seeded_flat_weights(SMALL, 1, device="cuda")
    model = kimi_vl.kimi_model_from(SMALL, weights, torch.bfloat16, "cuda")
    ids = torch.as_tensor(np.random.default_rng(2).integers(1, 500, size=(1, 37)), device="cuda")
    pos = torch.arange(37, device="cuda")[None]
    lens = torch.tensor([37], device="cuda")
    with torch.no_grad():
        tgen.generate(model, ids, lens, pos, max_new_tokens=8, eos_token_ids=[510])
        (bucket,) = [b for b in model._decode_buckets.values() if "step" in b.graphs]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tgen.prefill(model, ids, lens, pos, None, None, 128, caches=bucket.caches)
            bucket.run_step(tgen.GenerateStats())
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_full_size_step_takes_the_kernel_in_every_moe_layer(card):
    cfg = kimi_vl.KimiVLConfig()
    shapes = dict(kimi_vl.flat_weight_shapes(cfg))
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("meta"):
        model = kimi_vl.KimiVLModel(cfg)
    model = model.to(torch.bfloat16).to_empty(device="cuda").requires_grad_(False).eval()
    model.expert_tokens.zero_()

    def get(name):
        shape = shapes[name]
        if name.endswith("scale"):
            return torch.ones(shape, device="cuda")
        return torch.randn(shape, generator=g, device="cuda") * 0.02

    kimi_vl.load_weights(model, get)
    ids = np.random.default_rng(1).integers(1, 160000, size=(1, 40)).astype(np.int32)
    stats = tgen.GenerateStats()
    with torch.no_grad():
        out = tgen.generate(model, ids, np.array([40]), np.arange(40)[None], max_new_tokens=6,
                            eos_token_ids=[163586], stats=stats)
    torch.cuda.synchronize()
    assert out.shape == (1, 6)
    assert stats.moe_layers == stats.step_launches["moe_decode"] == 26
    assert stats.step_launches["mla_decode"] == 27 and stats.captures == 1
    assert int(model.expert_tokens.sum()) == 26 * 6 * (40 + stats.decode_steps)
