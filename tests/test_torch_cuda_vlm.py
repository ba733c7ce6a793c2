"""The VLM stages on the card: the decode loop stepped through a CUDA graph
gives the eager loop's tokens (greedy, and sampled from the same generator
state), a second request of the same bucket captures nothing, a replay
synchronizes nothing, a capture that fails raises, and the grounder loaded
from a checkpoint onto the card answers as on the CPU.  Every test here
needs a CUDA device and skips without one.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_vlm.py

The models are tiny (2 layers, 32 wide, f32) with seeded random weights;
``chip_smoke.py`` phase 9 runs the same checks at LLaVA-OneVision-7B's widths.
The decode step's three kernels (``kernels/decode.py``) are held to their
plain versions at Qwen2-7B's decode widths (B = 1 and 4, 257 to 2,432 cache
slots, a tensor-parallel rank's local heads), and a graph-captured greedy
decode at those widths emits the plain route's tokens up to the first tie
of bf16 logits that the routes' rounding breaks apart.
"""

import numpy as np
import pytest
import torch

from tstar_tpu_torch.grounding.universal import UniversalGrounder
from tstar_tpu_torch.models import generate as tgen
from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionConfig, LlavaOnevisionModel
from tstar_tpu_torch.models.loader import save_vlm_checkpoint
from tstar_tpu_torch.models.qwen2vl import (
    Qwen2VLConfig, Qwen2VLModel, Qwen2VLTextConfig, Qwen2VLVisionConfig, build_mrope_position_ids,
    init_random_,
)
from tstar_tpu_torch.models.qwen_tokenizer import SPECIAL_TOKENS, write_byte_vocab
from tstar_tpu_torch.models.siglip import SiglipVisionConfig
from tstar_tpu_torch.utils.cuda_graphs import GraphCaptureError

SPECIAL = {tok: 256 + i for i, tok in enumerate(SPECIAL_TOKENS)}
TEXT = dict(vocab_size=300, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=64, rope_theta=10000.0, tie_word_embeddings=False)


def tiny(family):
    if family == "qwen":
        return Qwen2VLModel(Qwen2VLConfig(
            vision=Qwen2VLVisionConfig(depth=2, embed_dim=16, num_heads=2, mlp_ratio=2.0,
                                       hidden_size=32),
            text=Qwen2VLTextConfig(**TEXT, mrope_section=(1, 1, 2)),
            image_token_id=SPECIAL["<|image_pad|>"], video_token_id=SPECIAL["<|video_pad|>"],
            vision_start_token_id=SPECIAL["<|vision_start|>"]))
    return LlavaOnevisionModel(LlavaOnevisionConfig(
        vision=SiglipVisionConfig(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
                                  patch_size=2, image_size=8),
        text=Qwen2VLTextConfig(**TEXT, mrope_section=(4, 0, 0)),
        image_token_id=264, video_token_id=265))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def model_on_card(family, seed=0):
    return init_random_(tiny(family), torch.Generator().manual_seed(seed)).to("cuda").eval()


def prompt(n=9, seed=0):
    ids = np.random.default_rng(seed).integers(1, 250, size=(1, n)).astype(np.int32)
    return ids, np.array([n]), build_mrope_position_ids(ids[0], -1, [], 2)[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["qwen", "llava"])
def test_graph_decode_equals_eager_and_reuses_its_bucket(card, family):
    model = model_on_card(family)
    ids, lens, pos = prompt()
    kw = dict(max_new_tokens=20, eos_token_ids=[299])
    with torch.no_grad():
        eager = tgen.generate(model, ids, lens, pos, graphs=False, **kw).tolist()
        stats = tgen.GenerateStats()
        graph = tgen.generate(model, ids, lens, pos, stats=stats, **kw).tolist()
        assert graph == eager
        assert stats.captures == 1 and stats.replays == stats.decode_steps - 1
        # another prompt of the same bucket: no capture, replays only
        ids2, lens2, pos2 = prompt(n=12, seed=1)
        before = stats.captures
        again = tgen.generate(model, ids2, lens2, pos2, stats=stats, **kw).tolist()
        assert stats.captures == before
        assert again == tgen.generate(model, ids2, lens2, pos2, graphs=False, **kw).tolist()


@pytest.mark.cuda
def test_sampling_graph_equals_eager(card):
    model = model_on_card("qwen", seed=1)
    ids, lens, pos = prompt()
    outs = []
    stats = tgen.GenerateStats()
    with torch.no_grad():
        for graphs in (False, True, True):
            gen = torch.Generator(device="cuda").manual_seed(5)
            outs.append(tgen.generate(model, ids, lens, pos, max_new_tokens=16, eos_token_ids=[299],
                                      temperature=0.9, generator=gen, graphs=graphs,
                                      stats=stats).tolist())
    # a new generator each call: its state goes into the bucket's own
    # generator, so the graph is captured once and replayed the second time
    assert outs[0] == outs[1] == outs[2]
    assert stats.captures == 1
    assert all(0 <= t < 300 for t in outs[0][0])


@pytest.mark.cuda
def test_replay_synchronizes_nothing(card):
    model = model_on_card("qwen")
    ids, lens, pos = prompt()
    with torch.no_grad():
        tgen.generate(model, ids, lens, pos, max_new_tokens=8, eos_token_ids=[299])
        (bucket,) = [b for b in model._decode_buckets.values() if "step" in b.graphs]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            bucket.run_step(tgen.GenerateStats())
            bucket.run_step(tgen.GenerateStats())
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_capture_that_fails_raises(card, monkeypatch):
    model = model_on_card("qwen")
    ids, lens, pos = prompt()
    body = tgen.DecodeBucket.body

    def reads_the_host(self):
        body(self)
        bool(self.flag)          # a host read: eager runs it, a capture cannot

    monkeypatch.setattr(tgen.DecodeBucket, "body", reads_the_host)
    with torch.no_grad(), pytest.raises(GraphCaptureError):
        tgen.generate(model, ids, lens, pos, max_new_tokens=8, eos_token_ids=[299])
    # the failed capture left the default generator out of capture mode
    assert torch.isfinite(torch.randn(4, device="cuda")).all()


def write_checkpoint(model, d):
    save_vlm_checkpoint(model, str(d))
    write_byte_vocab(str(d), SPECIAL)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["qwen", "llava"])
def test_grounder_on_card_equals_cpu(card, family, tmp_path):
    write_checkpoint(init_random_(tiny(family), torch.Generator().manual_seed(3)), tmp_path)
    rng = np.random.default_rng(0)
    items = [{"frames": [rng.integers(0, 256, (64, 80, 3), np.uint8) for _ in range(2)],
              "question": f"what {'is it ' * i}?", "options": "A) x\nB) y"} for i in range(4)]
    answers = {}
    for device in ("cpu", "cuda"):
        g = UniversalGrounder(f"{family}-tiny", model_path=str(tmp_path), device=device,
                              dtype=torch.float32)
        g.backend.max_pixels = 56 * 56
        with torch.no_grad():
            answers[device] = (
                [g.inference_qa(it["frames"], it["question"], it["options"], temperature=0.0)
                 for it in items],
                g.inference_qa_batch(items, temperature=0.0),
            )
    assert answers["cuda"] == answers["cpu"]
    assert answers["cuda"][0] == answers["cuda"][1]


@pytest.mark.cuda
def test_timed_stats_are_the_generate_spans(card):
    """``GenerateStats(timed=True)`` reads its spans' own events: with no
    profiler it still fills ``prefill_ms`` / ``decode_ms`` and the registry
    stays empty; under the profiler the ``generate.prefill`` and
    ``generate.decode`` spans hold the same milliseconds."""
    from tstar_tpu_torch.utils import profiling

    model = model_on_card("qwen")
    stats = tgen.GenerateStats(timed=True)
    kw = dict(max_new_tokens=8, eos_token_ids=[299], stats=stats)
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.no_grad():
            tgen.generate(model, *prompt(), **kw)
            assert len(stats.prefill_ms) == len(stats.decode_ms) == 1
            assert profiling.snapshot() == {}
            with torch.profiler.profile(activities=acts):
                for n, seed in ((12, 1), (9, 2)):
                    tgen.generate(model, *prompt(n, seed), **kw)
        snap = profiling.snapshot()
    finally:
        profiling.reset()
    assert all(ms > 0 for ms in stats.prefill_ms + stats.decode_ms)
    for name, got in (("generate.prefill", stats.prefill_ms), ("generate.decode", stats.decode_ms)):
        assert snap[name]["count"] == 2
        assert snap[name]["device_ms"] == pytest.approx(sum(got[1:]), rel=1e-9, abs=0)


# ---------------------------------------------------------------------------
# the decode step's kernels (kernels/decode.py) at Qwen2-7B's decode widths
# ---------------------------------------------------------------------------

def bf16_ulp(t):
    """The spacing of bf16 values at |t|."""
    return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126))) - 7)


def assert_within_one_ulp(got, want, row=None):
    """|got - want| <= one bf16 ulp: of each value of ``want`` or, with
    ``row``, of the largest of each run of ``row`` values (an attention
    head's output).  The kernels round where their plain versions round and
    sum in another order, so a sum whose last f32 bit differs may round the
    other way: a norm's or an activation's value by one ulp of itself, an
    attention logit or probability by one ulp, which moves every value of
    its head by about a ulp of the head's largest value."""
    scale = want.float().abs()
    if row is not None:
        scale = scale.reshape(-1, row).amax(dim=-1, keepdim=True).expand(-1, row).reshape(want.shape)
    err = (got.float() - want.float()).abs()
    worst = (err / bf16_ulp(scale)).max().item()
    assert worst <= 1.0, f"{worst:.2f} ulp"


def randn(*shape, std=1.0, seed=0, dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("with_delta", [True, False], ids=["delta", "first"])
def test_add_rms_norm_kernel_equals_plain(card, rows, with_delta):
    from tstar_tpu_torch.kernels import decode

    x = randn(rows, 1, 3584, std=3.0, seed=1)
    delta = randn(rows, 1, 3584, seed=2) if with_delta else None
    scale = randn(3584, std=0.2, seed=3) + 1.0
    before = decode.add_rms_norm.launches
    res, h = decode.add_rms_norm(x, delta, scale, 1e-6)
    want_res, want_h = decode.add_rms_norm_plain(x, delta, scale, 1e-6)
    torch.cuda.synchronize()
    assert decode.add_rms_norm.launches == before + 1
    assert torch.equal(res, want_res)
    assert_within_one_ulp(h, want_h)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("width", [18944, 9472, 4736], ids=["tp1", "tp2", "tp4"])
def test_silu_mul_kernel_equals_plain(card, rows, width):
    from tstar_tpu_torch.kernels import decode

    gate, up = randn(rows, 1, width, std=3.0, seed=4), randn(rows, 1, width, seed=5)
    got = decode.silu_mul(gate, up)
    torch.cuda.synchronize()
    assert_within_one_ulp(got, decode.silu_mul_plain(gate, up))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("slots", [257, 1000, 2432])
@pytest.mark.parametrize("heads", [(28, 4), (14, 2), (7, 1)], ids=["28of4", "14of2", "7of1"])
def test_decode_attention_kernel_equals_plain(card, batch, slots, heads):
    """One token at the middle slot; a run of prompt padding and every later
    slot masked, the cache holding other values there.  The kernel writes
    the same cache slot as the plain ``index_copy_``, bit for bit."""
    from tstar_tpu_torch.kernels import decode
    from tstar_tpu_torch.models.qwen2vl import mrope_cos_sin

    nh, nkv = heads
    index = slots // 2
    q, k, v = (randn(batch, 1, n * 128, seed=10 + i) for i, n in enumerate((nh, nkv, nkv)))
    biases = [randn(n * 128, std=0.5, seed=20 + i) for i, n in enumerate((nh, nkv, nkv))]
    cache = tuple(randn(batch, slots, nkv, 128, seed=30 + i) for i in range(2))
    valid = torch.ones(batch, slots, dtype=torch.bool, device="cuda")
    valid[:, slots // 4: slots // 4 + 10] = False
    valid[:, index + 1:] = False
    bias = torch.where(valid[:, None, None, :], 0.0, torch.finfo(torch.float32).min)
    pos = torch.full((3, batch, 1), index, dtype=torch.int64, device="cuda")
    cos, sin = mrope_cos_sin(pos, 128, (16, 24, 24), 1e6)
    at = torch.tensor(index, device="cuda")
    plain_cache = tuple(t.clone() for t in cache)
    before = decode.decode_attention.launches
    got = decode.decode_attention(q, k, v, *biases, cos, sin, bias, cache, at, nh, nkv)
    want = decode.decode_attention_plain(q, k, v, *biases, cos, sin, bias, plain_cache, at, nh,
                                         nkv)
    torch.cuda.synchronize()
    assert decode.decode_attention.launches == before + 1
    assert torch.equal(cache[0], plain_cache[0]) and torch.equal(cache[1], plain_cache[1])
    assert_within_one_ulp(got, want, row=128)


def teacher_forced_logits(model, ids, tokens):
    """Each decode step's logits (f32, (steps, vocab)) for one unpadded
    prompt followed by ``tokens``, fed in (``generate``'s state, eagerly)."""
    s = ids.shape[1]
    ids_t = torch.as_tensor(ids, device="cuda")
    pos = torch.as_tensor(build_mrope_position_ids(ids[0], -1, [], 2)[:, None], device="cuda")
    lens = torch.tensor([s], device="cuda")
    max_len = tgen.bucket_len(s + len(tokens))
    first, caches = tgen.prefill(model, ids_t, lens, pos, None, None, max_len)
    valid = torch.ones(1, max_len, dtype=torch.bool, device="cuda")
    out = [first.float()]
    for t, tok in enumerate(tokens[:-1]):
        token = torch.tensor([tok], device="cuda")
        at = torch.tensor(s + t, device="cuda")
        step_pos = (pos.amax() + 1 + t).reshape(1)
        out.append(tgen.decode_step(model, token, at, step_pos, valid, caches).float())
    return torch.cat(out)


@pytest.mark.cuda
def test_fused_decode_emits_the_plain_routes_tokens(card, monkeypatch):
    """A graph-captured greedy decode of 64 tokens on seeded weights at
    Qwen2-7B's widths (a one-layer stand-in vision tower), on the fused
    route (28 of 28 layers) and on the plain one, which a replay of the
    plain tokens through both routes' steps explains: the tokens are the
    same up to the first step whose top two plain logits lie closer than
    the routes' logits differ there (seeded weights give bf16 logits that
    tie exactly at some steps, and a sum in another order may break such a
    tie the other way), and the routes' logits differ by at most 0.15 at
    every step: the benchmark's limit on how far a served token's logit may
    lie below the float32 reference's best.  A replay adds each kernel's
    launches of a step to its count."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models import qwen2vl
    from tstar_tpu_torch.models.qwen2vl import Qwen2VLConfig, Qwen2VLModel, random_model

    cfg = Qwen2VLConfig(vision=Qwen2VLVisionConfig(depth=1, embed_dim=32, num_heads=2))
    model = random_model(Qwen2VLModel, cfg, torch.bfloat16, "cuda", seed=0)
    ids = np.random.default_rng(0).integers(0, 150000, size=(1, 200))
    pos = build_mrope_position_ids(ids[0], -1, [], 2)[:, None]
    kw = dict(max_new_tokens=64, eos_token_ids=[151643])
    runs, forced = {}, {}
    try:
        for route in ("fused", "plain"):
            if route == "plain":
                monkeypatch.setattr(qwen2vl, "fused_decode_supported", lambda *a: False)
                model._decode_buckets.clear()
            stats = tgen.GenerateStats()
            reset_launch_counts()
            with torch.no_grad():
                tokens = tgen.generate(model, ids, np.array([200]), pos, stats=stats, **kw)
            runs[route] = (tokens[0].tolist(), stats, launch_counts())
        plain = runs["plain"][0]
        with torch.no_grad():
            forced["plain"] = teacher_forced_logits(model, ids, plain)
            monkeypatch.undo()
            forced["fused"] = teacher_forced_logits(model, ids, plain)
    finally:
        del model
        torch.cuda.empty_cache()
    (fused, stats, counts), (_, plain_stats, plain_counts) = runs["fused"], runs["plain"]
    lp, lf = forced["plain"], forced["fused"]
    assert lp.argmax(dim=-1).tolist() == plain          # the replay is the plain decode
    diff = (lf - lp).abs().amax(dim=-1)
    top2 = lp.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    assert diff.max().item() <= 0.15
    part = next((t for t in range(64) if fused[t] != plain[t]), 64)
    assert all(lf[t].argmax().item() == plain[t] for t in range(part))
    if part < 64:
        assert gap[part].item() <= diff[part].item(), (part, gap[part].item())
        assert lf[part].argmax().item() == fused[part]
    assert stats.captures == 1 and stats.replays == stats.decode_steps - 1
    assert stats.step_launches["decode_attention"] == 28 and plain_stats.step_launches == {}
    steps = stats.decode_steps
    assert counts["decode_attention"] == 28 * steps and counts["silu_mul"] == 28 * steps
    assert counts["add_rms_norm"] == 57 * steps
    assert not any(plain_counts.values())
