"""The VLM stages on the card: the decode loop stepped through a CUDA graph
gives the eager loop's tokens (greedy, and sampled from the same generator
state), a second request of the same bucket captures nothing, a replay
synchronizes nothing, a capture that fails raises, and the grounder loaded
from a checkpoint onto the card answers as on the CPU.  Every test here
needs a CUDA device and skips without one.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_vlm.py

The models are tiny (2 layers, 32 wide, f32) with seeded random weights;
``chip_smoke.py`` phase 9 runs the same checks at LLaVA-OneVision-7B's widths.
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
from tstar_tpu_torch.search.step_graphs import GraphCaptureError

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
        (bucket,) = [b for b in model._decode_buckets.values() if b.graph is not None]
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
