"""The port's checkpoint reader, VLM backend and grounder against the JAX
reference's, on tiny random checkpoints that ``transformers`` writes: the
hand-written safetensors reader returns what ``safetensors.safe_open`` does
(sharded checkpoints too) and its writer's files read back; both packages
convert a checkpoint to the same weights; at temperature 0 the grounder's QA,
open QA and grounding strings equal the JAX grounder's (both in f32) for
Qwen2-VL and LLaVA-OneVision; a batch equals the serial calls; a batched
forward that fails raises while a frame-decode failure stays its item's.

The checkpoints have a 300-token vocabulary (256 byte tokens, the special
tokens at 256-263 through ``tokenizer_config.json``), so generated text is
mostly bytes rather than ids the vocabulary lacks.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu.grounding import universal as juniversal
from tstar_tpu.grounding.vlm_backend import JaxVLMBackend
from tstar_tpu.models import generate as jgen
from tstar_tpu.models import loader as jloader
from tstar_tpu.models.qwen_tokenizer import SPECIAL_TOKENS, _bytes_to_unicode
from tstar_tpu_torch.grounding import universal as tuniversal
from tstar_tpu_torch.grounding.prompts import GroundingParseError
from tstar_tpu_torch.models import loader as tloader
from tstar_tpu_torch.models.qwen2vl import params_from_jax
from tstar_tpu_torch.video.synthetic import default_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file
    several-fold; its tiny shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")

SPECIAL = {tok: 256 + i for i, tok in enumerate(SPECIAL_TOKENS)}
TEXT = dict(vocab_size=300, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=64, rope_theta=10000.0,
            max_position_embeddings=4096, tie_word_embeddings=False)


def write_tokenizer(d):
    b2u = _bytes_to_unicode()
    (d / "vocab.json").write_text(json.dumps({b2u[b]: b for b in range(256)}))
    (d / "merges.txt").write_text("#version: 0.2\n")
    added = {str(i): {"content": t} for t, i in SPECIAL.items()}
    (d / "tokenizer_config.json").write_text(json.dumps({"added_tokens_decoder": added}))


def save(model, d):
    from safetensors.torch import save_file

    torch.manual_seed(0)
    save_file({k: v.contiguous() for k, v in model.state_dict().items()}, str(d / "model.safetensors"))


@pytest.fixture(scope="module")
def qwen_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen_ckpt")
    cfg = transformers.Qwen2VLConfig(
        text_config=dict(TEXT, rms_norm_eps=1e-5,
                         rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]}),
        vision_config=dict(depth=2, embed_dim=16, num_heads=2, mlp_ratio=2.0, patch_size=14,
                           temporal_patch_size=2, spatial_merge_size=2, in_chans=3, hidden_size=32),
        image_token_id=SPECIAL["<|image_pad|>"], video_token_id=SPECIAL["<|video_pad|>"],
        vision_start_token_id=SPECIAL["<|vision_start|>"],
    )
    torch.manual_seed(0)
    save(transformers.Qwen2VLForConditionalGeneration(cfg), d)
    hf_cfg = json.loads(cfg.to_json_string())
    hf_cfg["text_config"]["rope_scaling"] = {"type": "mrope", "mrope_section": [1, 1, 2]}
    (d / "config.json").write_text(json.dumps(hf_cfg))
    write_tokenizer(d)
    return d


@pytest.fixture(scope="module")
def llava_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("llava_ckpt")
    cfg = transformers.LlavaOnevisionConfig(
        text_config=dict(TEXT, model_type="qwen2"),
        vision_config=dict(model_type="siglip_vision_model", hidden_size=16, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=32, patch_size=2,
                           image_size=8, num_channels=3),
        image_token_index=264, video_token_index=265, image_grid_pinpoints=[[8, 8]],
        vision_feature_layer=-1, vision_feature_select_strategy="full",
    )
    torch.manual_seed(0)
    save(transformers.LlavaOnevisionForConditionalGeneration(cfg), d)
    (d / "config.json").write_text(cfg.to_json_string())
    write_tokenizer(d)
    return d


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

def test_reader_matches_safe_open(qwen_dir, tmp_path):
    from safetensors import safe_open

    path = str(qwen_dir / "model.safetensors")
    got = tloader.read_safetensors(path)
    with safe_open(path, framework="pt") as f:
        keys = list(f.keys())
        assert sorted(got) == sorted(keys)
        for k in keys:
            assert torch.equal(got[k], f.get_tensor(k)), k
    # every dtype the header may name, odd sizes (misaligned offsets), an
    # empty tensor; the writer's file read back by both
    rng = np.random.default_rng(0)
    tensors = {f"t_{dt}": torch.from_numpy(rng.normal(size=(3, 5)) * 50).to(dt)
               for dt in (torch.float64, torch.float32, torch.float16, torch.bfloat16,
                          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8)}
    tensors["a_bool"] = torch.tensor([True, False, True])
    tensors["b_odd"] = torch.arange(3, dtype=torch.uint8)
    tensors["c_empty"] = torch.zeros(0, 4)
    out = tmp_path / "w.safetensors"
    tloader.write_safetensors(tensors, str(out))
    back = tloader.read_safetensors(str(out))
    with safe_open(str(out), framework="pt") as f:
        for k, v in tensors.items():
            assert torch.equal(back[k], v) and torch.equal(f.get_tensor(k), v), k


def test_sharded_and_bin_checkpoints(qwen_dir, tmp_path):
    from safetensors.torch import save_file

    sd = tloader.read_safetensors(str(qwen_dir / "model.safetensors"))
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[::2], "model-00002-of-00002.safetensors": keys[1::2]}
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    for name, ks in shards.items():
        save_file({k: sd[k].contiguous() for k in ks}, str(sharded / name))
    (sharded / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    got = tloader._read_sharded_state_dict(str(sharded))
    assert sorted(got) == keys and all(torch.equal(got[k], sd[k]) for k in keys)
    binned = tmp_path / "bin"
    binned.mkdir()
    torch.save(sd, str(binned / "pytorch_model.bin"))
    got = tloader._read_state_dict(str(binned))
    assert all(torch.equal(got[k], sd[k]) for k in keys)


@pytest.mark.parametrize("family", ["qwen", "llava"])
def test_loaded_weights_match_reference(qwen_dir, llava_dir, family):
    d = str(qwen_dir if family == "qwen" else llava_dir)
    model, tok = tloader.load_vlm_checkpoint(d, device="cpu", dtype=torch.float32)
    _, variables, jtok = jloader.load_vlm_checkpoint(d, dtype=jnp.float32)
    want = params_from_jax(variables)
    state = model.state_dict()
    assert state.keys() == want.keys()
    for k, v in state.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert tok.special == jtok.special and tok.eos_id == SPECIAL["<|im_end|>"]


# ---------------------------------------------------------------------------
# the grounder, both packages in f32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grounders(qwen_dir, llava_dir):
    out = {}
    for family, d in (("qwen", qwen_dir), ("llava", llava_dir)):
        tg = tuniversal.UniversalGrounder(f"{family}-tiny", model_path=str(d), device="cpu",
                                          dtype=torch.float32)
        jg = juniversal.UniversalGrounder(f"{family}-tiny",
                                          backend=JaxVLMBackend(str(d), dtype=jnp.float32))
        tg.backend.max_pixels = jg.backend.max_pixels = 56 * 56
        out[family] = (tg, jg)
    return out


@pytest.fixture
def jax_f32_cache(monkeypatch):
    """The JAX backend keeps a bf16 cache whatever its model's dtype, and
    its cache write raises on an f32 model, so its f32 model gets an f32
    cache here as the port's does (ROADMAP queue 3 item 8; the bf16 cache
    is held to the port's in ``test_torch_vlm_generate.py``)."""
    monkeypatch.setattr(jgen, "generate", functools.partial(jgen.generate, cache_dtype=jnp.float32))


def frames_of(seed, n=3, hw=(64, 80)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), np.uint8) for _ in range(n)]


def outcome(fn):
    try:
        return fn()
    except ValueError as e:       # either package's GroundingParseError
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("family", ["qwen", "llava"])
def test_grounder_strings_match_reference(grounders, family, jax_f32_cache, monkeypatch):
    tg, jg = grounders[family]
    frames = frames_of(1)
    qa = tg.inference_qa(frames, "What color?", "A) Red\nB) Blue", temperature=0.0)
    assert qa == jg.inference_qa(frames, "What color?", "A) Red\nB) Blue", temperature=0.0)
    assert qa == tg.inference_qa(frames, "What color?", "A) Red\nB) Blue", temperature=0.0)
    open_qa = tg.inference_openend_qa(frames[:1], "Describe.", temperature=0.0, max_tokens=12)
    assert open_qa == jg.inference_openend_qa(frames[:1], "Describe.", temperature=0.0, max_tokens=12)

    scene = default_scene(60.0, hw=(64, 80))
    monkeypatch.setattr(juniversal, "load_video_frames",
                        lambda path, num_frames=8: list(scene.decode_batch(
                            [int(np.floor(i * scene.meta.total_frames / num_frames))
                             for i in range(num_frames)])))
    kw = dict(temperature=0.0, max_tokens=16)
    got = outcome(lambda: tg.inference_query_grounding("mem://scene", "Where is the couch?",
                                                       "A) x\nB) y", decoder=scene, **kw))
    want = outcome(lambda: jg.inference_query_grounding("mem://scene", "Where is the couch?",
                                                        "A) x\nB) y", **kw))
    assert got == want


@pytest.mark.parametrize("family", ["qwen", "llava"])
def test_batch_equals_serial(grounders, family, jax_f32_cache):
    """Qwen2-VL batches by signature (two frame sizes: two groups, prompts
    padded to 128); LLaVA stays serial.  Both equal the reference's batch."""
    tg, jg = grounders[family]
    items = [{"frames": frames_of(10 + i, n=1, hw=(64, 80) if i < 3 else (80, 64)),
              "question": f"what {'is it ' * i}?", "options": "A) x\nB) y"} for i in range(4)]
    batched = tg.inference_qa_batch(items, temperature=0.0)
    serial = [tg.inference_qa(it["frames"], it["question"], it["options"], temperature=0.0)
              for it in items]
    assert batched == serial
    assert batched == jg.inference_qa_batch(items, temperature=0.0)


def test_backend_from_a_built_model(grounders):
    """``TorchVLMBackend.from_model`` around the loaded backend's own model
    and tokenizer answers as the loaded backend does."""
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend

    tg, _ = grounders["llava"]
    backend = TorchVLMBackend.from_model(tg.backend.model, tg.backend.tokenizer)
    assert backend.model is tg.backend.model and backend._is_llava
    adopted = tuniversal.UniversalGrounder("llava-tiny", backend=backend)
    frames = frames_of(4)
    assert (adopted.inference_qa(frames, "What color?", "A) Red\nB) Blue", temperature=0.0)
            == tg.inference_qa(frames, "What color?", "A) Red\nB) Blue", temperature=0.0))


def test_batched_failure_raises_and_item_failures_stay(grounders):
    tg, _ = grounders["qwen"]
    scene = default_scene(60.0, hw=(64, 80))
    reqs = [{"video_path": "mem://a", "question": "q", "options": "A) x", "decoder": scene},
            {"video_path": "mem://b", "question": "q", "options": "A) x", "decoder": scene},
            {"video_path": "/no/such/video.mp4", "question": "q", "options": "A) x"}]

    class Failing:
        def inference_with_frames_batch(self, *a, **k):
            raise RuntimeError("device fault")

        def inference_with_frames(self, *a, **k):
            raise AssertionError("no serial retry")

    failing = tuniversal.UniversalGrounder("fake", backend=Failing())
    with pytest.raises(RuntimeError, match="device fault"):
        failing.inference_query_grounding_batch(reqs)
    fake = tuniversal.UniversalGrounder("fake")
    out = fake.inference_query_grounding_batch(reqs)
    assert out[0] == out[1] == (["couch"], ["tv", "chair"])
    assert isinstance(out[2], ValueError)         # the file decoder cannot open it
    real = tg.inference_query_grounding_batch(reqs[:2], temperature=0.0, max_tokens=8)
    assert all(isinstance(r, (tuple, GroundingParseError)) for r in real)


def test_gpt_raises_naming_the_roadmap(monkeypatch):
    """The ``gpt`` route is ported (``grounding/openai_backend.py``): without
    ``OPENAI_API_KEY`` it raises ValueError, as the reference's does; with a
    key it builds the backend, here over a stub ``openai`` client that
    answers."""
    import sys
    import types

    reply = types.SimpleNamespace(
        choices=[types.SimpleNamespace(message=types.SimpleNamespace(content=" B "))])
    client = types.SimpleNamespace(chat=types.SimpleNamespace(
        completions=types.SimpleNamespace(create=lambda **kw: reply)))
    fake_openai = types.ModuleType("openai")
    fake_openai.OpenAI = lambda api_key=None: client
    monkeypatch.setitem(sys.modules, "openai", fake_openai)
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    with pytest.raises(ValueError, match="OPENAI_API_KEY"):
        tuniversal.UniversalGrounder("gpt-4o")
    monkeypatch.setenv("OPENAI_API_KEY", "test-key")
    g = tuniversal.UniversalGrounder("gpt-4o")
    assert g.inference_qa([np.zeros((8, 8, 3), np.uint8)], "q?", "A) x\nB) y") == "B"
    with pytest.raises(ValueError, match="LOCAL checkpoint"):
        tuniversal.UniversalGrounder("qwen2-vl", model_path="/no/such/dir")


@pytest.mark.parametrize("family", ["qwen", "llava"])
def test_saved_checkpoint_loads_in_both_packages(qwen_dir, llava_dir, family, tmp_path):
    """``save_vlm_checkpoint`` (what ``chip_smoke.py`` writes on the card,
    which has no ``safetensors``) reads back as the same model in the port
    and, through the ``safetensors`` package, in the reference."""
    model, _ = tloader.load_vlm_checkpoint(str(qwen_dir if family == "qwen" else llava_dir),
                                           device="cpu", dtype=torch.float32)
    tloader.save_vlm_checkpoint(model, str(tmp_path))
    write_tokenizer(tmp_path)
    back, _ = tloader.load_vlm_checkpoint(str(tmp_path), device="cpu", dtype=torch.float32)
    assert back.cfg == model.cfg
    _, variables, _ = jloader.load_vlm_checkpoint(str(tmp_path), dtype=jnp.float32)
    want = params_from_jax(variables)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
        np.testing.assert_array_equal(want[k].numpy(), v.numpy(), err_msg=k)
