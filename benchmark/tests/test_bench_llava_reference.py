"""The plain LLaVA-OneVision reference and the request it works out again,
against the program's CPU path at a tiny size in float32: the same token
ids, the same frames to within a rounding step, the same logits."""

from __future__ import annotations


import numpy as np
import pytest
import torch

from benchmark.reference import llava as ref
from benchmark.reference import vlm_inputs
from benchmark.video import SeededVideo
from benchmark.weights import seeded_weights

CFG = {
    "image_token_index": 151646, "video_token_index": 151647, "vision_feature_layer": -1,
    "vision_feature_select_strategy": "full", "torch_dtype": "float32",
    "vision_config": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 2,
                      "num_hidden_layers": 2, "image_size": 56, "patch_size": 14,
                      "layer_norm_eps": 1e-6},
    "text_config": {"hidden_size": 128, "intermediate_size": 256, "num_attention_heads": 4,
                    "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 152064,
                    "rms_norm_eps": 1e-6, "rope_theta": 1e6, "hidden_act": "silu",
                    "tie_word_embeddings": False},
}


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    from benchmark.drivers.pipeline import llava_config
    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionModel
    from tstar_tpu_torch.models.qwen_tokenizer import QwenTokenizer, write_byte_vocab

    model = LlavaOnevisionModel(llava_config(CFG))
    shapes = [(k, tuple(p.shape)) for k, p in model.state_dict().items()]
    weights = seeded_weights(shapes, 3, "cpu", torch.float32)
    model.load_state_dict(weights)
    vocab = tmp_path_factory.mktemp("vocab")
    write_byte_vocab(str(vocab))
    return model.eval(), weights, QwenTokenizer.from_dir(str(vocab))


@pytest.mark.parametrize("kind", ["grounding", "qa"])
def test_request_and_logits_are_the_programs(program, kind):
    from tstar_tpu_torch.grounding.prompts import build_grounding_prompt, build_qa_prompt
    from tstar_tpu_torch.models.llava_onevision import prepare_llava_inputs

    model, weights, tok = program
    video = SeededVideo(5, 60, 10.0, (72, 128), 20)
    frames = list(video.decode_batch([0, 75, 150, 225, 300, 375, 450, 525]))
    question, options = "What color is the couch?", "A) red\nB) blue\nC) green\nD) gold"
    if kind == "grounding":
        prompt, want = (vlm_inputs.grounding_prompt(question, options, 8),
                        build_grounding_prompt(question, options, 8))
    else:
        prompt = vlm_inputs.qa_prompt(question, options, 8)
        want = build_qa_prompt(question, options, 8)
    assert prompt == want
    inp = prepare_llava_inputs(tok, want, frames, model.cfg)
    ids = vlm_inputs.request_ids(prompt, 8, vlm_inputs.tokens_per_frame(CFG))
    assert ids == inp["input_ids"][0].tolist()
    pixels = vlm_inputs.frame_pixels(frames, 56)
    assert (pixels - torch.from_numpy(inp["image_patches"])).abs().max() <= 2.0 / 255 + 1e-6

    served = [7, 151645]
    seq = torch.tensor(ids + served[:-1])
    positions = torch.arange(len(ids) - 1, len(seq))
    with torch.no_grad():
        video_emb = ref.video_embeddings(torch.from_numpy(inp["image_patches"]), weights, CFG)
        got = ref.logits_at(seq, video_emb, CFG["video_token_index"], positions, weights, CFG)
        pos = torch.arange(len(seq))[None].expand(3, 1, -1)
        want_logits = model(seq[None], pos, video_frames=torch.from_numpy(inp["image_patches"]))
    torch.testing.assert_close(got, want_logits[0, positions], atol=2e-4, rtol=1e-4)


def test_served_tokens_end_at_the_first_stop():
    assert vlm_inputs.served([5, 6, 151645, 151643, 151643]) == [5, 6, 151645]
    assert vlm_inputs.served([1, 2, 3]) == [1, 2, 3]
    assert vlm_inputs.encode("<|im_start|>hi é") == [151644, 104, 105, 32, 195, 169]


def test_seeded_video_is_the_same_each_time():
    a = SeededVideo(11, 30, 10.0, (36, 64), 20)
    b = SeededVideo(11, 30, 10.0, (36, 64), 20)
    np.testing.assert_array_equal(a.decode_batch([0, 155, 299]), b.decode_batch([0, 155, 299]))
    np.testing.assert_array_equal(a.decode_sweep(1.0, 30, (8, 16))[3],
                                  a.decode_batch([30], (8, 16))[0])
    assert a.meta.total_frames == 300 and a.meta.duration == 30.0
    assert not np.array_equal(a.decode_batch([0]), SeededVideo(12, 30, 10.0, (36, 64),
                                                                20).decode_batch([0]))
