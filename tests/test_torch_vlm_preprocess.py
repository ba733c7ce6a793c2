"""The port's VLM input processing: the bicubic resize against
``cv2.resize(..., INTER_CUBIC)`` on uint8 frames, and ``smart_resize``, the
patch layout, the chat prompt and the LLaVA video inputs against the JAX
reference's.

The resize is uint8-equal to cv2 on all but a few values, which are 1 off:
the tolerance is at most 1 off on at most 1e-4 of the values (measured
~1e-5: float32 sums in another order land on the other side of a .5).
"""

import json

import cv2
import numpy as np
import pytest

from tstar_tpu.models import llava_onevision as jllava
from tstar_tpu.models import qwen2vl_processor as jproc
from tstar_tpu.models import qwen_tokenizer as jtok
from tstar_tpu_torch.models import llava_onevision as tllava
from tstar_tpu_torch.models import qwen2vl_processor as tproc
from tstar_tpu_torch.models import qwen_tokenizer as ttok
from tests.test_torch_vlm_models import llava_cfgs, qwen_cfgs

SIZES = [((360, 640), (384, 384)), ((360, 640), (448, 252)), ((32, 48), (8, 8)),
         ((100, 100), (384, 384)), ((480, 854), (336, 588)), ((7, 5), (13, 29)),
         ((64, 80), (56, 56)), ((64, 64), (64, 64))]


@pytest.mark.parametrize("src_hw,out_hw", SIZES)
def test_resize_cubic_matches_cv2(src_hw, out_hw):
    rng = np.random.default_rng(src_hw[0] * 7 + out_hw[1])
    noise = rng.integers(0, 256, (*src_hw, 3), np.uint8)
    yy, xx = np.mgrid[:src_hw[0], :src_hw[1]]
    smooth = np.stack([(127 + 120 * np.sin(xx / 7 + c) * np.cos(yy / 5)).astype(np.uint8)
                       for c in range(3)], -1)
    for img in (noise, smooth):
        got = tproc.resize_cubic(img, out_hw)
        want = cv2.resize(img, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_CUBIC)
        assert got.dtype == np.uint8 and got.shape == want.shape
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, ((diff > 0).mean(), diff.max())


@pytest.mark.parametrize("hw", [(360, 640), (64, 80), (1080, 1920), (30, 4000), (28, 28)])
def test_smart_resize_matches_reference(hw):
    for kw in ({}, {"max_pixels": 448 * 448}, {"max_pixels": 56 * 56}):
        assert tproc.smart_resize(*hw, 28, **kw) == jproc.smart_resize(*hw, 28, **kw)


def test_patches_match_reference():
    """The same frames through both processors: equal grids and patch rows
    (the resize agrees with cv2 on these frames)."""
    _, tcfg = qwen_cfgs()
    from tstar_tpu.models.qwen2vl import Qwen2VLVisionConfig as J

    jv = J(**{f: getattr(tcfg.vision, f) for f in tcfg.vision.__dataclass_fields__})
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (24, 40, 3), np.uint8) for _ in range(2)]
    got, ghw = tproc.preprocess_frames(frames, tcfg.vision, max_pixels=16 * 16)
    want, whw = jproc.preprocess_frames(frames, jv, max_pixels=16 * 16)
    assert ghw == whw
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    b2u = jtok._bytes_to_unicode()
    (d / "vocab.json").write_text(json.dumps({b2u[b]: b for b in range(256)}))
    (d / "merges.txt").write_text("#version: 0.2\n")
    return ttok.QwenTokenizer.from_dir(str(d)), jtok.QwenTokenizer.from_dir(str(d))


def test_prepare_vlm_inputs_matches_reference(tokenizers):
    tt, jt = tokenizers
    _, tcfg = qwen_cfgs()
    from tstar_tpu.models.qwen2vl import Qwen2VLVisionConfig as J

    jv = J(**{f: getattr(tcfg.vision, f) for f in tcfg.vision.__dataclass_fields__})
    frames = [np.random.default_rng(5).integers(0, 256, (24, 40, 3), np.uint8)] * 2
    for query in ("Q: <image> and <image> what?", "no tags", "<image><image><image> more tags"):
        got = tproc.prepare_vlm_inputs(tt, query, frames, tcfg.vision, 16 * 16, image_token_id=151655)
        want = jproc.prepare_vlm_inputs(jt, query, frames, jv, 16 * 16, image_token_id=151655)
        for k in ("input_ids", "prompt_lens", "position_ids", "image_patches"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["image_grid_hw"] == want["image_grid_hw"]


def test_prepare_llava_inputs_matches_reference(tokenizers):
    tt, jt = tokenizers
    jcfg, tcfg = llava_cfgs()
    frames = [np.random.default_rng(6).integers(0, 256, (30, 50, 3), np.uint8) for _ in range(3)]
    for fr in (frames, []):
        got = tllava.prepare_llava_inputs(tt, "Q: <image> what?", fr, tcfg)
        want = jllava.prepare_llava_inputs(jt, "Q: <image> what?", fr, jcfg)
        for k in ("input_ids", "prompt_lens", "position_ids"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if fr:
            np.testing.assert_array_equal(got["image_patches"], want["image_patches"])
        else:
            assert got["image_patches"] is None and want["image_patches"] is None
