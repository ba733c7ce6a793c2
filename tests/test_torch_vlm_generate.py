"""The port's ``generate`` against the JAX reference's on tiny models of both
families, in f32 on the CPU (the eager form of the decode loop; the CUDA
graph form is held to the eager one in ``tests/test_torch_cuda_vlm.py`` and
``chip_smoke.py`` phase 9): greedy tokens equal the reference's, text-only
and multimodal, for one prompt and a right-padded batch; an end token
freezes a sequence; ``max_new_tokens = 1`` returns after the prefill;
sampling gives valid tokens, the same ones for the same generator state,
and shares one bucket across generators; a model keeps a bounded number of
buckets.  In bf16, with each package's default bf16 cache, the prefill and
a decode step agree with the reference's to bf16 rounding.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu.models import generate as jgen
from tstar_tpu.models import qwen2vl as jqwen
from tstar_tpu_torch.models import generate as tgen
from tests.test_torch_vlm_models import IMG_TOK, VID_TOK, llava, qwen  # noqa: F401


def both(jmodel, variables, tmodel, ids, lens, pos, max_new, eos, patches=None, grid=None):
    want = np.asarray(jgen.generate(
        jmodel, variables, ids, lens, pos, max_new_tokens=max_new, eos_token_ids=eos,
        temperature=0.0, image_patches=None if patches is None else jnp.asarray(patches),
        image_grid_hw=grid, cache_dtype=jnp.float32,
    ))
    stats = tgen.GenerateStats()
    got = tgen.generate(tmodel, ids, lens, pos, max_new_tokens=max_new, eos_token_ids=eos,
                        temperature=0.0, image_patches=patches, image_grid_hw=grid, stats=stats)
    assert got.dtype == torch.int64 and got.shape == (ids.shape[0], max_new)
    return got.numpy(), want, stats


def test_text_only_greedy_matches_reference(qwen):
    _, jmodel, variables, tmodel = qwen
    ids = np.random.default_rng(0).integers(1, 150, size=(1, 7)).astype(np.int32)
    pos = jqwen.build_mrope_position_ids(ids[0], IMG_TOK, [], 2)[:, None]
    got, want, stats = both(jmodel, variables, tmodel, ids, np.array([7]), pos, 9, [199])
    np.testing.assert_array_equal(got, want)
    # eager loop on the CPU: no graph; one flag read a step after the first
    assert stats.captures == 0 and stats.replays == 0
    assert stats.decode_steps == 8 and stats.flag_reads == 7


def test_multimodal_greedy_matches_reference(qwen):
    _, jmodel, variables, tmodel = qwen
    rng = np.random.default_rng(1)
    patches = rng.normal(size=(1, 16, 12)).astype(np.float32)
    ids = np.array([[5, 150] + [IMG_TOK] * 4 + [7, 9]], np.int32)
    pos = jqwen.build_mrope_position_ids(ids[0], IMG_TOK, [(1, 4, 4)], 2)[:, None]
    got, want, _ = both(jmodel, variables, tmodel, ids, np.array([8]), pos, 6, [199],
                        patches, (4, 4))
    np.testing.assert_array_equal(got, want)


def test_llava_video_greedy_matches_reference(llava):
    jcfg, jmodel, variables, tmodel = llava
    frames = np.random.default_rng(2).normal(size=(2, 8, 8, 3)).astype(np.float32)
    n = 2 * jcfg.tokens_per_frame + 1
    ids = np.array([[5, 6] + [VID_TOK] * n + [7, 9]], np.int32)
    pos = jqwen.build_mrope_position_ids(ids[0], -1, [], 2)[:, None]
    got, want, _ = both(jmodel, variables, tmodel, ids, np.array([ids.shape[1]]), pos, 7, [199],
                        frames)
    np.testing.assert_array_equal(got, want)


def test_padded_batch_greedy_matches_reference(qwen):
    """Two prompts of 5 and 9 tokens right-padded to 12: the padded prompt
    slots stay masked through the decode."""
    _, jmodel, variables, tmodel = qwen
    rng = np.random.default_rng(3)
    lens = np.array([5, 9], np.int32)
    ids = np.zeros((2, 12), np.int32)
    pos = np.zeros((3, 2, 12), np.int32)
    for r, n in enumerate(lens):
        ids[r, :n] = rng.integers(1, 150, size=n)
        pos[:, r, :n] = jqwen.build_mrope_position_ids(ids[r, :n], IMG_TOK, [], 2)
    got, want, _ = both(jmodel, variables, tmodel, ids, lens, pos, 6, [199])
    np.testing.assert_array_equal(got, want)


def test_eos_freezes_sequence(qwen):
    _, jmodel, variables, tmodel = qwen
    ids = np.array([[5, 6, 7]], np.int32)
    pos = jqwen.build_mrope_position_ids(ids[0], IMG_TOK, [], 2)[:, None]
    eos = list(range(200))        # every token ends the sequence
    got, want, stats = both(jmodel, variables, tmodel, ids, np.array([3]), pos, 8, eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 1:] == 0).all()     # frozen to eos[0] after the first token
    # the loop stops after the first flag it reads (one step enqueued past it)
    assert stats.flag_reads == 1 and stats.decode_steps == 2


def test_one_new_token_returns_after_prefill(qwen):
    _, jmodel, variables, tmodel = qwen
    ids = np.array([[5, 6, 7, 9]], np.int32)
    pos = jqwen.build_mrope_position_ids(ids[0], IMG_TOK, [], 2)[:, None]
    got, want, stats = both(jmodel, variables, tmodel, ids, np.array([4]), pos, 1, [199])
    np.testing.assert_array_equal(got, want)
    assert stats.decode_steps == 0 and stats.flag_reads == 0


def test_sampling_valid_and_deterministic(qwen):
    _, _, _, tmodel = qwen
    ids = np.array([[5, 6, 7, 9]], np.int32)
    pos = jqwen.build_mrope_position_ids(ids[0], IMG_TOK, [], 2)[:, None]
    outs = [
        tgen.generate(tmodel, ids, np.array([4]), pos, max_new_tokens=12, eos_token_ids=[199],
                      temperature=0.8, generator=torch.Generator().manual_seed(123)).numpy()
        for _ in range(2)
    ]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (1, 12) and (outs[0] >= 0).all() and (outs[0] < 200).all()
    other = tgen.generate(tmodel, ids, np.array([4]), pos, max_new_tokens=12, eos_token_ids=[199],
                          temperature=0.8, generator=torch.Generator().manual_seed(7)).numpy()
    assert not np.array_equal(other, outs[0])


def test_sampling_buckets_are_shared_and_bounded(qwen):
    """Sampling draws from the bucket's own generator with the caller's state
    copied in and back: calls with fresh generators (or none) share one
    bucket, and the caller's generator leaves the call advanced.  A model
    keeps at most ``MAX_BUCKETS`` buckets."""
    _, _, _, tmodel = qwen
    ids = np.array([[5, 6, 7, 9]], np.int32)
    pos = jqwen.build_mrope_position_ids(ids[0], IMG_TOK, [], 2)[:, None]
    kw = dict(max_new_tokens=12, eos_token_ids=[199], temperature=0.8)
    tmodel.__dict__.pop("_decode_buckets", None)
    outs = [tgen.generate(tmodel, ids, np.array([4]), pos, **kw).numpy() for _ in range(3)]
    assert len(tmodel._decode_buckets) == 1
    np.testing.assert_array_equal(outs[0], outs[1])
    gen = torch.Generator().manual_seed(0)
    first = tgen.generate(tmodel, ids, np.array([4]), pos, generator=gen, **kw).numpy()
    np.testing.assert_array_equal(first, outs[0])      # the default generator is seed 0
    second = tgen.generate(tmodel, ids, np.array([4]), pos, generator=gen, **kw).numpy()
    assert not np.array_equal(first, second)           # gen went on from where the loop left it
    assert len(tmodel._decode_buckets) == 1
    for n in range(1, 8):                              # seven more max_len buckets
        pad = np.zeros((1, 128 * n), np.int32)
        pad[:, :4] = ids
        ppos = np.zeros((3, 1, 128 * n), np.int32)
        ppos[:, :, :4] = pos
        tgen.generate(tmodel, pad, np.array([4]), ppos, max_new_tokens=2, eos_token_ids=[199])
    assert len(tmodel._decode_buckets) == tgen.MAX_BUCKETS
    assert [k[1] for k in tmodel._decode_buckets] == [128 * n for n in range(5, 9)]


def test_bf16_cache_matches_reference(qwen):
    """The reference keeps a bf16 KV cache whatever its model's dtype
    (``cache_dtype=jnp.bfloat16``): with its f32 model the cache write
    raises, which is why the port's cache takes the model's dtype (ROADMAP
    queue 3 item 8) and the f32 tests above pass ``cache_dtype=f32`` to
    the reference.  With both models in bf16 each package keeps its default
    bf16 cache: the prefill's logits and cache, and one decode step from
    that cache, agree to bf16 rounding, |port - reference| <= 2^-5 *
    max(1, max|reference|): 8 units of bf16 rounding (2^-8) at the largest
    value, as both packages round after every op of two layers."""
    jcfg, jmodel, variables, tmodel = qwen
    rng = np.random.default_rng(3)
    lens = np.array([5, 9], np.int32)
    ids = np.zeros((2, 12), np.int32)
    pos = np.zeros((3, 2, 12), np.int32)
    for r, n in enumerate(lens):
        ids[r, :n] = rng.integers(1, 150, size=n)
        pos[:, r, :n] = jqwen.build_mrope_position_ids(ids[r, :n], IMG_TOK, [], 2)
    with pytest.raises(TypeError, match="same dtypes"):
        jgen.generate(jmodel, variables, ids, lens, pos, max_new_tokens=3, eos_token_ids=[199])

    jm = jqwen.Qwen2VLModel(jcfg, dtype=jnp.bfloat16)
    jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), variables)
    tm = copy.deepcopy(tmodel).to(torch.bfloat16)
    tm.__dict__.pop("_decode_buckets", None)

    def close(got, want):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2.0 ** -5 * max(1.0, np.abs(want).max())

    max_len = 128
    jl, jc = jgen.prefill(jm, jvars, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(pos),
                          None, None, max_len)
    tl, tc = tgen.prefill(tm, torch.from_numpy(ids).long(), torch.from_numpy(lens).long(),
                          torch.from_numpy(pos).long(), None, None, max_len)
    assert tc[0][0].dtype == torch.bfloat16 and jc[0][0].dtype == jnp.bfloat16
    close(tl, jl)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        close(tk, jk)
        close(tv, jv)
    token, index = np.array([17, 42]), 12
    next_pos = pos.max(axis=(0, 2)) + 1
    slots = np.arange(max_len)[None]
    key_valid = (slots < lens[:, None]) | (slots >= ids.shape[1])
    jd, _ = jgen.decode_step(jm, jvars, jnp.asarray(token, jnp.int32), jnp.asarray(index),
                             jnp.asarray(next_pos), jnp.asarray(key_valid), jc)
    td = tgen.decode_step(tm, torch.from_numpy(token), torch.tensor(index),
                          torch.from_numpy(next_pos).long(), torch.from_numpy(key_valid), tc)
    close(td, jd)


def test_graphs_need_a_cuda_device(qwen):
    _, _, _, tmodel = qwen
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        tgen.generate(tmodel, np.array([[5, 6]]), np.array([2]), np.zeros((3, 1, 2)),
                      max_new_tokens=3, eos_token_ids=[199], graphs=True)


def test_output_survives_the_next_request(qwen):
    """The decode buffers of a bucket serve every request of it: what a
    request returned stays as it was."""
    _, _, _, tmodel = qwen
    ids = np.array([[5, 6, 7, 9]], np.int32)
    pos = jqwen.build_mrope_position_ids(ids[0], IMG_TOK, [], 2)[:, None]
    first = tgen.generate(tmodel, ids, np.array([4]), pos, max_new_tokens=6, eos_token_ids=[199])
    kept = first.clone()
    ids2 = np.array([[11, 12, 13, 14]], np.int32)
    second = tgen.generate(tmodel, ids2, np.array([4]), pos, max_new_tokens=6, eos_token_ids=[199])
    assert torch.equal(first, kept) and not torch.equal(first, second)
