"""The decode step's kernels (``kernels/decode.py``) on the CPU: their plain
versions, chained as the fused route chains them (each layer's output left
as (residual, delta) for the next norm to add), equal the decoder layer's
single-token step as the port computed it before the route existed (its
plain torch ops, copied below) bit for bit, in bf16 and f32, at head_dim 128
with GQA groups of 7 over a partly masked cache; the route is chosen by
device, shape and dtype; ``GenerateStats.step_launches`` is empty on the
CPU.  The kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda_vlm.py``).
"""

import numpy as np
import pytest
import torch

from tstar_tpu_torch.kernels import decode
from tstar_tpu_torch.models import generate as tgen
from tstar_tpu_torch.models.qwen2vl import (
    Qwen2DecoderLayer, Qwen2VLTextConfig, RMSNorm, build_mrope_position_ids, init_random_,
    mrope_cos_sin,
)

NEG = torch.finfo(torch.float32).min


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def parent_step(layer, x, cos, sin, bias, cache, index):
    """``Qwen2DecoderLayer.forward`` as the port ran it before the fused
    route, op for op: -> the layer's output, the cache written in place."""
    c = layer.cfg
    hd, nh, nkv = c.head_dim, layer.num_heads, layer.num_kv_heads
    b, s = x.shape[:2]

    def rms(norm, v):
        vf = v.float()
        n = vf * torch.rsqrt((vf * vf).mean(dim=-1, keepdim=True) + norm.eps)
        return (n * norm.scale.float()).to(norm.scale.dtype)

    def dense(d, v):
        y = torch.matmul(v, d.kernel)
        return y if d.bias is None else y + d.bias

    def rotate(v):
        return torch.cat([-v[..., hd // 2:], v[..., :hd // 2]], dim=-1)

    h = rms(layer.input_layernorm, x)
    q = dense(layer.q_proj, h).reshape(b, s, nh, hd)
    k = dense(layer.k_proj, h).reshape(b, s, nkv, hd)
    v = dense(layer.v_proj, h).reshape(b, s, nkv, hd)
    qf, kf = q.float(), k.float()
    q, k = (qf * cos + rotate(qf) * sin).to(q.dtype), (kf * cos + rotate(kf) * sin).to(k.dtype)
    k_all, v_all = cache
    slots = index + torch.arange(s)
    k_all.index_copy_(1, slots, k.to(k_all.dtype))
    v_all.index_copy_(1, slots, v.to(v_all.dtype))
    g = nh // nkv
    qg = (q * hd ** -0.5).reshape(b, s, nkv, g, hd).permute(0, 2, 3, 1, 4)
    logits = torch.matmul(qg.reshape(b, nkv, g * s, hd), k_all.to(q.dtype).permute(0, 2, 3, 1))
    logits = logits.reshape(b, nkv, g, s, -1) + bias[:, :, None].to(q.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype).reshape(b, nkv, g * s, -1)
    vv = v_all.permute(0, 2, 1, 3)
    ctype = torch.promote_types(probs.dtype, vv.dtype)
    out = torch.matmul(probs.to(ctype), vv.to(ctype)).reshape(b, nkv, g, s, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, nh * hd)
    x = x + dense(layer.o_proj, out.to(x.dtype))
    h = rms(layer.post_attention_layernorm, x)
    gate, up = dense(layer.gate_proj, h), dense(layer.up_proj, h)
    return x + dense(layer.down_proj, torch.nn.functional.silu(gate) * up)


def text_config(heads, kv_heads):
    return Qwen2VLTextConfig(vocab_size=64, hidden_size=heads * 128, num_layers=2,
                             num_heads=heads, num_kv_heads=kv_heads, intermediate_size=256,
                             rope_theta=10000.0, mrope_section=(16, 24, 24))


def seeded_layers(cfg, dtype, seed):
    """Two layers and a final norm with random weights, biases and scales."""
    gen = torch.Generator().manual_seed(seed)
    mods = [Qwen2DecoderLayer(cfg) for _ in range(2)] + [RMSNorm(cfg.hidden_size)]
    with torch.no_grad():
        for m in mods:
            init_random_(m, gen)
            for name, p in m.named_parameters():
                if name.endswith("bias"):
                    p.normal_(0.0, 0.5, generator=gen)
                elif name.endswith("scale"):
                    p.uniform_(0.5, 1.5, generator=gen)
    return [m.to(dtype) for m in mods]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("heads", [(7, 1), (14, 2)], ids=["7of1", "14of2"])
def test_fused_chain_equals_the_parent_step(dtype, heads):
    """Two layers and the final norm, one token (B = 2) at slot 30 of 48:
    prompt padding (slots 12-15) and every slot after 30 masked, the cache
    holding other values there.  The wrappers on CPU tensors run their plain
    versions, in the fused route's order."""
    cfg = text_config(*heads)
    *layers, final = seeded_layers(cfg, dtype, seed=heads[0])
    rng = np.random.default_rng(1)
    b, m, index = 2, 48, 30
    x = torch.as_tensor(rng.normal(0, 1, (b, 1, cfg.hidden_size)), dtype=dtype)
    caches = [tuple(torch.as_tensor(rng.normal(0, 1, (b, m, heads[1], 128)), dtype=dtype)
                    for _ in range(2)) for _ in layers]
    valid = np.ones((b, m), bool)
    valid[:, 12:16] = False
    valid[:, index + 1:] = False
    bias = torch.where(torch.as_tensor(valid)[:, None, None, :], 0.0, NEG)
    pos = torch.as_tensor(np.stack([[[index]] * b] * 3) + np.arange(3)[:, None, None])
    cos, sin = mrope_cos_sin(pos, 128, cfg.mrope_section, cfg.rope_theta)

    want_caches = [tuple(t.clone() for t in c) for c in caches]
    want = x
    for layer, cache in zip(layers, want_caches):
        want = parent_step(layer, want, cos, sin, bias, cache, index)
    want = final(want)

    res, delta = x, None
    for layer, (k_all, v_all) in zip(layers, caches):
        res, h = decode.add_rms_norm(res, delta, layer.input_layernorm.scale,
                                     layer.input_layernorm.eps)
        qp, kp, vp = layer.q_proj, layer.k_proj, layer.v_proj
        out = decode.decode_attention(qp.product(h), kp.product(h), vp.product(h), qp.bias,
                                      kp.bias, vp.bias, cos, sin, bias, (k_all, v_all),
                                      torch.tensor(index), *heads)
        res, h = decode.add_rms_norm(res, layer.o_proj(out), layer.post_attention_layernorm.scale,
                                     layer.post_attention_layernorm.eps)
        delta = layer.down_proj(decode.silu_mul(layer.gate_proj(h), layer.up_proj(h)))
    got = decode.add_rms_norm(res, delta, final.scale, final.eps)[1]
    assert torch.equal(got, want)
    for (k_got, v_got), (k_want, v_want) in zip(caches, want_caches):
        assert torch.equal(k_got, k_want) and torch.equal(v_got, v_want)
    # the layers' own steps on their plain route are the same chain
    res, delta = x, None
    for layer, cache in zip(layers, want_caches):
        res, delta = layer.step(res, delta, cos, sin, bias, cache, index)
    assert torch.equal(final(res + delta), want)


class _OnCard:
    """A tensor's metadata as a CUDA tensor shows it: the route reads only
    the device, dtype and shape."""

    is_cuda = True

    def __init__(self, t):
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return len(self.shape)


ROUTES = {
    # case: (on the card, tokens, dtype, head_dim, fused)
    "card": (True, 1, torch.bfloat16, 128, True),
    "cpu": (False, 1, torch.bfloat16, 128, False),
    "prefill": (True, 5, torch.bfloat16, 128, False),
    "f32": (True, 1, torch.float32, 128, False),
    "head_dim_64": (True, 1, torch.bfloat16, 64, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_is_chosen_by_device_shape_and_dtype(case):
    on_card, s, dtype, hd, fused = ROUTES[case]
    heads, kv = 28, 4
    x = torch.zeros(1, s, heads * hd, dtype=dtype)
    cache = tuple(torch.zeros(1, 256, kv, hd, dtype=dtype) for _ in range(2))
    args = (cache, heads, kv, hd, 18944)
    assert decode.fused_decode_supported(_OnCard(x) if on_card else x, *args) is fused
    if fused:   # the same step without a cache, or with a cache too long, is plain
        assert not decode.fused_decode_supported(_OnCard(x), None, *args[1:])
        long = (torch.zeros(1, decode.MAX_SLOTS + 1, kv, hd, dtype=dtype),) * 2
        assert not decode.fused_decode_supported(_OnCard(x), long, *args[1:])


@pytest.mark.parametrize("graphs", [None, False], ids=["default", "eager"])
def test_fused_layers_reads_zero_on_the_cpu(graphs):
    """A bf16 model at head_dim 128 decodes on the CPU: every step takes the
    plain route, and no kernel launch is counted."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models.qwen2vl import Qwen2VLConfig, Qwen2VLModel, Qwen2VLVisionConfig

    cfg = Qwen2VLConfig(vision=Qwen2VLVisionConfig(depth=1, embed_dim=16, num_heads=2,
                                                   mlp_ratio=2.0, hidden_size=896),
                        text=text_config(7, 1))
    model = init_random_(Qwen2VLModel(cfg), torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16).eval()
    ids = np.random.default_rng(0).integers(1, 60, size=(1, 6))
    pos = build_mrope_position_ids(ids[0], -1, [], 2)[:, None]
    stats = tgen.GenerateStats(step_launches={"decode_attention": -1})
    reset_launch_counts()
    with torch.no_grad():
        out = tgen.generate(model, ids, np.array([6]), pos, max_new_tokens=4,
                            eos_token_ids=[63], graphs=graphs, stats=stats)
    assert out.shape == (1, 4) and stats.decode_steps >= 1
    assert stats.step_launches == {}
    assert not any(launch_counts().values())
