"""The port's mesh and tensor-parallel rules (``tstar_tpu_torch/parallel``)
against the JAX package's, on the CPU, without a process group.

  * The mesh layout: rank -> (data, model) equals the device grid of the
    reference's ``make_mesh`` over conftest's 8 CPU devices.
  * The rule table: every parameter of the tiny OWL-ViT, Qwen2-VL and
    LLaVA-OneVision of ``__graft_entry__.py`` is sharded by
    ``shard_module`` on the axis ``tstar_tpu.parallel.shardings._rule_for``
    gives its flax path (the fused q|k|v weights section by section, each
    section as its q/k/v kernel); the one deliberate difference is a
    column-parallel layer's bias, sliced with its columns where the
    reference keeps it whole for GSPMD to slice.
  * Gathering the shards of every rank gives back the original weights
    exactly; a model degree that divides no heads raises, naming the layer.

A mesh object here is built by hand (``fake_mesh``): slicing needs the
model group's size and this rank's index, not a process group.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_owlvit import tiny_pair
from tests.torch_mesh_ranks import QWEN_TEXT, QWEN_VISION
from tests.test_torch_vlm_models import llava_cfgs
from tstar_tpu.models import llava_onevision as jllava
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models import qwen2vl as jqwen
from tstar_tpu.parallel.mesh import make_mesh as jmake_mesh
from tstar_tpu.parallel.shardings import _rule_for as jrule
from tstar_tpu_torch.models import llava_onevision as tllava
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import qwen2vl as tqwen
from tstar_tpu_torch.parallel import mesh as tmesh
from tstar_tpu_torch.models.tensor_parallel import tensor_parallel
from tstar_tpu_torch.parallel.shardings import shard_module



def qwen_pair():
    j = jqwen.Qwen2VLConfig(vision=jqwen.Qwen2VLVisionConfig(**QWEN_VISION),
                            text=jqwen.Qwen2VLTextConfig(**QWEN_TEXT), image_token_id=251)
    t = tqwen.Qwen2VLConfig(vision=tqwen.Qwen2VLVisionConfig(**QWEN_VISION),
                            text=tqwen.Qwen2VLTextConfig(**QWEN_TEXT), image_token_id=251)
    return j, t


def fake_mesh(model: int, index: int) -> tmesh.Mesh:
    """Rank ``index`` of a (1, model) mesh, without a process group."""
    return tmesh.Mesh(data=1, model=model, rank=index, device=torch.device("cpu"),
                      backend="gloo", device_mesh=None)


def _jax_shapes(family):
    """(flax variable shapes, port model) of one tiny family."""
    if family == "owlvit":
        jm = jow.OwlViTDetector(tiny_pair(jow), dtype=jnp.float32)
        args = (jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32))
        port = lambda: tow.init_params(tow.OwlViTDetector(tiny_pair(tow)), 0)  # noqa: E731
    elif family == "qwen2vl":
        jcfg, tcfg = qwen_pair()
        jm = jqwen.Qwen2VLModel(jcfg, dtype=jnp.float32)
        args = (jnp.zeros((1, 6), jnp.int32), jnp.zeros((3, 1, 6), jnp.int32), None,
                jnp.zeros((1, 16, 12)), (4, 4))
        port = lambda: tqwen.random_model(tqwen.Qwen2VLModel, tcfg, torch.float32, "cpu")  # noqa: E731
    else:
        jcfg, tcfg = llava_cfgs()
        jm = jllava.LlavaOnevisionModel(jcfg, dtype=jnp.float32)
        n = 2 * jcfg.tokens_per_frame + 1
        args = (jnp.zeros((1, n + 3), jnp.int32), jnp.zeros((3, 1, n + 3), jnp.int32), None,
                jnp.zeros((2, 8, 8, 3)))
        port = lambda: tqwen.random_model(tllava.LlavaOnevisionModel, tcfg, torch.float32,  # noqa: E731
                                          "cpu")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args))
    return shapes, port


def _port_name(path: str) -> str:
    """A flax path ('params/a/layers_0/b/kernel') -> the port's parameter
    name, before q/k/v fusion."""
    name = path[len("params/"):].replace("/", ".")
    return re.sub(r"\b(layers|blocks)_(\d+)\b", r"\1.\2", name)


def _sharded_axis(full: torch.Tensor, shard: torch.Tensor):
    diff = [a for a in range(full.ndim) if full.shape[a] != shard.shape[a]]
    assert len(diff) <= 1
    return diff[0] if diff else None


FAMILIES = ["owlvit", "qwen2vl", "llava"]


@pytest.mark.parametrize("data, model", [(4, 2), (2, 4), (8, 1)])
def test_layout_matches_reference_mesh(data, model):
    """Each rank's (data, model) coordinates (the groups of
    ``init_device_mesh``, checked against these in ``test_torch_parallel``)."""
    jm = jmake_mesh(data=data, model=model, devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in range(8):
        m = tmesh.Mesh(data=data, model=model, rank=rank, device=torch.device("cpu"),
                       backend="gloo", device_mesh=None)
        assert ids[m.data_index, m.model_index] == rank
    assert jm.shape == dict(tmesh.Mesh(data, model, 0, torch.device("cpu"), "gloo", None).shape)


@pytest.mark.parametrize("family", FAMILIES)
def test_rules_match_reference(family):
    """Every flax leaf: the axis the port shards it on is the reference
    rule's; fused q|k|v sections each follow their q/k/v kernel's rule."""
    shapes, port = _jax_shapes(family)
    full = port()
    sharded = shard_module(port(), fake_mesh(2, 1))
    fp, sp = dict(full.named_parameters()), dict(sharded.named_parameters())
    seen = set()
    column_biases = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        p = "/".join(str(k.key) for k in path)
        want = jrule(p, leaf.ndim)
        want_axis = {(): None, (None, "model"): 1, ("model", None): 0}[tuple(want)]
        name = _port_name(p)
        m = re.match(r"(.*self_attn)\.([qkv])_proj\.(kernel|bias)$", name)
        if m:                                   # a section of the fused q|k|v
            name = f"{m.group(1)}.qkv_{m.group(3)}"
            sec = "qkv".index(m.group(2))
            f, s = (t.split(t.shape[-1] // 3, dim=-1)[sec] for t in (fp[name], sp[name]))
        else:
            f, s = fp[name], sp[name]
        seen.add(name)
        got = _sharded_axis(f, s)
        if leaf.ndim == 1 and got == 0:
            # the deliberate difference: a column-parallel layer's bias is
            # sliced with its columns (the reference's GSPMD slices it)
            kernel = name.rsplit("_bias" if name.endswith("qkv_bias") else ".bias", 1)[0]
            kernel += "_kernel" if name.endswith("qkv_bias") else ".kernel"
            assert want_axis is None and _sharded_axis(fp[kernel], sp[kernel]) == 1, name
            column_biases += 1
            continue
        assert got == want_axis, (p, name, got, want_axis)
    assert seen == set(fp), set(fp) ^ seen
    assert column_biases > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_gathered_shards_are_the_weights(family):
    _, port = _jax_shapes(family)
    full = dict(port().named_parameters())
    shards = [dict(shard_module(port(), fake_mesh(2, r)).named_parameters()) for r in range(2)]
    for name, f in full.items():
        parts = [s[name] for s in shards]
        axis = _sharded_axis(f, parts[0])
        if axis is None:
            assert all(torch.equal(p, f) for p in parts), name
        elif name.endswith(("qkv_kernel", "qkv_bias", "qkv.kernel", "qkv.bias")):
            secs = [p.split(p.shape[-1] // 3, dim=-1) for p in parts]
            got = torch.cat([torch.cat([s[i] for s in secs], dim=-1) for i in range(3)], dim=-1)
            assert torch.equal(got, f), name
        else:
            assert torch.equal(torch.cat(parts, dim=axis), f), name


def test_sharded_forward_marks_and_heads():
    """A shard keeps half the heads, marks the row-parallel layers and the
    vocabulary-parallel embedding and head, and records its mesh."""
    _, port = _jax_shapes("qwen2vl")
    mesh = fake_mesh(2, 0)
    m = shard_module(port(), mesh)
    assert tensor_parallel(m).mesh is mesh and tensor_parallel(m).size == 2
    assert m.layers[0].o_proj.reduce is not None and m.layers[0].q_proj.reduce is None
    assert m.lm_head.gather is not None and m.embed_tokens.tp is not None
    assert m.visual.blocks[0].proj.reduce is not None
    assert m.layers[0].q_proj.kernel.shape == (32, 16) and m.layers[0].k_proj.kernel.shape == (32, 8)
    assert (m.layers[0].num_heads, m.layers[0].num_kv_heads, m.visual.blocks[0].num_heads) == (2, 1, 1)
    with pytest.raises(ValueError, match="already sharded"):
        shard_module(m, mesh)
    owl = shard_module(tow.init_params(tow.OwlViTDetector(tiny_pair(tow)), 0), mesh)
    attn = owl.vision.encoder.layers[0].self_attn
    assert attn.num_heads == 2 and attn.qkv_kernel.shape == (32, 48)
    assert owl.box_head.dense0.kernel.shape == (32, 32)     # heads stay whole
    assert owl.text_projection.kernel.shape == (24, 24)


@pytest.mark.parametrize("family, model, match", [
    ("owlvit", 3, "heads"), ("qwen2vl", 4, "heads"), ("llava", 4, "heads"),
])
def test_model_degree_that_divides_no_heads_raises(family, model, match):
    _, port = _jax_shapes(family)
    m = port()
    before = {k: v.shape for k, v in m.named_parameters()}
    with pytest.raises(ValueError, match=match) as err:
        shard_module(m, fake_mesh(model, 0))
    assert re.search(r"(layers|blocks)\.\d", str(err.value)), str(err.value)  # names the layer
    assert {k: v.shape for k, v in m.named_parameters()} == before      # nothing sliced


def test_nccl_on_two_ranks_of_one_device_raises():
    tmesh.check_devices(["h/cuda:0", "h/cuda:1"], "nccl")
    tmesh.check_devices(["h/cuda:0", "h/cuda:0"], "gloo")
    with pytest.raises(ValueError, match="two ranks on one device"):
        tmesh.check_devices(["h/cuda:0", "h/cuda:0"], "nccl")
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        tmesh.make_mesh(backend="nccl", device="cpu")


def test_data_sharding_splits_evenly_or_raises():
    m = tmesh.Mesh(data=2, model=2, rank=3, device=torch.device("cpu"), backend="gloo",
                   device_mesh=None)
    assert m.data_index == 1 and m.model_index == 1
    assert tmesh.data_sharding(m, 8) == slice(4, 8)
    with pytest.raises(ValueError, match="do not split evenly"):
        tmesh.data_sharding(m, 5)


def test_vlm_backend_refuses_a_device_off_the_mesh():
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend

    mesh = tmesh.Mesh(data=1, model=1, rank=0, device=torch.device("cuda", 0), backend="nccl",
                      device_mesh=None)
    with pytest.raises(ValueError, match="not the mesh rank's device"):
        TorchVLMBackend("no-checkpoint", device="cpu", mesh=mesh)


def _sampler_step(P, gumbel, cfg):
    """One recorded step (``StepStats(record=True)``'s entry) of a 64-second
    row with 60 valid seconds, the first 8 visited, sampled from ``P``."""
    from tstar_tpu_torch.search.engine import sample_secs

    n_valid = torch.tensor([60])
    visited = torch.zeros(1, 64, dtype=torch.bool)
    visited[0, :8] = True
    valid = torch.arange(64)[None] < n_valid[:, None]
    secs = sample_secs(P, visited, valid, n_valid, gumbel, None, cfg)
    return {"active": [True], "secs": secs, "conf": torch.zeros(1, cfg.frames_per_iteration),
            "P": P, "visited": visited, "gumbel": gumbel, "n_valid": n_valid}


def test_dry_run_parts_only_with_a_knife_edge_witness():
    """The dry run's witness (``tools/dryrun_multi._knife_edge``): a
    distribution 1e-6 from the other at three seconds tied with the
    quartile threshold parts the draw and is reported; a distribution
    beyond the tolerance, or other noise, fails."""
    from tstar_tpu_torch.tools.dryrun_multi import _compare
    from tstar_tpu_torch.utils.config import SearchConfig

    cfg = SearchConfig()
    g = torch.Generator().manual_seed(0)
    P = torch.tensor([1.0, 2.0, 3.0])[torch.randint(0, 3, (1, 64), generator=g)]
    P[:, 60:] = 0
    P = P / P.sum()
    gumbel = -torch.log(-torch.log(torch.rand(1, 64, generator=g)))
    top = (P[0, 8:60] == P[0, 8:60].max()).nonzero().flatten()[:3] + 8
    near = P.clone()
    near[0, top] *= 1 - 1e-6
    whole = [_sampler_step(P, gumbel, cfg)]
    parted, err, close = _compare([_sampler_step(near, gumbel, cfg)], whole, slice(0, 1), cfg)
    assert close and err == 0.0
    assert parted[0]["step"] == 0 and parted[0]["tie"] == "threshold"
    assert parted[0]["seconds"] == top.tolist() and parted[0]["dist_err"] < 1e-7

    far = P.clone()
    far[0, top] *= 1 - 1e-3            # the same seconds drop out, beyond the tolerance
    with pytest.raises(AssertionError, match="distributions"):
        _compare([_sampler_step(far, gumbel, cfg)], whole, slice(0, 1), cfg)
    with pytest.raises(AssertionError, match="other gumbel"):
        _compare([_sampler_step(near, gumbel.flip(-1), cfg)], whole, slice(0, 1), cfg)
