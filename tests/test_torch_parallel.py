"""The port's multi-device layer on four gloo ranks on the CPU (data = 2 x
model = 2), against the JAX package's on conftest's virtual CPU devices.

One module fixture spawns the four ranks (``tests/torch_mesh_ranks.py``,
one torch thread each) and, while they run, computes the reference's
results in this process:

  * ``search_videos`` over four 300 s scenes of one length bucket with the
    tiny OWL-ViT of ``__graft_entry__.py`` (the port's weights are the
    reference's, ``params_from_jax``), run by the reference unsharded and on
    ``make_mesh(data=2, model=2)`` over four devices with its variables
    sharded; the port shards the detector over each data row's two ranks
    and gives each data rank two videos.  Every video consumes the
    reference's Gumbel draws (deterministic pop, so the draws of a full
    budget are replayed whatever the iterations).  Keyframe seconds and
    iterations must be equal, the final distributions within rtol 1e-5,
    atol 1e-6 (float32 detector confidences ~1e-6 apart after the towers);
  * the reference's ``generate`` on the tiny Qwen2-VL: the port's
    tensor-parallel greedy tokens must equal it.

The ranks also hold the TP forward to the whole model within 1e-5 (f32
summation order: the row-parallel sums split over two ranks), and a
sampled decode must give the same tokens on every rank of a model group,
even with a generator seeded differently on each rank (the pick is
broadcast from the group's first rank).
"""

import os
import pickle
import socket
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from tests import torch_mesh_ranks as ranks
from tests.test_torch_engine import jax_noise
from tests.test_torch_vlm_models import numpy_variables
from tstar_tpu.framework.heuristics import OwlVitHeuristic
from tstar_tpu.models import generate as jgen
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models import qwen2vl as jqwen
from tstar_tpu.models.clip_tokenizer import HashTokenizer
from tstar_tpu.parallel import multi_video as jmv
from tstar_tpu.parallel.mesh import make_mesh as jmake_mesh
from tstar_tpu.parallel.shardings import shard_variables
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu.video import cache as jcache
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import qwen2vl as tqwen
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig
from tstar_tpu_torch.video import cache as tcache

WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference_searches(variables, hosts):
    """The reference's ``search_videos`` over the in-memory caches,
    unsharded and on a 2 x 2 mesh of four devices (in two threads: their
    compilations overlap)."""
    by_path = {f"mem://{i}": h for i, h in enumerate(hosts)}
    tasks = [jmv.VideoTask(p, ranks.TARGETS, ranks.CUES, seed=s)
             for p, s in zip(by_path, ranks.SEEDS)]

    def search(mesh):
        heur = OwlVitHeuristic.__new__(OwlVitHeuristic)
        heur.name = "owl-vit-tiny"
        heur.model = jow.OwlViTDetector(ranks.tiny_owlvit(jow), dtype=jnp.float32)
        heur.variables = variables if mesh is None else shard_variables(mesh, variables)
        heur.tokenizer = HashTokenizer(vocab_size=100, context=8)
        return jmv.search_videos(tasks, heur, JSearchConfig(**ranks.CONFIG), mesh=mesh)

    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jmv, "probe_video_length",
                    lambda p, c: (by_path[p].n_valid, by_path[p].n_pad))
        mp_.setattr(jmv, "build_frame_cache_host", lambda p, c, hbm_budget_bytes=None:
                    jcache.HostFrameCache(by_path[p].frames, by_path[p].n_valid,
                                          by_path[p].raw_fps, by_path[p].duration))
        with ThreadPoolExecutor(2) as pool:
            runs = [pool.submit(search, m) for m in (
                None, jmake_mesh(data=2, model=2, devices=jax.devices()[:4]))]
            return [r.result() for r in runs]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(per-rank outputs, reference rows unsharded, on the mesh, reference
    greedy tokens)."""
    jcfg = JSearchConfig(**ranks.CONFIG)
    tcfg = TSearchConfig(**ranks.CONFIG)
    hosts = [tcache.build_frame_cache_host("mem://v", tcfg, decoder=d) for d in ranks.decoders()]
    assert len({h.n_pad for h in hosts}) == 1
    n_pad, cap = hosts[0].n_pad, jcfg.iteration_cap(hosts[0].n_valid)

    jdet = jow.OwlViTDetector(ranks.tiny_owlvit(jow), dtype=jnp.float32)
    owl_vars = jax.jit(jdet.init)(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                  jnp.zeros((2, 8), jnp.int32))
    qcfg = jqwen.Qwen2VLConfig(vision=jqwen.Qwen2VLVisionConfig(**ranks.QWEN_VISION),
                               text=jqwen.Qwen2VLTextConfig(**ranks.QWEN_TEXT),
                               image_token_id=251)
    vlm = jqwen.Qwen2VLModel(qcfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    patches = rng.standard_normal((1, 16, 12)).astype(np.float32)
    init_pos = jnp.zeros((3, 1, ranks.VLM_IDS.shape[1]), jnp.int32)
    qwen_vars = numpy_variables(vlm, 3, jnp.asarray(ranks.VLM_IDS), init_pos, None,
                                jnp.asarray(patches), (4, 4))
    spec = {
        "owl_state": tow.params_from_jax(owl_vars),
        "qwen_state": tqwen.params_from_jax(qwen_vars),
        "noise": {s: jax_noise(s, n_pad, cap, pop=False) for s in ranks.SEEDS},
        "pixels": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
        "text": tuple(np.asarray(a) for a in HashTokenizer(100, 8).encode_batch(
            ["couch", "lamp", "tv"])),
        "patches": patches,
    }
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    ctx = mp.start_processes(ranks.run, args=(WORLD, _free_port(), spec, out_dir),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        plain, on_mesh = _reference_searches(owl_vars, hosts)
        pos = jqwen.build_mrope_position_ids(ranks.VLM_IDS[0], 251, [(1, 4, 4)], 2)[:, None]
        greedy = np.asarray(jgen.generate(
            vlm, qwen_vars, ranks.VLM_IDS, np.array([6]), pos,
            max_new_tokens=ranks.NEW_TOKENS, eos_token_ids=[255], temperature=0.0,
            image_patches=patches, image_grid_hw=(4, 4), cache_dtype=jnp.float32,
        )).tolist()
    finally:
        while not ctx.join():
            pass
    outs = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs, plain, on_mesh, greedy


def test_ranks_sit_on_the_reference_layout(run):
    outs = run[0]
    assert [o["coords"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    grid = np.vectorize(lambda d: d.id)(jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
                                        .devices).tolist()
    assert all(o["device_mesh"] == grid for o in outs)          # torch's groups, the same grid
    assert [o["coordinate"] for o in outs] == [o["coords"] for o in outs]
    assert all("!= world size 4" in o["bad_shape_error"] for o in outs)
    assert all(o["replicated"] == [0.0, 0.0, 0.0] for o in outs)      # rank 0's copy
    assert all("disagree on a loop flag" in o["disagree_error"] for o in outs)


@pytest.mark.parametrize("reference", ["unsharded", "mesh"])
def test_dp_tp_search_matches_reference(run, reference):
    outs, plain, on_mesh, _ = run
    want = plain if reference == "unsharded" else on_mesh
    for rank, out in enumerate(outs):
        assert out["steps"] > 0
        for got, ref in zip(out["rows"], want):
            assert got["keyframe_secs"] == ref["keyframe_secs"], (rank, ref["video_path"])
            assert got["iterations"] == ref["iterations"]
            assert got["remaining_targets"] == ref["remaining_targets"]
            np.testing.assert_allclose(got["keyframe_distribution"],
                                       ref["keyframe_distribution"], rtol=1e-5, atol=1e-6)


def test_every_rank_returns_every_row_in_task_order(run):
    outs = run[0]
    paths = [f"mem://{i}" for i in range(4)]
    for out in outs:
        assert [r["video_path"] for r in out["rows"]] == paths
        assert out["rows"] == outs[0]["rows"]
    # each data rank searched its own two videos: as many steps as the
    # longer of their searches
    for rank, out in enumerate(outs):
        share = out["rows"][2 * (rank // 2): 2 * (rank // 2) + 2]
        assert out["steps"] == max(r["iterations"] for r in share)


def test_tp_forward_matches_whole_model(run):
    for out in run[0]:
        assert out["forward_err"] <= 1e-5, out["forward_err"]


def test_tp_generate_matches_reference(run):
    outs, _, _, greedy = run
    for out in outs:
        assert out["greedy"] == greedy


def test_sampled_decode_agrees_across_ranks(run):
    outs = run[0]
    assert all(o["sampled_same_seed"] == outs[0]["sampled_same_seed"] for o in outs)
    for group in ((0, 1), (2, 3)):
        a, b = (outs[r]["sampled_rank_seed"] for r in group)
        assert a == b, group
    assert len(outs[0]["sampled_same_seed"][0]) == ranks.NEW_TOKENS
