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

The quantized detector on the same mesh (``detector_quant`` 'int8' and
'w8a16', ``ranks.QUANTS``): each rank's sharded quantized tower against
the whole one (int8 bit for bit), the dp x tp searches against the port's
unsharded searches (rank 0 runs them) and against the reference's
quantized searches on its 2 x 2 mesh, which the parent computes beside the
other two.
"""

import os
import pickle
import socket
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
from tstar_tpu.search import detector_scorer as jds
from tstar_tpu.search import engine as jeng
from tstar_tpu.search.state import init_state as jinit
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu.video import cache as jcache
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models import qwen2vl as tqwen
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THashTokenizer
from tstar_tpu_torch.search import detector_scorer as tds
from tstar_tpu_torch.search import engine as teng
from tstar_tpu_torch.search.state import init_state as tinit
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig
from tstar_tpu_torch.video import cache as tcache

WORLD = 4
# the reference's quantized searches the mesh's are held to: on its 2 x 2 mesh
QUANT_RUNS = [(True, q) for q in ranks.QUANTS]
# int8 on the reference's mesh: the videos whose searches agree at every
# step, and each other video's step where the sampled seconds part
INT8_AGREE = ("mem://2", "mem://3")
INT8_PARTS = {"mem://0": 1, "mem://1": 3}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference_searches(variables, hosts, runs):
    """The reference's ``search_videos`` over the in-memory caches, one for
    each (on a 2 x 2 mesh of four devices?, ``detector_quant``) of ``runs``
    (in two threads: their compilations overlap)."""
    by_path = {f"mem://{i}": h for i, h in enumerate(hosts)}
    tasks = [jmv.VideoTask(p, ranks.TARGETS, ranks.CUES, seed=s)
             for p, s in zip(by_path, ranks.SEEDS)]

    mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])

    def search(on_mesh, quant):
        heur = OwlVitHeuristic.__new__(OwlVitHeuristic)
        heur.name = "owl-vit-tiny"
        heur.model = jow.OwlViTDetector(ranks.tiny_owlvit(jow), dtype=jnp.float32)
        heur.variables = shard_variables(mesh, variables) if on_mesh else variables
        heur.tokenizer = HashTokenizer(vocab_size=100, context=8)
        return jmv.search_videos(tasks, heur, JSearchConfig(**ranks.CONFIG, detector_quant=quant),
                                 mesh=mesh if on_mesh else None, collect_history=quant == "int8")

    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jmv, "probe_video_length",
                    lambda p, c: (by_path[p].n_valid, by_path[p].n_pad))
        mp_.setattr(jmv, "build_frame_cache_host", lambda p, c, hbm_budget_bytes=None:
                    jcache.HostFrameCache(by_path[p].frames, by_path[p].n_valid,
                                          by_path[p].raw_fps, by_path[p].duration))
        with ThreadPoolExecutor(2) as pool:
            futures = [pool.submit(search, *run) for run in runs]
            return [f.result() for f in futures]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The ranks' outputs and the reference's results, by name."""
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
        plain, on_mesh, *quantized = _reference_searches(
            owl_vars, hosts, [(False, None), (True, None), *QUANT_RUNS])
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
    return {"outs": outs, "plain": plain, "on_mesh": on_mesh, "greedy": greedy,
            "quantized": dict(zip(QUANT_RUNS, quantized)), "hosts": hosts,
            "owl_vars": owl_vars}


@pytest.fixture(scope="module")
def run(spawned):
    """(per-rank outputs, reference rows unsharded, on the mesh, reference
    greedy tokens)."""
    return spawned["outs"], spawned["plain"], spawned["on_mesh"], spawned["greedy"]


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



@pytest.mark.parametrize("quant", ranks.QUANTS)
def test_quantized_tp_tower_matches_one_rank(spawned, quant):
    """The quantized tower sharded over two ranks (2 heads a rank; the tiny
    tower's layers all below K4's shapes, so every route is "plain")
    against the whole tower on one rank: int8 bit for bit (int32 sums are
    exact and the scales are the whole rows' and columns'), w8a16 within
    1e-5 (f32 partial products summed over the ranks)."""
    for out in spawned["outs"]:
        assert out["quant_heads"] == 2 and out["quant_routes"] == {"plain": 8}
        equal, err = out[f"{quant}_features"]
        if quant == "int8":
            assert equal, err
        else:
            assert err <= 1e-5, err


@pytest.mark.parametrize("quant", ranks.QUANTS)
def test_quantized_dp_tp_search_matches_one_rank(spawned, quant):
    """``search_videos(mesh=...)`` with the quantized detector on data 2 x
    model 2 against the port's unsharded search of the same four videos:
    equal keyframes, iterations and remaining targets, the final
    distributions within rtol 1e-5, atol 1e-6 (int8's towers agree bit for
    bit, above; the spline and the update then run on a data rank's bucket
    of 2 instead of 4, an ulp apart)."""
    outs = spawned["outs"]
    one_rank = outs[0][f"one_rank_rows_{quant}"]
    for rank, out in enumerate(outs):
        assert out[f"steps_{quant}"] > 0
        for got, want in zip(out[f"rows_{quant}"], one_rank):
            assert got["keyframe_secs"] == want["keyframe_secs"], (rank, want["video_path"])
            assert got["iterations"] == want["iterations"]
            assert got["remaining_targets"] == want["remaining_targets"]
            np.testing.assert_allclose(got["keyframe_distribution"],
                                       want["keyframe_distribution"], rtol=1e-5, atol=1e-6)


def _parting(got, want):
    """The first step whose sampled seconds differ between two histories
    (None if every shared step sampled the same seconds)."""
    steps = zip(got["sampled_history"], want["sampled_history"])
    return next((k for k, (a, b) in enumerate(steps) if a != b), None)


def _assert_steps_close(got, want, steps):
    """The distributions after each of ``steps`` within the file's
    tolerance, and the seconds each sampled equal."""
    for k in steps:
        assert got["sampled_history"][k] == want["sampled_history"][k], (want["video_path"], k)
        np.testing.assert_allclose(got["P_history"][k], want["P_history"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{want['video_path']} step {k}")


@pytest.mark.parametrize("quant", ranks.QUANTS)
def test_quantized_dp_tp_search_matches_reference(spawned, quant):
    """The same searches against the reference's on its 2 x 2 mesh (its
    variables sharded, its int8 weights quantized from them and
    replicated).  w8a16: keyframes, iterations and remaining targets equal,
    distributions within the file's rtol 1e-5, atol 1e-6.

    int8, video by video.  On ``INT8_AGREE`` the searches agree throughout:
    the same check as w8a16's, and every step's sampled seconds and
    distribution too.  On ``INT8_PARTS`` they sample the same seconds up to
    the named step and other seconds there, for the port's unsharded
    search alike (``test_int8_partings_have_witnesses`` holds why); before
    the step whose update parts them, every distribution is within the
    file's tolerance.  After the parting the iterations stay equal and the
    final distributions lie within 1.5e-3 (1.12e-3 observed)."""
    outs = spawned["outs"]
    want_rows = spawned["quantized"][(True, quant)]
    if quant == "int8":
        assert sorted(INT8_AGREE + tuple(INT8_PARTS)) == [r["video_path"] for r in want_rows]
    for rank, out in enumerate(outs):
        for got, want in zip(out[f"rows_{quant}"], want_rows):
            path = want["video_path"]
            assert got["iterations"] == want["iterations"], (rank, path)
            if path in INT8_PARTS and quant == "int8":
                step = INT8_PARTS[path]
                assert _parting(got, want) == step, (rank, path)
                _assert_steps_close(got, want, range(step - 1))
                np.testing.assert_allclose(got["keyframe_distribution"],
                                           want["keyframe_distribution"], atol=1.5e-3)
                continue
            assert got["remaining_targets"] == want["remaining_targets"], (rank, path)
            assert got["keyframe_secs"] == want["keyframe_secs"], (rank, path)
            np.testing.assert_allclose(got["keyframe_distribution"],
                                       want["keyframe_distribution"], rtol=1e-5, atol=1e-6)
            if quant == "int8":
                assert len(got["sampled_history"]) == len(want["sampled_history"])
                _assert_steps_close(got, want, range(len(want["sampled_history"])))


def _grid_confidences(spawned, path, quant, secs):
    """Both packages' unsharded scorers (``detector_quant=quant``) on the
    grid of ``secs`` of video ``path``: ((conf, presence) of the
    reference, compiled as its search compiles it, of the port)."""
    host = spawned["hosts"][int(path.rsplit("/", 1)[1])]
    kw = dict(**ranks.CONFIG, detector_quant=quant)
    jdet = jow.OwlViTDetector(ranks.tiny_owlvit(jow), dtype=jnp.float32)
    tdet = tow.OwlViTDetector(ranks.tiny_owlvit(tow)).requires_grad_(False).eval()
    tdet.load_state_dict(tow.params_from_jax(spawned["owl_vars"]), strict=True)
    js = jds.make_owlvit_scorer(jdet, spawned["owl_vars"], jnp.asarray(host.frames),
                                ranks.TARGETS, ranks.CUES, HashTokenizer(100, 8),
                                JSearchConfig(**kw))
    ts = tds.make_owlvit_scorer(tdet, torch.from_numpy(host.frames), ranks.TARGETS, ranks.CUES,
                                THashTokenizer(100, 8), TSearchConfig(**kw))
    want = [np.array(a) for a in jax.jit(js.score_grid)(jnp.asarray(secs, jnp.int32))]
    with torch.no_grad():
        got = [a.numpy() for a in ts.score_grid(torch.tensor(secs))]
    return want, got


def test_int8_partings_have_witnesses(spawned):
    """Why each of ``INT8_PARTS`` parts from the reference's int8 search.

    The port's unsharded int8 search samples the mesh's seconds at every
    step, so the tensor-parallel layer adds nothing.  The witness is taken
    at the step whose update parts the sampling, on the grid both searches
    scored there, through each package's unsharded scorer:

      * "rounding" (``mem://1``): the int8 confidences differ (an activation
        crosses an int8 rounding boundary, ``tests/test_torch_quant.py``),
        while the weight-only w8a16 tower, the same int8 weights without
        the activation rounding, agrees within 1e-5 with the same presence.
        The step's detections stay within 1e-2 of the reference's, the
        bound ``tests/test_torch_slice.py`` gives one forward's flips;
      * "smoother" (``mem://0``, at step 0): the confidences agree within
        1e-5, and each package's ``apply_grid_scores`` on the reference's
        confidences reproduces its own search's distribution, while the two
        lie further apart than the file's tolerance: the float32 smoother's
        ill-conditioning at large lam (queue 3 item 11 of ``ROADMAP.md``),
        not the int8 tower."""
    want_rows = {r["video_path"]: r for r in spawned["quantized"][(True, "int8")]}
    causes = {}
    for path, step in INT8_PARTS.items():
        want = want_rows[path]
        mesh = next(r for r in spawned["outs"][0]["rows_int8"] if r["video_path"] == path)
        one = next(r for r in spawned["outs"][0]["one_rank_rows_int8"] if r["video_path"] == path)
        assert _parting(mesh, one) is None and len(mesh["sampled_history"]) == len(
            one["sampled_history"]), path
        _assert_steps_close(mesh, one, range(len(one["sampled_history"])))
        w = step - 1
        secs = want["sampled_history"][w]
        (jc, jp), (tc, tp) = _grid_confidences(spawned, path, "int8", secs)
        if np.abs(tc - jc).max() > 1e-5:
            causes[path] = "rounding"
            (jc16, jp16), (tc16, tp16) = _grid_confidences(spawned, path, "w8a16", secs)
            np.testing.assert_allclose(tc16, jc16, atol=1e-5, err_msg=path)
            np.testing.assert_array_equal(tp16, jp16, err_msg=path)
            np.testing.assert_allclose(mesh["detect_bbox_iters"][w]["scores"],
                                       want["detect_bbox_iters"][w]["scores"], atol=1e-2)
            continue
        causes[path] = "smoother"
        assert w == 0, path          # from the initial state, whose scores both packages set
        host = spawned["hosts"][int(path.rsplit("/", 1)[1])]
        jcfg, tcfg = JSearchConfig(**ranks.CONFIG), TSearchConfig(**ranks.CONFIG)
        js = jinit(host.n_valid, len(ranks.TARGETS), jcfg, jax.random.key(0), n_pad=host.n_pad)
        jp_ = np.asarray(jeng.apply_grid_scores(js, jnp.asarray(secs, jnp.int32),
                                                jnp.asarray(jc), jcfg)[2])[:host.n_valid]
        ts = tinit(host.n_valid, len(ranks.TARGETS), tcfg, torch.Generator().manual_seed(0),
                   n_pad=host.n_pad)
        tp_ = teng.apply_grid_scores(
            ts.scores[None], ts.visited[None], ts.valid[None], torch.tensor([host.n_valid]),
            torch.tensor([secs]), torch.from_numpy(jc)[None], tcfg)[2][0, :host.n_valid].numpy()
        np.testing.assert_allclose(jp_, want["P_history"][w], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tp_, mesh["P_history"][w], rtol=1e-5, atol=1e-6)
        assert not np.allclose(tp_, jp_, rtol=1e-5, atol=1e-6), path
    assert causes == {"mem://0": "smoother", "mem://1": "rounding"}
