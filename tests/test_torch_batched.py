"""The port's batched multi-video search (``tstar_tpu_torch/parallel``, the
scorer's flat batch methods, the single-video chained driver) against the
JAX package's, on the CPU.

Both run the same tiny OWL-ViT (2 layers, 32 wide, 64^2 images; the port's
weights are the reference's, ``params_from_jax``) over the same synthetic
frame caches, and each video consumes the same Gumbel noise: the port replays
the draws of the reference's per-video key schedule (``jax_noise``, one
replay per video: a batched step splits each video's key as its own search
would).  The sampled seconds of every iteration, the keyframes, the
iterations and the remaining targets must be EQUAL; final scores agree to
1e-5 relative (float32 detector confidences, ~1e-6 apart after the towers);
the scorer methods' confidences to 1e-5 absolute, presence masks equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import make_synthetic_tables
from tests.test_torch_engine import jax_noise
from tests.test_torch_owlvit import tiny_pair
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models.clip_tokenizer import HashTokenizer as JHash
from tstar_tpu.parallel import batched as jbat
from tstar_tpu.search import detector_scorer as jds
from tstar_tpu.search import engine as jeng
from tstar_tpu.search.scorers import TableScorer as JTable
from tstar_tpu.search.state import init_state as jinit
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu_torch.framework.heuristics import initialize_heuristic
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THash
from tstar_tpu_torch.parallel import batched as tbat
from tstar_tpu_torch.parallel.multi_video import VideoTask, _bucket_indices, search_videos
from tstar_tpu_torch.search import detector_scorer as tds
from tstar_tpu_torch.search import engine as teng
from tstar_tpu_torch.search.scorers import TableScorer as TTable
from tstar_tpu_torch.search.state import init_state as tinit
from tstar_tpu_torch.search.state import stack_states
from tstar_tpu_torch.search.step_graphs import StepStats
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig
from tstar_tpu_torch.video import cache as tcache
from tstar_tpu_torch.video.synthetic import PlantedObject, SyntheticDecoder, default_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file
    several-fold; its tiny shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(search_budget=0.5, cache_hw=(32, 64))
TARGETS, CUES = ["couch", "lamp"], ["tv"]
SEEDS = (3, 11, 20)


def configs(**overrides):
    kw = {**BASE, **overrides}
    return JSearchConfig(**kw), TSearchConfig(**kw)


def scene(duration, shift):
    """``default_scene``'s objects, moved by ``shift`` seconds and across."""
    objs = [
        PlantedObject("couch", (70.0 + shift, 80.0 + shift), (200, 40, 40), (0.55, 0.4), 0.45),
        PlantedObject("lamp", (300.0 - shift, 312.0 - shift), (230, 220, 60), (0.4, 0.6), 0.3),
        PlantedObject("tv", (30.0 + shift, 90.0 + shift), (40, 40, 200), (0.3, 0.75), 0.25),
    ]
    return SyntheticDecoder(duration, objects=objs)


def decoders():
    return [default_scene(450.0), scene(450.0, 100.0), scene(450.0, 200.0)]


@pytest.fixture(scope="module")
def pair():
    """(reference model, variables, port model, host caches of 3 videos)."""
    jmodel = jow.OwlViTDetector(tiny_pair(jow), dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32)
    )
    tmodel = tow.OwlViTDetector(tiny_pair(tow))
    tmodel.load_state_dict(tow.params_from_jax(variables), strict=True)
    tmodel.requires_grad_(False)
    _, tcfg = configs()
    hosts = [tcache.build_frame_cache_host("mem://v", tcfg, decoder=d) for d in decoders()]
    assert len({h.n_pad for h in hosts}) == 1
    return jmodel, variables, tmodel, hosts


def _scorers(pair, jcfg, tcfg):
    jmodel, variables, tmodel, hosts = pair
    js = [jds.make_owlvit_scorer(jmodel, variables, jnp.asarray(h.frames), TARGETS, CUES,
                                 JHash(100, 8), jcfg) for h in hosts]
    ts = [tds.make_owlvit_scorer(tmodel, torch.from_numpy(h.frames), TARGETS, CUES,
                                 THash(100, 8), tcfg) for h in hosts]
    return jbat.stack_scorers(js, jcfg), tbat.stack_scorers(ts, tcfg)


def test_batch_scorer_methods_match_reference(pair):
    jcfg, tcfg = configs()
    jb, tb = _scorers(pair, jcfg, tcfg)
    rng = np.random.default_rng(0)
    n_valid = pair[3][0].n_valid
    secs = np.stack([rng.choice(n_valid, 16, replace=False) for _ in range(3)])
    vid = np.array([2, 0, 1, 1, 0, 2, 2])
    vsecs = rng.integers(0, n_valid, vid.shape[0])
    calls = {
        "score_grid_batch": ((secs,), 1e-5),
        "score_verify_batch": ((secs[:, :5],), 1e-5),
        "score_verify_flat": ((vid, vsecs), 1e-5),
    }
    for method, (args, atol) in calls.items():
        jc, jp = getattr(jb, method)(*(jnp.asarray(a, jnp.int32) for a in args))
        tc, tp = getattr(tb, method)(*(torch.from_numpy(a).long() for a in args))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=atol, err_msg=method)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), err_msg=method)


def _run_both(pair, cap=None, port_driver="chained", **overrides):
    """The reference's batched search (per-step history) and the port's, on
    replayed per-video noise.  Returns (reference, port) as (final, keyframes,
    per-step [(active, secs)]) plus the port's StepStats."""
    jcfg, tcfg = configs(**overrides)
    jb, tb = _scorers(pair, jcfg, tcfg)
    hosts = pair[3]
    n_pad = hosts[0].n_pad
    cap = cap or jcfg.iteration_cap(hosts[0].n_valid)
    jstates = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
        jinit(h.n_valid, len(TARGETS), jcfg, jax.random.key(s), n_pad=n_pad)
        for h, s in zip(hosts, SEEDS)
    ])
    jfinal, jsecs, hist = jbat.run_search_batched_with_history(jstates, jb, jcfg, cap)
    j_steps = [(list(h["active"]), h["secs"]) for h in hist]

    iters = np.asarray(jfinal.iteration)
    pop = not tcfg.deterministic_pop
    tstates = stack_states([
        tinit(h.n_valid, len(TARGETS), tcfg, iter(jax_noise(s, n_pad, int(n), pop=pop)),
              n_pad=n_pad)
        for h, s, n in zip(hosts, SEEDS, iters)
    ])
    stats = StepStats(record=True)
    driver = {"chained": tbat.run_search_batched_chained,
              "auto": tbat.run_search_batched_auto}[port_driver]
    tfinal, tsecs = driver(tstates, tb, tcfg, cap, stats=stats)
    t_steps = [(e["active"], e["secs"].numpy()) for e in stats.trace]
    return (jfinal, np.asarray(jsecs), j_steps), (tfinal, tsecs.numpy(), t_steps), stats


def _assert_same(j, t):
    (jfinal, jsecs, jsteps), (tfinal, tsecs, tsteps) = j, t
    assert len(tsteps) == len(jsteps)
    for it, ((ja, js), (ta, ts)) in enumerate(zip(jsteps, tsteps)):
        assert ta == [bool(a) for a in ja], f"active videos at step {it}"
        for v, a in enumerate(ta):
            if a:
                np.testing.assert_array_equal(ts[v], js[v], err_msg=f"video {v} step {it}")
    np.testing.assert_array_equal(tsecs, jsecs)
    np.testing.assert_array_equal(tfinal.iteration.numpy(), np.asarray(jfinal.iteration))
    np.testing.assert_array_equal(tfinal.remaining.numpy(), np.asarray(jfinal.remaining))
    np.testing.assert_array_equal(tfinal.budget.numpy(), np.asarray(jfinal.budget))
    np.testing.assert_allclose(tfinal.scores.numpy(), np.asarray(jfinal.scores),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("driver", ["chained", "auto"])
def test_batched_search_matches_reference(pair, driver):
    """Global-flat verification (the default), 3 videos that finish apart."""
    j, t, stats = _run_both(pair, port_driver=driver)
    _assert_same(j, t)
    assert stats.verify_widths, "no verification ran: the flat rescore was not driven"
    assert stats.host_reads == 2 * stats.steps and stats.setup_reads == 1
    assert stats.replays == 0 and stats.captures == 0        # the CPU steps eagerly


def test_per_video_verify_buckets_equal_global_flat(pair):
    """``verify_flat=False`` (per-video buckets) gives the global-flat
    search, and the reference's per-video search."""
    j, t_pv, stats = _run_both(pair, verify_flat=False)
    _, t_flat, _ = _run_both(pair)
    _assert_same(j, t_pv)
    for a, b in zip(t_pv[2], t_flat[2]):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(t_pv[1], t_flat[1])
    assert stats.verify_widths


def test_wide_verification_matches_reference(pair):
    """A bucket width of K: every sampled frame of every video in one
    forward (``score_verify_batch``)."""
    j, t, stats = _run_both(pair, verify_batch=None)
    _assert_same(j, t)
    assert stats.verify_widths and set(stats.verify_widths) == {3 * 16}


CFG_T = JSearchConfig(search_budget=0.5)


def _tables(n_videos, n_valid, n_pad):
    return [make_synthetic_tables(n_pad, n_valid, CFG_T.max_objects, 1, 100 + i)
            for i in range(n_videos)]


def test_early_finishers_frozen():
    """Table scorers: video 0 finds its target at once, video 1 never; video
    0's state freezes while video 1 spends its budget (the reference's
    ``test_early_finishers_frozen``)."""
    cfg = dataclasses.replace(TSearchConfig(), search_budget=0.5)
    n = 128
    hot = torch.full((n,), 0.9)
    pres = torch.zeros(n, cfg.max_objects, dtype=torch.bool)
    pres[:, 0] = True
    cold, nopres = torch.zeros(n), torch.zeros_like(pres)
    scorers = [TTable(hot, pres, hot, pres), TTable(cold, nopres, cold, nopres)]
    states = stack_states([
        tinit(n, 1, cfg, torch.Generator().manual_seed(i), n_pad=n) for i in range(2)
    ])
    finals, _ = tbat.run_search_batched(states, tbat.stack_scorers(scorers, cfg), cfg)
    assert finals.iteration.tolist() == [1, 4]          # 64-frame budget / 16
    assert not finals.remaining[0].any() and finals.remaining[1].any()
    assert finals.budget.tolist() == [64 - 16, 0]


def _table_both(cap, n_videos=3, n_valid=200):
    n_pad = CFG_T.padded_frames(n_valid)
    tables = _tables(n_videos, n_valid, n_pad)
    jscorer = JTable(*(jnp.stack([jnp.asarray(getattr(t, f.name)) for t in tables])
                       for f in dataclasses.fields(tables[0])))
    jstates = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
        jinit(n_valid, 1, CFG_T, jax.random.key(i), n_pad=n_pad) for i in range(n_videos)
    ])
    jfinal, jsecs, hist = jbat.run_search_batched_with_history(jstates, jscorer, CFG_T, cap)
    tcfg = TSearchConfig(**{f.name: getattr(CFG_T, f.name) for f in dataclasses.fields(CFG_T)})
    tscorer = tbat.stack_scorers([
        TTable(*(torch.from_numpy(np.asarray(getattr(t, f.name))) for f in dataclasses.fields(t)))
        for t in tables
    ], tcfg)
    iters = np.asarray(jfinal.iteration)
    tstates = stack_states([
        tinit(n_valid, 1, tcfg, iter(jax_noise(i, n_pad, int(iters[i]))), n_pad=n_pad)
        for i in range(n_videos)
    ])
    stats = StepStats(record=True)
    tfinal, tsecs = tbat.run_search_batched_auto(tstates, tscorer, tcfg, cap, stats=stats)
    j = (jfinal, np.asarray(jsecs), [(list(h["active"]), h["secs"]) for h in hist])
    t = (tfinal, tsecs.numpy(), [(e["active"], e["secs"].numpy()) for e in stats.trace])
    return j, t


def test_auto_honours_a_cap_below_the_budget():
    """``run_search_batched_auto`` at B <= 16 stops at ``max_iterations``
    (2, below the 7 the budget allows), as the reference's chained driver
    does; the reference's ``_auto`` would drop the cap there."""
    j, t = _table_both(cap=2)
    _assert_same(j, t)
    assert t[0].iteration.tolist() == [2, 2, 2]
    assert t[0].budget.tolist() == [100 - 32] * 3


def test_table_batched_search_matches_reference():
    """Table scorers through the same flat steps as the detector's: equal to
    the reference's vmapped single-video steps."""
    j, t = _table_both(cap=CFG_T.iteration_cap(200))
    _assert_same(j, t)


def test_batched_step_masks_finished_videos():
    """``batched_search_step`` leaves a finished video's state as it was."""
    cfg = TSearchConfig(search_budget=0.5)
    tables = _tables(2, 200, cfg.padded_frames(200))
    scorer = tbat.stack_scorers([
        TTable(*(torch.from_numpy(np.asarray(getattr(t, f.name))) for f in dataclasses.fields(t)))
        for t in tables
    ], cfg)
    states = stack_states([
        tinit(200, 1, cfg, torch.Generator().manual_seed(0)),
        tinit(200, 0, cfg, torch.Generator().manual_seed(1)),        # no target: finished
    ])
    out = tbat.batched_search_step(states, scorer, cfg)
    assert out.iteration.tolist() == [1, 0]
    assert torch.equal(out.scores[1], states.scores[1]) and torch.equal(out.P[1], states.P[1])
    assert not torch.equal(out.scores[0], states.scores[0])


def test_run_search_chained_matches_reference(pair):
    """The single-video chained driver: the reference's ``run_search_chained``
    seconds, scores, iterations and remaining targets; with a cap of 3 it
    stops there, as the reference's does."""
    jmodel, variables, tmodel, hosts = pair
    jcfg, tcfg = configs()
    h = hosts[1]
    js = jds.make_owlvit_scorer(jmodel, variables, jnp.asarray(h.frames), TARGETS, CUES,
                                JHash(100, 8), jcfg)
    ts = tds.make_owlvit_scorer(tmodel, torch.from_numpy(h.frames), TARGETS, CUES,
                                THash(100, 8), tcfg)
    for cap in (None, 3):
        s0 = jinit(h.n_valid, len(TARGETS), jcfg, jax.random.key(5), n_pad=h.n_pad)
        jfinal, jsecs = jeng.run_search_chained(s0, js, jcfg, cap)
        state = tinit(h.n_valid, len(TARGETS), tcfg,
                      iter(jax_noise(5, h.n_pad, int(jfinal.iteration))), n_pad=h.n_pad)
        stats = StepStats()
        tfinal, tsecs = teng.run_search_chained(state, ts, tcfg, cap, stats=stats)
        np.testing.assert_array_equal(tsecs.numpy(), np.asarray(jsecs))
        assert tfinal.iteration == int(jfinal.iteration) == stats.steps
        assert tfinal.budget == int(jfinal.budget)
        np.testing.assert_array_equal(tfinal.remaining.numpy(), np.asarray(jfinal.remaining))
        np.testing.assert_allclose(tfinal.scores.numpy(), np.asarray(jfinal.scores),
                                   rtol=1e-5, atol=1e-7)
    assert tfinal.iteration == 3


def test_search_videos_equals_per_video_searches():
    """``search_videos`` over two length buckets (450 s and 300 s videos):
    each video's keyframes, iterations and remaining targets are those of
    its own single-video search with the same seed."""
    heur = initialize_heuristic("owl-vit-random", device="cpu", dtype=torch.float32,
                                model_config=tiny_pair(tow), seed=1)
    _, cfg = configs()
    decs = [default_scene(450.0), scene(300.0, 50.0), scene(450.0, 150.0)]
    tasks = [VideoTask(f"mem://{i}", TARGETS, CUES, seed=7 + i, decoder=d)
             for i, d in enumerate(decs)]
    assert _bucket_indices([480, 320, 480], True) == [[1], [0, 2]]
    stats = StepStats()
    results = search_videos(tasks, heur, cfg, stats=stats)
    assert stats.steps > 0
    for task, res, dec in zip(tasks, results, decs):
        cache = tcache.build_frame_cache(task.video_path, cfg, device="cpu", decoder=dec)
        scorer = heur.build_scorer(cache.frames, TARGETS, CUES, cfg)
        state = tinit(cache.n_valid, len(TARGETS), cfg,
                      torch.Generator().manual_seed(task.seed), n_pad=cache.n_pad)
        final, secs = teng.run_search(state, scorer, cfg)
        assert res["keyframe_secs"] == secs.tolist()
        assert res["iterations"] == final.iteration
        left = [t for j, t in enumerate(TARGETS) if final.remaining[j]]
        assert res["remaining_targets"] == left
        assert res["keyframe_timestamps"] == sorted(float(s) for s in secs.tolist())
        assert len(res["keyframe_distribution"]) == cache.n_valid


def test_search_videos_streams_over_budget_videos(caplog):
    """Videos over their bucket's budget (a 1 MB device total: 300 s and 200
    s caches of 1.6-2.4 MB) stream, as does every video under
    ``cache_mode='streaming'``: each row equals the video's own resident
    single search, without histories (a warning says so), three host reads
    a step; 'downscale' shrinks the cache instead."""
    heur = initialize_heuristic("owl-vit-random", device="cpu", dtype=torch.float32,
                                model_config=tiny_pair(tow), seed=1)
    _, cfg = configs()
    decs = [default_scene(300.0), scene(200.0, 50.0)]
    tasks = [VideoTask(f"mem://{i}", TARGETS, CUES, seed=7 + i, decoder=d)
             for i, d in enumerate(decs)]
    stats = StepStats()
    with caplog.at_level("WARNING"):
        auto = search_videos(tasks, heur, cfg, hbm_budget_bytes=10 ** 6, stats=stats,
                             collect_history=True)
    assert "histories are not collected for streamed videos" in caplog.text
    assert stats.steps > 0 and stats.host_reads == 3 * stats.steps
    forced = search_videos(tasks[1:], heur, dataclasses.replace(cfg, cache_mode="streaming"))
    assert forced == auto[1:]
    for task, res, dec in zip(tasks, auto, decs):
        cache = tcache.build_frame_cache(task.video_path, cfg, device="cpu", decoder=dec)
        assert isinstance(cache, tcache.FrameCache)
        scorer = heur.build_scorer(cache.frames, TARGETS, CUES, cfg)
        state = tinit(cache.n_valid, len(TARGETS), cfg,
                      torch.Generator().manual_seed(task.seed), n_pad=cache.n_pad)
        final, secs = teng.run_search(state, scorer, cfg)
        assert res["keyframe_secs"] == secs.tolist()
        assert res["iterations"] == final.iteration
        assert res["keyframe_distribution"] == final.P[:cache.n_valid].tolist()
        assert "P_history" not in res
    out = search_videos(tasks[:1], heur, dataclasses.replace(cfg, cache_mode="downscale"),
                        hbm_budget_bytes=64 * 10 ** 6)
    assert len(out[0]["keyframe_secs"]) == cfg.search_nframes


def test_class_head_per_image_queries_equal_shared():
    """Per-image (B, Q, D) queries and (B, Q) masks that repeat one set give
    the shared (Q, D) form's logits exactly."""
    torch.manual_seed(0)
    head = tow.ClassHead(32, 24).requires_grad_(False)
    for p in head.parameters():
        torch.nn.init.normal_(p, std=0.2)
    feats = torch.randn(3, 16, 32)
    q = torch.randn(5, 24)
    mask = torch.tensor([True, True, False, True, False])
    shared = head(feats, q, mask)
    per = head(feats, q[None].expand(3, -1, -1), mask[None].expand(3, -1))
    assert torch.equal(per, shared)
    # distinct sets: image i against its own queries (a batched product in
    # place of one per image: float32 summation order only)
    qs = torch.randn(3, 5, 24)
    per = head(feats, qs, mask[None].expand(3, -1))
    for i in range(3):
        torch.testing.assert_close(per[i], head(feats[i:i + 1], qs[i], mask)[0],
                                   rtol=1e-6, atol=1e-6)


def test_graphs_need_a_cuda_device():
    cfg = TSearchConfig()
    state = tinit(100, 1, cfg, torch.Generator())
    table = TTable(torch.zeros(cfg.padded_frames(100)),
                   torch.zeros(cfg.padded_frames(100), cfg.max_objects, dtype=torch.bool),
                   torch.zeros(cfg.padded_frames(100)),
                   torch.zeros(cfg.padded_frames(100), cfg.max_objects, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        teng.run_search(state, table, cfg, graphs=True)
    # budget int(100 * 0.5) = 50 frames: four grids of 16
    assert teng.run_search(state, table, cfg, graphs=False)[0].iteration == 4


def test_search_videos_retries_a_bucket_out_of_memory(monkeypatch):
    """A bucket that raises ``torch.cuda.OutOfMemoryError`` is rebuilt with
    half the per-video budget (a smaller cache) and searched again."""
    from tstar_tpu_torch.parallel import multi_video as mv

    heur = initialize_heuristic("owl-vit-random", device="cpu", dtype=torch.float32,
                                model_config=tiny_pair(tow), seed=1)
    _, cfg = configs(cache_hw=(192, 384))
    calls, real = [], mv._search_bucket

    def flaky(tasks, caches, *args):
        calls.append(tuple(caches[0].frames.shape[1:3]))
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return real(tasks, caches, *args)

    monkeypatch.setattr(mv, "_search_bucket", flaky)
    tasks = [VideoTask("mem://0", TARGETS, CUES, decoder=default_scene(300.0))]
    # 800 MB of device memory: a 100 MB budget holds the 84.9 MB cache (384
    # padded seconds of 192x384), half of it a 96-row one
    assert tcache.per_video_hbm_budget(1, total_bytes=8 * 10 ** 8) == 10 ** 8
    results = search_videos(tasks, heur, cfg, hbm_budget_bytes=8 * 10 ** 8,
                            decode_workers=1, prefetch=False)
    assert calls == [(192, 384), (96, 384)]
    assert len(results[0]["keyframe_secs"]) == cfg.search_nframes
