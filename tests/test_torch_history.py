"""The search's histories, snapshots and grid renders in the port against
the JAX package's, on the CPU.

``run_search_with_history`` (single video) and
``run_search_batched_with_history`` (B = 2) run on the same tiny OWL-ViT
weights (``params_from_jax``) over the same synthetic frame caches (the
single search on the small YOLO-World: ``tests/test_torch_yolo_search.py``,
through ``port_history_matches``), with the reference's Gumbel draws replayed
(``jax_noise``).  Every history entry's sampled seconds and visited marks
are EQUAL; ``P``, ``scores`` and the grid confidences agree within the slice
tests' 1e-5; the detections' ``class_ids`` and ``valid`` are EQUAL and their
``scores`` agree within 1e-5 and ``boxes`` within 1e-2 pixels of the 64^2
or 640^2 detector canvas (YOLO's DFL decode turns f32 differences of ~1e-7
in the head into ~4e-3 px at 640).  YOLO's ``P`` agrees within 1e-2
relative: the reference's sigmoid scores and the port's lie an ulp apart
(``tests/test_torch_yolo_search.py``), and the float32 smoother, fitted to
few visited seconds, amplifies that to ~1e-2 (ROADMAP queue 1 item 3); the
sampled seconds stay equal.

Grid images: the reference resizes with ``cv2.resize`` (INTER_LINEAR, 11-bit
fixed-point weights for uint8), the port with its float bilinear matrices
rounded to uint8, so a pixel may sit ONE level apart; the tolerance is
|diff| <= 1 everywhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_batched import decoders
from tests.test_torch_engine import jax_noise
from tests.test_torch_owlvit import tiny_pair
from tstar_tpu.framework.heuristics import OwlVitHeuristic as JOwlHeuristic
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models.clip_tokenizer import HashTokenizer as JHash
from tstar_tpu.parallel import batched as jbat
from tstar_tpu.search import detector_scorer as jds
from tstar_tpu.search import engine as jeng
from tstar_tpu.search.searcher import KeyframeSearcher as JSearcher
from tstar_tpu.search.state import init_state as jinit
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu.video.cache import FrameCache as JFrameCache
from tstar_tpu.viz import artifacts as jart
from tstar_tpu_torch.framework.heuristics import OwlVitHeuristic, initialize_heuristic
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THash
from tstar_tpu_torch.ops import smoother as tsm
from tstar_tpu_torch.parallel import batched as tbat
from tstar_tpu_torch.search import detector_scorer as tds
from tstar_tpu_torch.search import engine as teng
from tstar_tpu_torch.search.scorers import TableScorer
from tstar_tpu_torch.search.searcher import KeyframeSearcher
from tstar_tpu_torch.search.snapshot import load_state, save_state
from tstar_tpu_torch.search.state import init_state as tinit
from tstar_tpu_torch.search.state import stack_states
from tstar_tpu_torch.search.step_graphs import StepStats
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig
from tstar_tpu_torch.video import cache as tcache
from tstar_tpu_torch.video.synthetic import default_scene, scene_variant
from tstar_tpu_torch.viz import artifacts as tart


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
TOL = 1e-5          # P, scores, grid confidences, detection scores
BOX_TOL = 1e-2      # detection boxes, in pixels


def configs(**overrides):
    kw = {**BASE, **overrides}
    return JSearchConfig(**kw), TSearchConfig(**kw)


@pytest.fixture(scope="module")
def owl():
    """(reference model, variables, port model, host caches of 2 videos: the
    first two of ``tests/test_torch_batched.py``'s, whose searches that file
    holds equal to the reference's; the fixture where the two part is
    ``test_batched_history_knife_edge_witness``'s)."""
    jmodel = jow.OwlViTDetector(tiny_pair(jow), dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32)
    )
    tmodel = tow.OwlViTDetector(tiny_pair(tow))
    tmodel.load_state_dict(tow.params_from_jax(variables), strict=True)
    tmodel.requires_grad_(False)
    _, tcfg = configs()
    hosts = [tcache.build_frame_cache_host("mem://v", tcfg, decoder=d) for d in decoders()[:2]]
    return jmodel, variables, tmodel, hosts


def _owl_scorers(owl, host, jcfg, tcfg):
    jmodel, variables, tmodel, _ = owl
    js = jds.make_owlvit_scorer(jmodel, variables, jnp.asarray(host.frames), TARGETS, CUES,
                                JHash(100, 8), jcfg)
    ts = tds.make_owlvit_scorer(tmodel, torch.from_numpy(host.frames), TARGETS, CUES,
                                THash(100, 8), tcfg)
    return js, ts


def _assert_entry(got, want, it, video=None, p_rtol=0.0):
    where = f"iteration {it}" + ("" if video is None else f" video {video}")

    def pick(a):
        return np.asarray(a) if video is None else np.asarray(a)[video]

    for k in ("secs", "visited"):
        np.testing.assert_array_equal(pick(got[k]), pick(want[k]), err_msg=f"{k}, {where}")
    for k in ("scores", "conf"):
        np.testing.assert_allclose(pick(got[k]), pick(want[k]), atol=TOL, err_msg=f"{k}, {where}")
    np.testing.assert_allclose(pick(got["P"]), pick(want["P"]), atol=TOL, rtol=p_rtol,
                               err_msg=f"P, {where}")
    assert ("detections" in got) == ("detections" in want)
    if "detections" in want:
        g, w = got["detections"], want["detections"]
        for k in ("class_ids", "valid"):
            np.testing.assert_array_equal(pick(g[k]), pick(w[k]), err_msg=f"det {k}, {where}")
        np.testing.assert_allclose(pick(g["scores"]), pick(w["scores"]), atol=TOL,
                                   err_msg=f"det scores, {where}")
        np.testing.assert_allclose(pick(g["boxes"]), pick(w["boxes"]), atol=BOX_TOL,
                                   err_msg=f"det boxes, {where}")


def port_history_matches(ref, ts, tcfg, host, seed, n_targets=2, p_rtol=0.0):
    """The port's ``run_search_with_history`` on the reference's noise held
    against the reference's run ``ref`` = (final, keyframe secs, history):
    every entry, the keyframes, the remaining targets, two host reads a
    step.  -> the port's history."""
    jfinal, jsecs, jhist = ref
    noise = iter(jax_noise(seed, host.n_pad, len(jhist)))
    state = tinit(host.n_valid, n_targets, tcfg, noise, n_pad=host.n_pad)
    stats = StepStats()
    tfinal, tsecs, thist = teng.run_search_with_history(state, ts, tcfg, stats=stats)
    assert len(thist) == len(jhist) == stats.steps >= 3
    for it, (g, w) in enumerate(zip(thist, jhist)):
        _assert_entry(g, w, it, p_rtol=p_rtol)
    np.testing.assert_array_equal(tsecs.numpy(), np.asarray(jsecs))
    np.testing.assert_array_equal(tfinal.remaining.numpy(), np.asarray(jfinal.remaining))
    assert stats.host_reads == 2 * stats.steps
    return thist


def test_history_matches_reference_owlvit(owl):
    jcfg, tcfg = configs()
    host = owl[3][0]
    js, ts = _owl_scorers(owl, host, jcfg, tcfg)
    s0 = jinit(host.n_valid, 2, jcfg, jax.random.key(3), n_pad=host.n_pad)
    thist = port_history_matches(jeng.run_search_with_history(s0, js, jcfg), ts, tcfg, host,
                                 seed=3)
    dets = thist[0]["detections"]
    assert dets["scores"].shape == (16,) and dets["boxes"].shape == (16, 4)   # 4x4 patches
    assert dets["valid"].any()


def test_history_keyframes_equal_search():
    """On the port alone, with a generator: ``search_with_visualization``
    returns ``search()``'s keyframes, one history row a step, two host reads
    a step, and the detections trimmed to the valid boxes."""
    heur = initialize_heuristic("owl-vit-random", device="cpu", dtype=torch.float32,
                                model_config=tiny_pair(tow), seed=2)
    runs = []
    for visual in (False, True):
        s = KeyframeSearcher("mem://scene", heur, TARGETS, CUES, search_budget=0.5,
                             config=TSearchConfig(cache_hw=(32, 64)), seed=5,
                             decoder=default_scene(300.0, hw=(72, 128)))
        _, stamps = s.search_with_visualization() if visual else s.search()
        runs.append((stamps, s))
    (stamps, plain), (v_stamps, visual) = runs
    assert v_stamps == stamps
    steps = visual.step_stats.steps
    assert len(visual.P_history) == len(visual.sampled_history) == steps == len(
        visual.detect_bbox_iters) >= 2
    assert visual.step_stats.host_reads == 2 * steps
    assert len(visual.P_history[-1]) == visual.total_frame_num
    np.testing.assert_allclose(visual.P_history[-1], plain.P, atol=0)
    assert len(plain.P_history) == 1          # search() records the final state only
    assert plain.detect_bbox_iters == []
    for d in visual.detect_bbox_iters:
        assert set(d) == {"boxes", "scores", "class_ids"}
        assert d["boxes"].shape == (len(d["scores"]), 4) and (d["scores"] > 0.005).all()


def _batched_both(owl, hosts, seeds):
    """B = len(hosts) through the reference's ``run_search_batched_with_history``
    and the port's, on the reference's noise: (reference history, port
    history, the reference's iterations); the final keyframes and iterations
    are held equal when every step agrees."""
    jcfg, tcfg = configs()
    pairs = [_owl_scorers(owl, h, jcfg, tcfg) for h in hosts]
    jb = jbat.stack_scorers([p[0] for p in pairs], jcfg)
    tb = tbat.stack_scorers([p[1] for p in pairs], tcfg)
    n_pad = hosts[0].n_pad
    cap = jcfg.iteration_cap(hosts[0].n_valid)
    jstates = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
        jinit(h.n_valid, 2, jcfg, jax.random.key(s), n_pad=n_pad) for h, s in zip(hosts, seeds)])
    jfinal, jsecs, jhist = jbat.run_search_batched_with_history(jstates, jb, jcfg, cap)
    iters = np.asarray(jfinal.iteration)
    tstates = stack_states([
        tinit(h.n_valid, 2, tcfg, iter(jax_noise(s, n_pad, int(n))), n_pad=n_pad)
        for h, s, n in zip(hosts, seeds, iters)])
    stats = StepStats()
    tfinal, tsecs, thist = tbat.run_search_batched_with_history(tstates, tb, tcfg, cap,
                                                                stats=stats)
    assert len(thist) == len(jhist) >= 3
    assert stats.host_reads == 2 * stats.steps
    for g, w in zip(thist, jhist):
        np.testing.assert_array_equal(g["active"], np.asarray(w["active"]))
    if all(np.array_equal(g["secs"], np.asarray(w["secs"])) for g, w in zip(thist, jhist)):
        np.testing.assert_array_equal(tsecs.numpy(), np.asarray(jsecs))
        np.testing.assert_array_equal(tfinal.iteration.numpy(), iters)
    return jhist, thist


def test_batched_history_matches_reference(owl):
    """B = 2 through the reference's ``run_search_batched_with_history`` and
    the port's: each step's active mask and, per active video, its entry."""
    jhist, thist = _batched_both(owl, owl[3], seeds=(3, 11))
    for it, (g, w) in enumerate(zip(thist, jhist)):
        for v in range(2):
            if w["active"][v]:
                _assert_entry(g, w, it, video=v)


def _sampling_mask(P, visited, n_valid, k, q, dtype):
    """The sampler's quartile mask of one row (``sample_secs``): the weights
    (P + K/N) on unvisited valid seconds against their q-th percentile ->
    (mask, weight - threshold)."""
    valid = np.arange(P.shape[0]) < n_valid
    weights = (P.astype(dtype) + dtype(k) / dtype(n_valid)) * valid * ~visited
    thr = np.percentile(weights[valid], q)
    return weights >= thr, weights - thr


def _smoother64(y, w, n_valid, smoothing):
    """The smoother of ``ops/smoother.py`` in float64 by dense solves:
    (P, log10 lam): the largest lam of the same 145-point sweep whose
    weighted residual stays within ``smoothing``, then floor, sigmoid,
    normalize."""
    n, n_pad = n_valid, y.shape[0]
    d = np.zeros((n - 2, n))
    i = np.arange(n - 2)
    d[i, i], d[i, i + 1], d[i, i + 2] = 1.0, -2.0, 1.0
    y, w = y[:n], w[:n]
    best = (0, None)
    for j, log_lam in enumerate(np.linspace(-5.0, 5.0, 145)):
        f = np.linalg.solve(np.diag(w) + 10.0 ** log_lam * d.T @ d, w * y)
        if j == 0 or np.sum(w * (f - y) ** 2) <= smoothing:
            best = (log_lam, f)
    log_lam, f = best
    p = 1.0 / (1.0 + np.exp(-np.maximum(f, 1.0 / n)))
    return np.pad(p / p.sum(), (0, n_pad - n)), log_lam


def test_batched_history_knife_edge_witness(owl):
    """ROADMAP queue 3 item 11, held so that it cannot widen unseen.  On
    ``scene_variant(0 / 1, 300.0)`` at seeds (3, 11) the two packages'
    batched histories agree at every step of video 0 and at steps 0-1 of
    video 1, and video 1 samples other seconds from step 2.  The quartile
    masks that step 2 samples under part only at seconds whose weight lies
    within 1e-6 of the threshold in both packages.  The witness: the same
    smoother solved densely in float64 picks the same lam and puts each of
    those seconds on the port's side; its mask also differs from BOTH float32
    masks at more seconds than they differ from each other, since float32
    rounding moves this ill-conditioned fit's ``P`` (~8e-5) far more than
    the packages part (~1.4e-6)."""
    _, tcfg = configs()
    hosts = [tcache.build_frame_cache_host("mem://v", tcfg, decoder=scene_variant(i, 300.0))
             for i in range(2)]
    jhist, thist = _batched_both(owl, hosts, seeds=(3, 11))
    for it, (g, w) in enumerate(zip(thist, jhist)):
        _assert_entry(g, w, it, video=0)
        if it < 2:
            _assert_entry(g, w, it, video=1)
    assert not np.array_equal(thist[2]["secs"][1], np.asarray(jhist[2]["secs"][1]))

    n, k, q = hosts[1].n_valid, tcfg.frames_per_iteration, tcfg.top_percentile
    visited = thist[1]["visited"][1]
    np.testing.assert_array_equal(visited, np.asarray(jhist[1]["visited"][1]))
    m_ref, gap_ref = _sampling_mask(np.asarray(jhist[1]["P"][1]), visited, n, k, q, np.float32)
    m_port, gap_port = _sampling_mask(thist[1]["P"][1], visited, n, k, q, np.float32)
    parted = np.nonzero(m_ref != m_port)[0]
    assert 0 < len(parted) <= 2
    assert np.abs(gap_ref[parted]).max() < 1e-6 and np.abs(gap_port[parted]).max() < 1e-6

    y = thist[1]["scores"][1].astype(np.float64)
    p64, log_lam64 = _smoother64(y, visited.astype(np.float64), n, tcfg.spline_smoothing)
    _, log_lam32 = tsm.fit_smoother(torch.from_numpy(y.astype(np.float32)),
                                    torch.from_numpy(visited.astype(np.float32)), n)
    assert abs(log_lam64 - float(log_lam32)) < 1e-5
    m64, gap64 = _sampling_mask(p64, visited, n, k, q, np.float64)
    print(f"knife edge: seconds {parted.tolist()}, weight - threshold: reference "
          f"{gap_ref[parted].tolist()}, port {gap_port[parted].tolist()}, float64 "
          f"{gap64[parted].tolist()}; log10 lam {log_lam64} (float64) {float(log_lam32)} (port); "
          f"|P_port - P_ref| {np.abs(thist[1]['P'][1] - np.asarray(jhist[1]['P'][1])).max()}, "
          f"|P64 - P_ref| {np.abs(p64 - np.asarray(jhist[1]['P'][1])).max()}, "
          f"|P64 - P_port| {np.abs(p64 - thist[1]['P'][1]).max()}; float64 mask differs from "
          f"the reference's at {(m64 != m_ref).sum()} seconds, from the port's at "
          f"{(m64 != m_port).sum()}")
    np.testing.assert_array_equal(m64[parted], m_port[parted])
    assert np.abs(gap64[parted]).min() > 1e-6             # no knife edge in float64
    assert min((m64 != m_ref).sum(), (m64 != m_port).sum()) > len(parted)


def test_search_videos_history_equals_plain():
    """``search_videos(collect_history=True)``: the same keyframes and
    iterations as without, and each row's histories hold that video's
    steps."""
    from tstar_tpu_torch.parallel.multi_video import VideoTask, search_videos

    heur = initialize_heuristic("owl-vit-random", device="cpu", dtype=torch.float32,
                                model_config=tiny_pair(tow), seed=1)
    cfg = TSearchConfig(search_budget=0.5, cache_hw=(32, 64), confidence_threshold=2.0)

    def tasks():
        return [VideoTask(f"mem://v{i}", ["couch"], ["tv"], seed=i,
                          decoder=scene_variant(i, 200.0 + 50 * i)) for i in range(2)]

    plain = search_videos(tasks(), heur, cfg)
    hist = search_videos(tasks(), heur, cfg, collect_history=True)
    for p, h in zip(plain, hist):
        assert h["keyframe_secs"] == p["keyframe_secs"] and h["iterations"] == p["iterations"]
        n = h["iterations"]
        assert len(h["P_history"]) == len(h["sampled_history"]) == len(h["detect_bbox_iters"]) == n
        assert all(len(s) == 16 for s in h["sampled_history"])
        assert "P_history" not in p


def test_snapshot_generator_round_trips_on_its_device(tmp_path):
    """A state saved from the CPU loads on the CPU with its generator in the
    saved state: the next draws are the ones the saved generator makes
    (``tests/test_torch_cuda_framework.py`` holds the card's twin)."""
    rng = torch.Generator().manual_seed(7)
    torch.rand(100, generator=rng)                       # a generator part-way through
    state = tinit(200, 1, TSearchConfig(), rng, n_pad=256, device="cpu")
    path = save_state(state, str(tmp_path / "cpu.npz"))
    loaded = load_state(path, device="cpu")
    assert loaded.rng.device.type == "cpu" and loaded.P.device.type == "cpu"
    assert torch.equal(torch.rand(64, generator=loaded.rng), torch.rand(64, generator=rng))


def test_snapshot_resumes_the_trajectory(tmp_path):
    """A snapshot taken after two steps resumes to the uninterrupted
    search's keyframes, scores and iterations (the generator's state is in
    the snapshot)."""
    n_valid, n_pad = 200, 256
    g = torch.Generator().manual_seed(9)
    conf = torch.rand(n_pad, generator=g)
    pres = torch.zeros(n_pad, 16, dtype=torch.bool)
    pres[150:160, 0] = True
    scorer = TableScorer(conf, pres, conf * 0.5, pres)
    cfg = TSearchConfig(search_budget=1.0)

    def fresh():
        return tinit(n_valid, 1, cfg, torch.Generator().manual_seed(0), n_pad=n_pad)

    full, secs_full = teng.run_search(fresh(), scorer, cfg)
    state = fresh()
    for _ in range(2):
        state, _ = teng.search_step(state, scorer, cfg)
    path = save_state(state, str(tmp_path / "snap" / "state.npz"))
    resumed = load_state(path, device="cpu")
    for name in ("scores", "visited", "P", "remaining"):
        assert torch.equal(getattr(resumed, name), getattr(state, name)), name
    assert (resumed.budget, resumed.n_valid, resumed.iteration) == (
        state.budget, state.n_valid, state.iteration)
    final, secs = teng.run_search(resumed, scorer, cfg)
    assert secs.tolist() == secs_full.tolist()
    assert torch.equal(final.scores, full.scores) and final.iteration == full.iteration

    # the searcher's surface: save, restore, search again
    heur = initialize_heuristic("color-probe", device="cpu")
    s = KeyframeSearcher("mem://scene", heur, ["couch"], ["tv"], config=TSearchConfig(),
                         seed=1, decoder=default_scene(120.0))
    s.save_snapshot(str(tmp_path / "s0.npz"))
    _, first = s.search()
    s.restore_snapshot(str(tmp_path / "s0.npz"))
    _, again = s.search()
    assert again == first


def test_grid_images_match_reference(owl):
    """The port's grids against the reference's ``cv2.resize`` renders of
    the same cache and seconds (|diff| <= 1 level), and the annotated grids
    from the same detections."""
    jmodel, variables, tmodel, hosts = owl
    host = hosts[0]
    _, tcfg = configs(confidence_threshold=2.0)
    heur = OwlVitHeuristic(device="cpu", dtype=torch.float32, model_config=tiny_pair(tow))
    heur.model.load_state_dict(tmodel.state_dict())
    heur.tokenizer = THash(100, 8)
    s = KeyframeSearcher("mem://v", heur, TARGETS, CUES, config=tcfg, seed=0,
                         cache=host.to_device("cpu"), decoder=decoders()[0])
    s.search_with_visualization()
    jheur = JOwlHeuristic.__new__(JOwlHeuristic)
    jheur.model, jheur.variables, jheur.tokenizer = jmodel, variables, JHash(100, 8)
    jcfg = JSearchConfig(**BASE, confidence_threshold=2.0)
    cache = JFrameCache(frames=jnp.asarray(host.frames), n_valid=host.n_valid,
                        raw_fps=host.raw_fps, duration=host.duration)
    ref = JSearcher("unused.mp4", jheur, TARGETS, CUES, config=jcfg, seed=0, cache=cache)
    ref.sampled_history = s.sampled_history
    ref.detect_bbox_iters = s.detect_bbox_iters
    assert len(s.sampled_history) >= 2
    for annotate in (False, True):
        got, want = s.grid_images(annotate=annotate), ref.grid_images(annotate=annotate)
        assert len(got) == len(want) == len(s.sampled_history)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (4 * 95, 4 * 200, 3) and g.dtype == np.uint8
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    secs = s.sampled_history[0]
    got = tart.render_grid_image(host.frames, secs, (4, 4), (95, 200))
    want = jart.render_grid_image(host.frames, secs, (4, 4), (95, 200))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert len(s.detect_annotot_iters) == len(s.sampled_history)
