"""A YOLO-World search on the port against the JAX package's, on the CPU in
f32: the reference's ``YoloWorldScorer`` and the port's heuristic over the
same ``yoloworld_small`` weights (the fixture of
``tests/test_torch_yoloworld.py``: the folded BN scales set for unit
variance, since at the default init every score is 0.5 within a few ulps and
every decision a tie) and a 2-layer text tower, on the same synthetic frame
cache, with the reference's Gumbel draws replayed.  Single and batched (B =
2: the reference vmaps its single-video step over the stacked scorer, the
port runs the flat batch methods): the seconds sampled in every iteration,
the keyframes, the iterations and the remaining targets are EQUAL; final
scores agree to 1e-5.  The single search's history (with the NMS'd
detections) is held entry by entry against the same reference run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_noise
from tests.test_torch_yoloworld import TEXT, small  # noqa: F401  (fixture)
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models import yoloworld as jy
from tstar_tpu.models.clip_tokenizer import HashTokenizer as JHash
from tstar_tpu.parallel import batched as jbat
from tstar_tpu.search import engine as jeng
from tstar_tpu.search.detector_scorer import build_prompt_batch as jprompts
from tstar_tpu.search.state import init_state as jinit
from tstar_tpu.search.yolo_scorer import YoloWorldScorer as JScorer
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu_torch.framework.heuristics import YoloWorldHeuristic
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models.owlvit import TextConfig as TTextConfig
from tstar_tpu_torch.models.yoloworld import YoloTextEncoder
from tstar_tpu_torch.parallel import batched as tbat
from tstar_tpu_torch.search import engine as teng
from tstar_tpu_torch.search.state import init_state as tinit
from tstar_tpu_torch.search.state import stack_states
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig
from tstar_tpu_torch.video import cache as tcache
from tstar_tpu_torch.video.synthetic import default_scene, scene_variant


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file
    several-fold; its tiny shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the search, against the reference's, on replayed noise -------------------

# confidence_threshold 2.0 (the reference bench's worst case): no target is
# confirmed, every step verifies, and the search spends its budget
BASE = dict(search_budget=0.5, cache_hw=(40, 80), confidence_threshold=2.0)
TARGETS, CUES = ["couch", "lamp"], ["tv"]


@pytest.fixture(scope="module")
def search_pair(small):
    """The reference's YOLO scorer pieces and the port's heuristic, same
    weights (detector from ``small``, a 2-layer text tower)."""
    jmodel, variables, tmodel, *_ = small
    jtext = jy.YoloTextEncoder(jow.TextConfig(**TEXT), projection_dim=64, dtype=jnp.float32)
    text_vars = jtext.init(jax.random.key(1), jnp.zeros((2, 8), jnp.int32),
                           jnp.ones((2, 8), jnp.int32))
    heur = YoloWorldHeuristic(size="small", device="cpu", dtype=torch.float32)
    heur.model.load_state_dict(tmodel.state_dict())
    heur.text_model = YoloTextEncoder(TTextConfig(**TEXT), projection_dim=64).eval()
    heur.text_model.load_state_dict(tow.params_from_jax(text_vars))
    heur.tokenizer = type(heur.tokenizer)(100, 8)
    return jmodel, variables, jtext, text_vars, heur


def _jscorer(pair, frames, cfg):
    jmodel, variables, jtext, text_vars, _ = pair
    ids, mask, weights = jprompts(TARGETS, CUES, JHash(100, 8), cfg)
    return JScorer(
        cache=jnp.asarray(frames), variables=variables,
        text_embeds=jtext.apply(text_vars, jnp.asarray(ids), jnp.asarray(mask)).astype(jnp.float32),
        query_mask=jnp.asarray(ids[:, 0] > 0), class_weights=jnp.asarray(weights),
        model=jmodel, config=cfg,
    )


@pytest.fixture(scope="module")
def scene_run(search_pair):
    """The reference's history search on the synthetic 300 s scene at seed
    4: (host cache, reference scorer, (final, keyframe secs, history))."""
    jcfg, tcfg = JSearchConfig(**BASE), TSearchConfig(**BASE)
    host = tcache.build_frame_cache_host("mem://scene", tcfg, decoder=default_scene(300.0))
    js = _jscorer(search_pair, host.frames, jcfg)
    s0 = jinit(host.n_valid, len(TARGETS), jcfg, jax.random.key(4), n_pad=host.n_pad)
    return host, js, jeng.run_search_with_history(s0, js, jcfg)


def test_search_matches_reference(search_pair, scene_run):
    tcfg = TSearchConfig(**BASE)
    host, js, (jfinal, jsecs, history) = scene_run
    assert len(history) >= 3

    heur = search_pair[4]
    ts = heur.build_scorer(torch.from_numpy(host.frames), TARGETS, CUES, tcfg)
    torch.testing.assert_close(ts.text_embeds, torch.from_numpy(np.asarray(js.text_embeds)),
                               atol=1e-6, rtol=1e-5)
    noise = iter(jax_noise(4, host.n_pad, len(history)))
    state = tinit(host.n_valid, len(TARGETS), tcfg, noise, n_pad=host.n_pad)
    it = 0
    with torch.no_grad():
        while teng._continue(state):
            state, aux = teng.search_step(state, ts, tcfg)
            np.testing.assert_array_equal(aux["secs"].numpy(), history[it]["secs"],
                                          err_msg=f"iteration {it}")
            it += 1
        tsecs = teng.pop_frame_secs(state, tcfg)
    assert it == len(history)
    np.testing.assert_array_equal(tsecs.numpy(), np.asarray(jsecs))
    np.testing.assert_array_equal(state.remaining.numpy(), np.asarray(jfinal.remaining))
    np.testing.assert_allclose(state.scores.numpy(), np.asarray(jfinal.scores), atol=1e-5)


def test_history_matches_reference_yolo(search_pair, scene_run):
    """The port's history search against the reference's, entry by entry
    (``tests/test_torch_history.py``'s tolerances): ``score_grid_detailed``
    is the NMS'd set, ``valid`` NMS's keep.  ``P`` within 1e-2 relative (the
    module docstring there)."""
    from tests.test_torch_history import port_history_matches

    host, _, ref = scene_run
    tcfg = TSearchConfig(**BASE)
    ts = search_pair[4].build_scorer(torch.from_numpy(host.frames), TARGETS, CUES, tcfg)
    thist = port_history_matches(ref, ts, tcfg, host, seed=4, p_rtol=1e-2)
    assert thist[0]["detections"]["valid"].any()


def test_batched_search_matches_reference(search_pair):
    """B = 2 videos: the reference vmaps its single-video step over the
    stacked YOLO scorer; the port runs the flat batch methods."""
    jcfg, tcfg = JSearchConfig(**BASE), TSearchConfig(**BASE)
    hosts = [tcache.build_frame_cache_host(f"mem://v{i}", tcfg, decoder=scene_variant(i, 300.0))
             for i in range(2)]
    seeds = (5, 9)
    jscorers = [_jscorer(search_pair, h.frames, jcfg) for h in hosts]
    jb = jbat.stack_scorers(jscorers, jcfg)
    jstates = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[jinit(h.n_valid, 2, jcfg, jax.random.key(s), n_pad=h.n_pad) for h, s in zip(hosts, seeds)])
    cap = jcfg.iteration_cap(hosts[0].n_valid)
    jfinal, jsecs, hist = jbat.run_search_batched_with_history(jstates, jb, jcfg, cap)

    heur = search_pair[4]
    tscorers = [heur.build_scorer(torch.from_numpy(h.frames), TARGETS, CUES, tcfg) for h in hosts]
    iters = np.asarray(jfinal.iteration)
    assert len(hist) >= 3
    tstates = stack_states([
        tinit(h.n_valid, 2, tcfg, iter(jax_noise(s, h.n_pad, int(n))), n_pad=h.n_pad)
        for h, s, n in zip(hosts, seeds, iters)])
    tfinal, tsecs = tbat.run_search_batched_chained(
        tstates, tbat.stack_scorers(tscorers, tcfg), tcfg, cap)
    np.testing.assert_array_equal(tsecs.numpy(), np.asarray(jsecs))
    np.testing.assert_array_equal(tfinal.iteration.numpy(), np.asarray(jfinal.iteration))
    np.testing.assert_array_equal(tfinal.remaining.numpy(), np.asarray(jfinal.remaining))
    np.testing.assert_allclose(tfinal.scores.numpy(), np.asarray(jfinal.scores), atol=1e-5)


def test_stack_scorers_takes_yolo_scorers(search_pair):
    tcfg = TSearchConfig(**BASE)
    host = tcache.build_frame_cache_host("mem://v", tcfg, decoder=default_scene(120.0))
    heur = search_pair[4]
    s = heur.build_scorer(torch.from_numpy(host.frames), TARGETS, CUES, tcfg)
    stacked = tbat.stack_scorers([s, s], tcfg)
    assert stacked.cache.shape[0] == 2 and stacked.text_embeds.shape == (2, tcfg.max_objects, 64)
    assert stacked.model is s.model
    secs = torch.tensor([[3, 50], [7, 90]])
    conf, presence = stacked.score_verify_batch(secs)
    for i in range(2):
        c1, p1 = s.score_verify(secs[i])
        torch.testing.assert_close(conf[i], c1, atol=1e-6, rtol=1e-5)
        assert torch.equal(presence[i], p1)
    assert dataclasses.is_dataclass(stacked)
