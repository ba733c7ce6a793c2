"""The port's reference-fidelity verification (``search/reference_verify.py``,
``OwlVitScorer.score_verify_raw``) against the JAX package's, on the CPU.

On a 60 s mp4 that the reference's ``write_synthetic_video`` writes (48x64,
a planted couch) and the tiny OWL-ViT with the reference's weights:

  * ``run_search_reference_verify`` with ONE shared numpy frame source (the
    reference's raw frames, resized by cv2) and the reference's Gumbel
    draws replayed makes the same decisions (iteration, second, removed
    slot; the rescore within 1e-5) and pops the same keyframes;
  * fed the frame cache's own rows it is the engine's search exactly;
  * ``make_raw_frame_source``'s frames lie within one level of the
    reference's cv2-resized ones;
  * ``score_verify_raw`` gives the reference's confidences within 1e-5 and
    its presence exactly.

Runs only where cv2 imports (it writes the video and resizes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_noise
from tests.test_torch_owlvit import tiny_pair
from tstar_tpu.models import owlvit as jow
from tstar_tpu.models.clip_tokenizer import HashTokenizer as JHash
from tstar_tpu.search import detector_scorer as jds
from tstar_tpu.search import reference_verify as jrv
from tstar_tpu.search.state import init_state as jinit
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu.video.cache import build_frame_cache as jbuild
from tstar_tpu.video.synthetic import PlantedObject, write_synthetic_video
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THash
from tstar_tpu_torch.search import detector_scorer as tds
from tstar_tpu_torch.search import engine as teng
from tstar_tpu_torch.search import reference_verify as trv
from tstar_tpu_torch.search.state import init_state as tinit
from tstar_tpu_torch.search.step_graphs import StepStats
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig
from tstar_tpu_torch.video.cache import build_frame_cache as tbuild

cv2 = pytest.importorskip("cv2")

BASE = dict(search_budget=1.0, cache_hw=(32, 64), confidence_threshold=0.2)
TARGETS, CUES = ["lamp", "red couch"], ["tv"]   # 18 decisions, one removal
TOL = 1e-5
SEED = 7


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rv") / "v.mp4")
    write_synthetic_video(path, duration_sec=60.0, fps=10.0, hw=(48, 64), objects=[
        PlantedObject("couch", (20.0, 26.0), (200, 40, 40), (0.5, 0.5), 0.4)])
    jcfg, tcfg = JSearchConfig(**BASE), TSearchConfig(**BASE)
    jmodel = jow.OwlViTDetector(tiny_pair(jow), dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32))
    tmodel = tow.OwlViTDetector(tiny_pair(tow))
    tmodel.load_state_dict(tow.params_from_jax(variables), strict=True)
    tmodel.requires_grad_(False)
    jcache, tcache = jbuild(path, jcfg), tbuild(path, tcfg, device="cpu")
    js = jds.make_owlvit_scorer(jmodel, variables, jcache.frames, TARGETS, CUES,
                                JHash(100, 8), jcfg)
    ts = tds.make_owlvit_scorer(tmodel, tcache.frames, TARGETS, CUES, THash(100, 8), tcfg)
    return path, jcfg, tcfg, jcache, tcache, js, ts


@pytest.fixture(scope="module")
def shared_source(setup):
    """The reference's raw-frame source (its decoder, cv2's resize), its
    frames kept by second so the port reads the very same arrays."""
    path, jcfg = setup[0], setup[1]
    source = jrv.make_raw_frame_source(path, jcfg)
    seen = {}

    def shared(secs):
        missing = [s for s in secs if s not in seen]
        if missing:
            for s, f in zip(missing, source(missing)):
                seen[s] = f
        return np.stack([seen[s] for s in secs])

    yield shared
    source.close()


@pytest.fixture(scope="module")
def reference_run(setup, shared_source):
    _, jcfg, _, jcache, _, js, _ = setup
    s0 = jinit(jcache.n_valid, 2, jcfg, jax.random.key(SEED), n_pad=jcache.n_pad)
    final, secs, decisions = jrv.run_search_reference_verify(
        s0, js, jcfg, shared_source, collect_decisions=True)
    return final, np.asarray(secs), decisions


def _port_run(setup, source, steps, collect=True):
    _, _, tcfg, _, tcache, _, ts = setup
    state = tinit(tcache.n_valid, 2, tcfg, iter(jax_noise(SEED, tcache.n_pad, steps)),
                  n_pad=tcache.n_pad)
    stats = StepStats()
    final, secs, decisions = trv.run_search_reference_verify(
        state, ts, tcfg, source, collect_decisions=collect, stats=stats)
    return final, secs.numpy(), decisions, stats


def test_decisions_and_keyframes_match_reference(setup, shared_source, reference_run):
    jfinal, jsecs, jdec = reference_run
    tfinal, tsecs, tdec, stats = _port_run(setup, shared_source, int(jfinal.iteration))
    assert stats.steps == int(jfinal.iteration) >= 2
    assert len(tdec) == len(jdec) >= 1
    assert any(d["removed_slot"] is not None for d in jdec)
    for got, want in zip(tdec, jdec):
        assert {k: got[k] for k in ("iteration", "sec", "removed_slot")} == \
            {k: want[k] for k in ("iteration", "sec", "removed_slot")}
        assert abs(got["vconf"] - want["vconf"]) <= TOL
    np.testing.assert_array_equal(tsecs, jsecs)
    np.testing.assert_array_equal(tfinal.remaining.numpy(), np.asarray(jfinal.remaining))
    np.testing.assert_allclose(tfinal.scores.numpy(), np.asarray(jfinal.scores), atol=TOL)
    assert stats.verify_widths == [] and stats.host_reads == stats.steps   # flags only


def test_cache_frame_source_is_the_engines_search(setup):
    """Fed the frame cache's rows, the host verification is the engine's
    device verification: the same keyframes, state and iterations."""
    _, _, tcfg, _, tcache, _, ts = setup
    rows = tcache.frames.numpy()

    def state(seed):
        return tinit(tcache.n_valid, 2, tcfg, torch.Generator().manual_seed(seed),
                     n_pad=tcache.n_pad)

    fa, sa = teng.run_search(state(3), ts, tcfg)
    fb, sb, _ = trv.run_search_reference_verify(state(3), ts, tcfg,
                                                lambda secs: rows[np.asarray(secs)])
    np.testing.assert_array_equal(sa.numpy(), sb.numpy())
    np.testing.assert_array_equal(fa.remaining.numpy(), fb.remaining.numpy())
    np.testing.assert_allclose(fa.scores.numpy(), fb.scores.numpy(), atol=1e-6)
    assert fa.iteration == fb.iteration


def test_raw_frame_source_within_one_level(setup):
    path, jcfg, tcfg = setup[:3]
    secs = [0, 21, 23, 59, 37]
    want = jrv.make_raw_frame_source(path, jcfg)
    got = trv.make_raw_frame_source(path, tcfg)
    try:
        a, b = got(secs), want(secs)
    finally:
        got.close()
        want.close()
    assert a.shape == b.shape == (5, 285, 600, 3) and a.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_score_verify_raw_matches_reference(setup, shared_source):
    js, ts = setup[5], setup[6]
    frames = shared_source([20, 22, 5, 40])
    jconf, jpres = jax.jit(jds.OwlVitScorer.score_verify_raw)(js, jnp.asarray(frames))
    tconf, tpres = ts.score_verify_raw(torch.from_numpy(frames))
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), atol=TOL)
    np.testing.assert_array_equal(tpres.numpy(), np.asarray(jpres))
    # the cache rows through the raw path are the cache path's verification
    rows = setup[4].frames[torch.tensor([20, 22])]
    c1, p1 = ts.score_verify_raw(rows)
    c2, p2 = ts.score_verify(torch.tensor([20, 22]))
    np.testing.assert_array_equal(c1.numpy(), c2.numpy())
    np.testing.assert_array_equal(p1.numpy(), p2.numpy())
