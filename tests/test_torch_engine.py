"""The port's search engine (tstar_tpu_torch/search) against the reference's
(tstar_tpu/search), step for step, on the same per-second detector tables.

Both consume the same Gumbel noise: the port replays the draws of the
reference's key schedule (one split per step, the draw used from iteration 1
on; one split for the final pop), as ``tests/test_engine.py`` does for
``tests/oracle.py``.  The sampled seconds of every iteration, the visited and
remaining masks and the keyframes must then be equal.  Scores are written,
splatted and verified with the same float32 arithmetic (1e-6); P comes out of
the smoother, whose float32 solve is ill-conditioned where few seconds are
visited or the video is short (``tests/test_torch_ops.py``): 5e-3 relative
(seen: 1.4e-3 at N=20).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import OracleTables, make_synthetic_tables
from tstar_tpu.search import engine as jeng
from tstar_tpu.search.scorers import TableScorer as JTable
from tstar_tpu.search.state import init_state as jinit
from tstar_tpu.utils.config import SearchConfig
from tstar_tpu_torch.search import engine as teng
from tstar_tpu_torch.search.scorers import TableScorer as TTable
from tstar_tpu_torch.search.state import init_state as tinit
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file
    several-fold; its tiny shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = SearchConfig(search_budget=1.0, confidence_threshold=0.6)


def port_config(config: SearchConfig) -> TSearchConfig:
    """The port's own SearchConfig with the same field values as ``config``."""
    return TSearchConfig(**{f.name: getattr(config, f.name) for f in dataclasses.fields(config)})


def jax_noise(seed: int, n_pad: int, n_steps: int, pop: bool = True):
    """The reference engine's Gumbel draws, in the order the port uses them."""
    rng = jax.random.key(seed)
    out = []
    for it in range(n_steps):
        rng, k = jax.random.split(rng)
        if it > 0:  # iteration 0 samples by stride and draws nothing
            out.append(np.asarray(jax.random.gumbel(k, (n_pad,), jnp.float32)))
    if pop:
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(k, (n_pad,), jnp.float32)))
    return out


def run_both(n_valid, n_targets, seed, config, tables):
    n_pad = config.padded_frames(n_valid)
    jscorer = JTable(*(jnp.asarray(a) for a in dataclasses.astuple(tables)))
    s0 = jinit(n_valid, n_targets, config, jax.random.key(seed), n_pad=n_pad)
    jfinal, jsecs, history = jeng.run_search_with_history(s0, jscorer, config)

    tscorer = TTable(*(torch.from_numpy(np.asarray(a)) for a in dataclasses.astuple(tables)))
    noise = iter(jax_noise(seed, n_pad, len(history), pop=not config.deterministic_pop))
    tconfig = port_config(config)
    state = tinit(n_valid, n_targets, tconfig, noise, n_pad=n_pad)
    t_hist = []
    while teng._continue(state):
        state, aux = teng.search_step(state, tscorer, tconfig)
        t_hist.append(aux["secs"].numpy())
    tsecs = teng.pop_frame_secs(state, tconfig)
    return (jfinal, np.asarray(jsecs), [h["secs"] for h in history]), (state, tsecs.numpy(), t_hist)


def assert_same_search(j, t):
    (jfinal, jsecs, jhist), (tfinal, tsecs, thist) = j, t
    assert len(thist) == len(jhist)
    for it, (a, b) in enumerate(zip(thist, jhist)):
        np.testing.assert_array_equal(a, b, err_msg=f"iteration {it}")
    np.testing.assert_array_equal(tfinal.visited.numpy(), np.asarray(jfinal.visited))
    np.testing.assert_array_equal(tfinal.remaining.numpy(), np.asarray(jfinal.remaining))
    np.testing.assert_allclose(tfinal.scores.numpy(), np.asarray(jfinal.scores), rtol=1e-6)
    np.testing.assert_allclose(tfinal.P.numpy(), np.asarray(jfinal.P), rtol=5e-3, atol=1e-7)
    assert tfinal.budget == int(jfinal.budget)
    assert tfinal.iteration == int(jfinal.iteration)
    np.testing.assert_array_equal(tsecs, jsecs)


@pytest.mark.parametrize(
    "seed,overrides",
    [
        (0, {}),                                        # bucketed + adaptive width
        (1, {"verify_batch": None}),                    # one K-wide rescore
        (2, {"verify_adaptive": False, "verify_batch": 5}),  # clamped last round
        (3, {"deterministic_pop": True}),
    ],
)
def test_search_matches_reference(seed, overrides):
    cfg = dataclasses.replace(CFG, **overrides)
    n_valid, n_targets = 300, 2
    n_pad = cfg.padded_frames(n_valid)
    tables = make_synthetic_tables(
        n_pad, n_valid, cfg.max_objects, n_targets, seed=seed + 1000, event_density=0.1
    )
    assert_same_search(*run_both(n_valid, n_targets, seed, cfg, tables))


def test_starved_fallback_matches_reference():
    """n_valid=20, K=16: after iteration 0 the quartile mask starves and the
    sampler falls back to resampling visited seconds."""
    cfg = dataclasses.replace(CFG, search_budget=2.5, budget_cap=48)
    n_pad = cfg.padded_frames(20)
    rng = np.random.default_rng(500)
    conf = np.zeros(n_pad, np.float32)
    conf[:20] = rng.random(20, dtype=np.float32) * 0.4
    tables = OracleTables(
        grid_conf=conf,
        grid_presence=np.zeros((n_pad, cfg.max_objects), bool),
        verify_conf=np.zeros(n_pad, np.float32),
        verify_presence=np.zeros((n_pad, cfg.max_objects), bool),
    )
    j, t = run_both(20, 1, 0, cfg, tables)
    assert len(t[2]) == 3
    assert_same_search(j, t)


def test_verification_replay_matches_reference():
    rng = np.random.default_rng(7)
    k, t_max = 16, CFG.max_targets
    scores = rng.random(128).astype(np.float32)
    remaining = np.arange(t_max) < 3
    secs = rng.choice(128, k, replace=False).astype(np.int32)
    tp = rng.random((k, t_max)) < 0.3
    vconf = rng.random(k).astype(np.float32)
    vp = rng.random((k, t_max)) < 0.5
    want = jeng.verification_replay(*map(jnp.asarray, (scores, remaining, secs, tp, vconf, vp)), CFG)
    got = teng.verification_replay(
        *map(torch.from_numpy, (scores, remaining, secs, tp, vconf, vp)), port_config(CFG)
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_init_state_matches_reference():
    for n_valid, budget in [(600, 0.5), (3000, 1.0), (77, 0.1)]:
        cfg = dataclasses.replace(CFG, search_budget=budget)
        j = jinit(n_valid, 3, cfg, jax.random.key(0))
        t = tinit(n_valid, 3, port_config(cfg), None)
        for name in ("scores", "visited", "P", "remaining"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
        assert t.budget == int(j.budget) and t.n_valid == int(j.n_valid)
