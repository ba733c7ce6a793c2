"""A whole run of the search cell on the CPU at tiny sizes, past the look for
a card: sound, it comes out correct; with the timed path broken underneath,
it comes out not correct, once for each fault the cell can have.  (The
cell runs on one chip: there is no exchange between chips to leave out.)"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.manifest import Manifest
from benchmark.run import measure

from .conftest import CELL, PIPELINE


def _run(root, seed=7):
    m = Manifest(root, root / "benchmark")
    return measure(m, CELL, seed, 0.2, False, "cpu", time.perf_counter())


def test_sound_run_is_correct(tiny_root):
    result = _run(tiny_root)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: the update hands back the
    scores, visited seconds and distribution it was given."""
    from tstar_tpu_torch.search import step_graphs

    monkeypatch.setattr(step_graphs, "apply_grid_scores",
                        lambda scores, visited, valid, n_valid, secs, conf, cfg:
                        (scores, visited, torch.zeros_like(scores) + torch.where(
                            valid, 1.0 / n_valid[:, None].to(scores.dtype), 0.0)))


def _half_batch(monkeypatch):
    """Half of the bucket's videos left out of the grid forward, each given
    the mean of the scored half's confidences."""
    from tstar_tpu_torch.search.detector_scorer import OwlVitScorer

    full = OwlVitScorer._score_grid_batch_full

    def half(self, secs):
        conf, presence, raw = full(self, secs)
        h = max(1, conf.shape[0] // 2)
        conf = torch.cat([conf[:h], conf[:h].mean(dim=0, keepdim=True).expand_as(conf[h:])])
        return conf, presence, raw

    monkeypatch.setattr(OwlVitScorer, "_score_grid_batch_full", half)


def _answer_altered(monkeypatch):
    """The detector's answer for one frame of each grid canvas altered where
    it is produced."""
    from tstar_tpu_torch.search.detector_scorer import OwlVitScorer

    full = OwlVitScorer._score_grid_batch_full

    def altered(self, secs):
        conf, presence, raw = full(self, secs)
        conf = conf.clone()
        conf[:, 0] += 0.1
        return conf, presence, raw

    monkeypatch.setattr(OwlVitScorer, "_score_grid_batch_full", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(tiny_root)
    assert not result["correct"], result["checks"]


def _run_pipeline(root, seed=5):
    m = Manifest(root, root / "benchmark")
    return measure(m, PIPELINE, seed, 0.1, False, "cpu", time.perf_counter())


def _token_altered(monkeypatch):
    """One served token of each request altered where the decode picks it."""
    from tstar_tpu_torch.models import generate

    sample, calls = generate._sample, [0]

    def altered(logits, *args, **kw):
        token = sample(logits, *args, **kw)
        calls[0] += 1
        return (token + 1) % logits.shape[-1] if calls[0] % 7 == 3 else token

    monkeypatch.setattr(generate, "_sample", altered)


@pytest.mark.parametrize("fault", [None, _state_unchanged, _token_altered],
                         ids=lambda f: "sound" if f is None else f.__name__.strip("_"))
def test_pipeline_sound_and_broken(tiny_root, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    result = _run_pipeline(tiny_root)
    assert result["correct"] == (fault is None), result["checks"]
