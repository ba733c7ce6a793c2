"""The port's dataset half (``bench/metrics.py``, ``bench/datasets.py``,
``bench/evaluate.py``, ``bench/runner.py``, ``cli/dataset.py``,
``cli/evaluate.py``) against the JAX package's, on the CPU.

Two 60 s mp4s that the reference's ``write_synthetic_video`` writes (96x160,
a planted couch and tv) stand in for a dataset's videos; each package reads
them with its own decoder (byte-equal frames, ``tests/test_torch_decoder.py``).
The metrics agree with the reference's within 1e-5 (SSIM in both axis
conventions), the adapters' items and the QA rows are equal, and
``run_dataset`` with the fake grounder and the ``color-probe`` heuristic,
on the reference's replayed Gumbel draws, writes the reference's rows
(timestamps equal, the distribution within 1e-5).  Runs only where cv2
imports (it writes the videos).
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_noise
from tests.test_torch_owlvit import tiny_pair
from tstar_tpu.bench import datasets as jds
from tstar_tpu.bench import evaluate as jev
from tstar_tpu.bench import metrics as jm
from tstar_tpu.bench import runner as jrun
from tstar_tpu.cli import evaluate as jcli_eval
from tstar_tpu.framework import framework as jfw
from tstar_tpu.framework.heuristics import initialize_heuristic as jinit_heuristic
from tstar_tpu.grounding.fake import FakeGrounder as JFakeGrounder
from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu.video.synthetic import PlantedObject, write_synthetic_video
from tstar_tpu_torch.bench import datasets as tds
from tstar_tpu_torch.bench import evaluate as tev
from tstar_tpu_torch.bench import metrics as tm
from tstar_tpu_torch.bench import runner as trun
from tstar_tpu_torch.cli import dataset as tcli_dataset
from tstar_tpu_torch.cli import evaluate as tcli_eval
from tstar_tpu_torch.framework.heuristics import OwlVitHeuristic, initialize_heuristic
from tstar_tpu_torch.grounding.fake import FakeGrounder
from tstar_tpu_torch.models import owlvit as tow
from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer as THash
from tstar_tpu_torch.search import searcher as tsearcher
from tstar_tpu_torch.utils.config import SearchConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's thread pool spinning beside them slows this file
    several-fold; its tiny shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


cv2 = pytest.importorskip("cv2")

TOL = 1e-5
CACHE_HW = (48, 80)      # the runner's searches at a small cache (the CLI's keep the default)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    for i, (couch, tv) in enumerate((((20.0, 28.0), (5.0, 40.0)), ((41.0, 47.0), (30.0, 59.0)))):
        write_synthetic_video(str(root / f"v{i}.mp4"), duration_sec=60.0, fps=10.0,
                              hw=(96, 160), objects=[
                                  PlantedObject("couch", couch, (200, 40, 40), (0.55, 0.4), 0.45),
                                  PlantedObject("tv", tv, (40, 40, 200), (0.3, 0.75), 0.25)])
    rows = [
        {"video_id": "v0", "question": "What color is the couch?",
         "options": ["Red", "Blue", "Green"], "answer": "A",
         "frame_indexes_video": [200, 240, 270],
         "video_metadata": {"vclip_interval_in_video": [10.0, 50.0]}},
        {"video_id": "v1", "question": "Where is the tv?",
         "options": {"A": "left", "B": "right"}, "answer": "B",
         "frame_indexes_video": [300, 450]},
        {"video_id": "", "question": "no video id: skipped"},
    ]
    meta = root / "meta.json"
    meta.write_text(json.dumps(rows))
    return root, str(meta)


def test_temporal_and_annd_match_reference():
    rng = np.random.default_rng(0)
    gt = [rng.uniform(0, 600, n) for n in (3, 5, 0, 4)]
    pred = [rng.uniform(0, 600, n) for n in (8, 8, 8, 0)]
    pred[0][:2] = gt[0][:2] + 2.0
    for thr in (5.0, 30.0):
        np.testing.assert_allclose(tm.temporal_prf(gt, pred, thr), jm.temporal_prf(gt, pred, thr))
    np.testing.assert_allclose(tm.annd(gt, pred), jm.annd(gt, pred))
    assert tm.temporal_prf([], []) == (0.0, 0.0, 0.0) and tm.annd([], []) == (0.0, 0.0)


@pytest.mark.parametrize("convention", ["reference", "standard"])
def test_ssim_matches_reference(convention):
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (30, 44, 3), dtype=np.uint8)
    gt = [base, rng.integers(0, 256, (30, 44, 3), dtype=np.uint8)]
    pred = [np.clip(base.astype(int) + rng.integers(-20, 20, base.shape), 0, 255).astype(np.uint8),
            rng.integers(0, 256, (30, 44, 3), dtype=np.uint8), base]
    got = tm.pairwise_ssim(gt, pred, convention, device="cpu")
    np.testing.assert_allclose(got, jm.pairwise_ssim(gt, pred, convention), atol=TOL)
    assert got.shape == (2, 3) and abs(got[0, 2] - 1.0) < 1e-6
    np.testing.assert_allclose(tm.ssim_prf([gt, gt[:1]], [pred, []], convention, device="cpu"),
                               jm.ssim_prf([gt, gt[:1]], [pred, []], convention), atol=TOL)
    with pytest.raises(ValueError):
        tm.pairwise_ssim(gt, [base[:10]], convention, device="cpu")


def test_match_answer_matches_reference():
    for pred, gt in (("A", "A"), (" b) right", "B"), ("C. green", "a"), ("Red", "red"),
                     ("red", "blue"), ("", "A"), ("G", "g")):
        assert tm.match_answer(pred, gt) == jm.match_answer(pred, gt), (pred, gt)


def test_datasets_match_reference(videos, tmp_path):
    root, meta = videos
    got = tds.lvhaystack_to_tstar(video_root=str(root), local_json=meta)
    assert got == jds.lvhaystack_to_tstar(video_root=str(root), local_json=meta)
    assert len(got) == 2 and got[0]["options"] == "A) Red\nB) Blue\nC) Green"
    assert tds.lvhaystack_to_tstar(video_root=str(root), local_json=meta, cap=1) == got[:1]
    with pytest.raises(NotImplementedError, match="local_json"):
        tds.lvhaystack_to_tstar()
    lvb = [{"video_id": "a", "question": "q1", "candidates": ["x", "y"], "correct_choice": 1,
            "duration_group": 3600, "video_path": "a.mp4", "question_category": "S2E"},
           {"video_id": "b", "question": "q2", "candidates": ["x"], "duration_group": 600},
           {"video_id": "c", "question": "q3", "candidates": ["x"], "duration_group": 3600,
            "question_category": "T3O"},
           {"video_id": "d", "duration_group": 3600}]
    src = tmp_path / "lvb.json"
    src.write_text(json.dumps(lvb))
    out_t, out_j = tmp_path / "t.json", tmp_path / "j.json"
    got = tds.longvideobench_to_tstar(str(src), "vids", str(out_t))
    assert got == jds.longvideobench_to_tstar(str(src), "vids", str(out_j))
    assert json.loads(out_t.read_text()) == json.loads(out_j.read_text()) == got
    assert [it["gt_answer"] for it in got] == ["B"]
    jsonl = tmp_path / "r.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in got + got) + "\n")
    assert tds.load_results_json(str(jsonl)) == jds.load_results_json(str(jsonl)) == got + got


def _results(videos):
    root, meta = videos
    items = tds.lvhaystack_to_tstar(video_root=str(root), local_json=meta)
    items[0]["keyframe_timestamps"] = [19.0, 24.0, 33.0, 50.0]
    items[1]["keyframe_timestamps"] = [2.0, 44.5, 45.0]
    dist = np.zeros(60)
    dist[[21, 25, 44]] = [0.5, 0.3, 0.2]
    for it in items:
        it["keyframe_distribution"] = dist.tolist()
    missing = dict(items[1], video_path=str(root / "missing.mp4"), question="gone")
    return items + [missing]


@pytest.mark.parametrize("convention, ssim_tol", [("reference", TOL), ("standard", 1e-4)])
def test_evaluate_search_results_matches_reference(videos, convention, ssim_tol):
    """The temporal and ANND metrics equal, SSIM within ``ssim_tol``: on these
    flat synthetic frames the standard convention's variances cancel, and
    the reference's float32 ``lax.conv`` lies up to 5.5e-5 from a float64
    evaluation (the port computes in float64; random frames:
    ``test_ssim_matches_reference``, 1e-5 in both conventions)."""
    items = _results(videos)
    got = tev.evaluate_search_results(items, ssim_axis_convention=convention, max_workers=2,
                                      device="cpu")
    want = jev.evaluate_search_results(items, ssim_axis_convention=convention, max_workers=2)
    assert set(got) == set(want) and "Average SSIM F1 Score" in got
    for k in want:
        assert abs(got[k] - want[k]) <= (ssim_tol if "SSIM" in k else 1e-12), k


def test_qa_accuracy_matches_reference_and_resumes(videos, tmp_path):
    runs = {}
    for name, ev, grounder in (("port", tev, FakeGrounder(qa_answer="A")),
                               ("ref", jev, JFakeGrounder(qa_answer="A"))):
        out = str(tmp_path / f"{name}.jsonl")
        for sampling, duration, batch in (("uniform", "video", 1), ("TStar", "clip", 2)):
            acc, rows = ev.compute_qa_accuracy(
                [dict(it) for it in _results(videos)], grounder, nframe=4,
                sampling_type=sampling, duration_type=duration,
                output_file=out + sampling, qa_batch=batch)
            runs[name, sampling] = (acc, rows, [c["kind"] for c in grounder.calls])
    for sampling in ("uniform", "TStar"):
        assert runs["port", sampling][:2] == runs["ref", sampling][:2]
        acc, rows, _ = runs["port", sampling]
        assert acc == 0.5 and [r["qa_failed"] for r in rows] == [False, False, True]
    assert runs["port", "TStar"][2][-1] == "qa_batch"
    # a second run resumes from the file: no call, the same accuracy
    grounder = FakeGrounder(qa_answer="B")
    acc, rows = tev.compute_qa_accuracy(_results(videos), grounder, nframe=4,
                                        output_file=str(tmp_path / "port.jsonluniform"))
    assert acc == 0.5 and grounder.calls == [] and len(rows) == 3
    with pytest.raises(NotImplementedError):
        tev.compute_qa_accuracy([], grounder, sampling_type="random")


def test_extract_qa_frames_match_reference(videos):
    item = _results(videos)[0]
    for dist, duration in ((None, "video"), (item["keyframe_distribution"], "clip")):
        got = tev.extract_qa_frames(item["video_path"], item, dist, 4, duration)
        want = jev.extract_qa_frames(item["video_path"], item, dist, 4, duration)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_run_dataset_matches_reference(monkeypatch, videos, tmp_path):
    """Serial ``run_dataset`` over 2 items (fake grounder, ``color-probe``,
    verification off by a 2.0 threshold so each search spends its budget):
    the reference's rows, the port's search on the reference's noise; a
    rerun resumes from the manifest."""
    root, meta = videos
    searchers = []

    class Recording(jfw.KeyframeSearcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            searchers.append(self)

    monkeypatch.setattr(jfw, "KeyframeSearcher", Recording)
    kw = dict(confidence_threshold=2.0, search_budget=0.5)
    want = jrun.run_dataset(jds.lvhaystack_to_tstar(video_root=str(root), local_json=meta),
                            JFakeGrounder(["couch"], ["tv"]), jinit_heuristic("color-probe"),
                            str(tmp_path / "ref" / "out.json"),
                            config=JSearchConfig(cache_hw=CACHE_HW), **kw)
    noises = iter([iter(jax_noise(0, s.cache.n_pad, int(s._final_state.iteration)))
                   for s in searchers])
    real = tsearcher.init_state
    monkeypatch.setattr(tsearcher, "init_state",
                        lambda *a, **k: real(*a, **k).replace(rng=next(noises)))
    grounder = FakeGrounder(["couch"], ["tv"])
    out = str(tmp_path / "port" / "out.json")
    got = trun.run_dataset(tds.lvhaystack_to_tstar(video_root=str(root), local_json=meta),
                           grounder, initialize_heuristic("color-probe", device="cpu"), out,
                           config=SearchConfig(cache_hw=CACHE_HW), **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["keyframe_timestamps"] == w["keyframe_timestamps"]
        assert g["grounding_objects"] == w["grounding_objects"] and g["error"] is None
        np.testing.assert_allclose(g["keyframe_distribution"], w["keyframe_distribution"],
                                   atol=TOL)
        assert set(g) == set(w)
    assert json.loads(open(out).read()) == got
    calls = len(grounder.calls)
    assert trun.run_dataset(tds.lvhaystack_to_tstar(video_root=str(root), local_json=meta),
                            grounder, None, out, **kw) == got      # resumed: no search
    assert len(grounder.calls) == calls


def test_run_dataset_batched_with_artifacts(videos, tmp_path):
    """``run_dataset_batched`` on a tiny OWL-ViT: every item searched in one
    bucket, its history kept and its annotated GIF written (the ported
    ``save_batched_search_artifacts``, reading the file); a heuristic
    without weights is refused."""
    root, meta = videos
    heur = OwlVitHeuristic(device="cpu", dtype=torch.float32, model_config=tiny_pair(tow), seed=1)
    heur.tokenizer = THash(100, 8)
    art = tmp_path / "art"
    rows = trun.run_dataset_batched(
        tds.lvhaystack_to_tstar(video_root=str(root), local_json=meta), FakeGrounder(),
        heur, str(tmp_path / "b.json"), batch_videos=2, search_budget=0.5,
        collect_history=True, artifact_dir=str(art))
    assert len(rows) == 2
    for r in rows:
        assert len(r["keyframe_timestamps"]) == 8 and len(r["keyframe_distribution"]) == 60
        assert r["sampled_history"] and len(r["sampled_history"][0]) == 16
    assert sorted(os.listdir(art)) == ["v0_searching_iterations.gif", "v1_searching_iterations.gif"]
    with pytest.raises(TypeError, match="batch_videos"):
        trun.run_dataset_batched([], FakeGrounder(), initialize_heuristic("color-probe", device="cpu"),
                                 str(tmp_path / "c.json"))


def test_clis_run_from_paths(videos, tmp_path, capsys):
    """``cli.dataset`` over the local JSON, then ``cli.evaluate search`` on
    its output (the reference's evaluate CLI gives the same metrics on the
    same file) and ``cli.evaluate qa``."""
    root, meta = videos
    results = tcli_dataset.main([
        "--local_json", meta, "--video_root", str(root), "--grounder", "fake",
        "--heuristic", "color-probe", "--device", "cpu", "--search_budget", "0.5",
        "--output_dir", str(tmp_path / "search")])
    out = str(tmp_path / "search" / "color-probe_TStar_LongVideoHaystack_tiny.json")
    assert len(results) == 2 and json.loads(open(out).read()) == results
    assert {"target_objects": ["couch"], "cue_objects": ["tv", "chair"]} == \
        results[0]["grounding_objects"]
    got = tcli_eval.main(["search", "--search_result_path", out, "--device", "cpu",
                          "--output_root", str(tmp_path / "t")])
    want = jcli_eval.main(["search", "--search_result_path", out,
                           "--output_root", str(tmp_path / "j")])
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, k
    acc = tcli_eval.main(["qa", "--backend", "fake", "--json_file", out, "--device", "cpu",
                          "--sampling_type", "TStar", "--num_frame", "4",
                          "--output_root", str(tmp_path / "qa")])
    assert acc == 0.5                      # the fake VLM answers "A"; gt A and B
    assert "QA Accuracy: 50.00%" in capsys.readouterr().out


def test_cli_flags_are_the_references_and_device():
    from tstar_tpu.cli.dataset import build_parser as jdataset

    ours = {a.dest: a.default for a in tcli_dataset.build_parser()._actions}
    ref = {a.dest: a.default for a in jdataset()._actions}
    assert set(ours) - set(ref) == {"device"} and ours["device"] == "cuda"
    assert all(ours[k] == v for k, v in ref.items())
    for sub, args in (("search", ["--search_result_path", "x"]), ("qa", ["--json_file", "x"])):
        ours = vars(tcli_eval.build_parser().parse_args([sub, *args]))
        ref = vars(jcli_eval.build_parser().parse_args([sub, *args]))
        assert set(ours) - set(ref) == {"device"} and ours["device"] == "cuda"
        assert all(ours[k] == v for k, v in ref.items())
