"""The port's demo CLI (``tstar_tpu_torch/cli/demo.py``) through its
``main(argv)`` on the CPU, with the fake grounder and the weight-free
``color-probe`` heuristic over the in-memory synthetic scene (mirrors
``tests/test_cli.py``'s demo tests)."""

import json
import os

import pytest

from tstar_tpu_torch.cli import demo

ARGS = ["--question", "What is the color of the couch?", "--options", "A) Red\nB) Blue",
        "--grounder", "fake", "--heuristic", "color-probe", "--device", "cpu"]


def test_synthesize_deterministic_json_schema(tmp_path, capsys):
    argv = ["--video_path", "scene.mp4", "--synthesize", "--deterministic", *ARGS,
            "--confidence_threshold", "0.5", "--search_budget", "1.0",
            "--output_dir", str(tmp_path / "out"), "--json"]
    results = demo.main(argv)
    assert set(results) == {"Grounding Objects", "Frame Timestamps", "Answer"}
    assert results["Grounding Objects"] == {"target_objects": ["couch"],
                                            "cue_objects": ["tv", "chair"]}
    ts = results["Frame Timestamps"]
    assert len(ts) == 8 and ts == sorted(ts) and all(0 <= t < 120 for t in ts)
    assert results["Answer"] == "A"
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == results           # the last line is the JSON result
    gt = json.loads(next(line for line in out if line.startswith("Synthesized"))
                    .split(": ", 1)[1])
    assert gt["couch"] == list(range(70, 80))
    assert sum(any(abs(t - g) <= 5 for g in gt["couch"]) for t in ts) >= 2
    assert demo.main(argv)["Frame Timestamps"] == ts    # --deterministic repeats
    assert os.path.isdir(tmp_path / "out" / "scene")


def test_human_output_lines(tmp_path, capsys):
    demo.main(["--video_path", "scene2.mp4", "--synthesize", *ARGS,
               "--confidence_threshold", "0.5", "--output_dir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    for needle in ("T* Search Results:", "Grounding Objects:", "Frame Timestamps:", "Answer:"):
        assert needle in out, out


def test_demo_reads_a_video_file(tmp_path, capsys):
    """Without ``--synthesize`` the demo reads the file at ``--video_path``
    (an mp4 the reference's ``write_synthetic_video`` writes: 120 s, the couch
    at 70-80 s) with the port's file decoder; ``--deterministic`` keyframes
    land near the couch, and a missing file raises the decoder's error."""
    pytest.importorskip("cv2")
    from tstar_tpu.video.synthetic import default_scene as write_default_scene

    path = str(tmp_path / "scene.mp4")
    write_default_scene(path, duration_sec=120.0)
    results = demo.main(["--video_path", path, "--deterministic", *ARGS,
                         "--confidence_threshold", "0.5", "--search_budget", "1.0",
                         "--output_dir", str(tmp_path / "out"), "--json"])
    ts = results["Frame Timestamps"]
    assert len(ts) == 8 and sum(any(abs(t - g) <= 5 for g in range(70, 80)) for t in ts) >= 2
    assert "Synthesized" not in capsys.readouterr().out
    with pytest.raises(ValueError, match="Cannot open video file"):
        demo.main(["--video_path", str(tmp_path / "missing.mp4"), *ARGS,
                   "--output_dir", str(tmp_path / "out")])


def test_flags_are_the_references_and_device():
    from tstar_tpu.cli.demo import build_parser as ref_parser

    ours = {a.dest: a.default for a in demo.build_parser()._actions}
    ref = {a.dest: a.default for a in ref_parser()._actions}
    assert set(ours) - set(ref) == {"device"} and ours["device"] == "cuda"
    assert all(ours[k] == v for k, v in ref.items()), ref
