"""Fixtures of the benchmark's own tests.

    python -m pytest benchmark/tests            (CPU: the card tests skip)
    python -m pytest -m cuda benchmark/tests    (on the card)

``tiny_root`` is a copy of the benchmark at tiny sizes (a 2-layer detector
and VLM; two 300 s videos a bucket, four steps a search; 120 s videos a
question) that the program runs on the CPU in seconds.  Whether a card is
present is decided inside the ``card`` fixture, never at import.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CELL = "owlvit-b32.haystack-b8-verify"
PIPELINE = "llava-ov-qwen2-7b.question"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check at the cell's own size runs on the card")
    return "cuda:0"


def make_tiny_root(dest: Path) -> Path:
    """A checkout-like folder: BENCHMARK.json and the benchmark, with each
    cell cut to a size the CPU runs in seconds (a 2-layer detector and
    VLM, short videos)."""
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    cfg_path = dest / "benchmark/configs/owlvit-b32.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["vision_config"].update(hidden_size=128, intermediate_size=256, num_attention_heads=2,
                                num_hidden_layers=2, image_size=128)
    cfg["text_config"].update(vocab_size=1000, hidden_size=64, intermediate_size=128,
                              num_attention_heads=2, num_hidden_layers=2)
    cfg["projection_dim"] = 64
    cfg_path.write_text(json.dumps(cfg))
    wl_path = dest / f"benchmark/workloads/{CELL}.json"
    wl = json.loads(wl_path.read_text())
    wl["mix"].update(videos_per_bucket=2, video_seconds=300, cache_hw=[32, 64], budget_cap=64,
                     verify_batch=4)
    wl_path.write_text(json.dumps(wl))
    cfg_path = dest / "benchmark/configs/llava-ov-qwen2-7b.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["vision_config"].update(hidden_size=64, intermediate_size=128, num_attention_heads=2,
                                num_hidden_layers=2, image_size=56)
    cfg["text_config"].update(hidden_size=128, intermediate_size=256, num_attention_heads=4,
                              num_key_value_heads=2, num_hidden_layers=2)
    cfg_path.write_text(json.dumps(cfg))
    wl_path = dest / f"benchmark/workloads/{PIPELINE}.json"
    wl = json.loads(wl_path.read_text())
    wl["mix"].update(video_seconds=120, cache_hw=[32, 64], video_hw=[72, 128])
    wl_path.write_text(json.dumps(wl))
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
