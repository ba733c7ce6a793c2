"""The class-aware NMS kernel and the YOLO-World search on the card.  Every
test here needs a CUDA device and skips without one.  This file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_yolo.py

The NMS kernel (``csrc/nms.cu``) must give its plain version's ``keep`` and
``valid`` EXACTLY (its IoU rounds operation by operation as the plain
version's f32 tensor ops), at small and full anchor counts, with ties,
truncation, more slots than boxes, and images whose scores are all zero.
The YOLO search (``yoloworld_small``, f32) stepped through CUDA graphs gives
the eager search's seconds and keyframes, and launches the kernel once a
detector forward; ``chip_smoke.py`` phase 10 runs the same checks with
YOLO-World v2-XL.
"""

import pytest
import torch

from tstar_tpu_torch.framework.heuristics import initialize_heuristic
from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
from tstar_tpu_torch.kernels import nms as knms
from tstar_tpu_torch.ops import nms as onms
from tstar_tpu_torch.search.engine import run_search
from tstar_tpu_torch.search.state import init_state
from tstar_tpu_torch.search.step_graphs import StepStats
from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.video.cache import build_frame_cache
from tstar_tpu_torch.video.synthetic import scene_variant


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the NMS kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, n, seed, levels=8, classes=10, zero_image=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    cxy = torch.rand(b, n, 2, generator=g, device="cuda") * 320
    wh = torch.rand(b, n, 2, generator=g, device="cuda") * 60 + 4
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)
    scores = torch.floor(torch.rand(b, n, generator=g, device="cuda") * levels) / levels
    if zero_image:
        scores[-1] = 0
    cls = torch.randint(0, classes, (b, n), generator=g, device="cuda", dtype=torch.int32)
    return boxes, scores, cls


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,max_out,thr", [
    (1, 100, 10, 0.5), (3, 525, 50, 0.7), (2, 2100, 50, 0.3), (1, 8400, 50, 0.7),
    (8, 8400, 50, 0.7), (2, 300, 400, 0.5), (1, 64, 64, 0.5), (1, 65, 65, 0.9),
])
def test_nms_kernel_equals_plain(cuda, b, n, max_out, thr):
    boxes, scores, cls = _inputs(b, n, seed=n + b, zero_image=b > 1)
    reset_launch_counts()
    keep, valid = onms.batched_class_nms(boxes, scores, cls, thr, max_out)
    torch.cuda.synchronize()
    assert launch_counts()["greedy_nms"] == 1
    order = torch.argsort(-scores, dim=-1, stable=True)
    span = boxes.amax(dim=(-2, -1), keepdim=True) - boxes.amin(dim=(-2, -1), keepdim=True) + 1
    off = boxes + cls.float()[..., None] * span
    want_k, want_v = knms.greedy_nms_plain(off, order, thr, max_out)
    assert torch.equal(keep, want_k) and torch.equal(valid, want_v)
    if max_out > n:
        assert not valid[:, n:].any()


@pytest.mark.cuda
def test_nms_kernel_rejects_what_it_does_not_take(cuda):
    boxes, scores, _ = _inputs(1, 50, seed=0)
    order = torch.argsort(-scores, dim=-1, stable=True)
    with pytest.raises(ValueError):
        knms.greedy_nms(boxes.half(), order, 0.5, 10)
    with pytest.raises(ValueError):
        knms.greedy_nms(boxes, order.int(), 0.5, 10)
    with pytest.raises(ValueError):
        knms.greedy_nms(boxes, order, 0.5, 0)


@pytest.fixture
def yolo(cuda):
    return initialize_heuristic("yolo-world-random", size="small", device="cuda",
                                dtype=torch.float32, seed=2)


@pytest.mark.cuda
def test_yolo_search_graphs_equal_eager(yolo):
    cfg = SearchConfig(search_budget=0.5, cache_hw=(48, 96))
    cache = build_frame_cache("mem://v", cfg, device="cuda", decoder=scene_variant(2, 300.0))
    scorer = yolo.build_scorer(cache.frames, ["couch", "lamp"], ["tv"], cfg)
    runs = {}
    for graphs in (True, False):
        state = init_state(cache.n_valid, 2, cfg, torch.Generator(device="cuda").manual_seed(0),
                           n_pad=cache.n_pad, device="cuda")
        stats = StepStats(record=True)
        reset_launch_counts()
        final, secs = run_search(state, scorer, cfg, graphs=graphs, stats=stats)
        runs[graphs] = (secs.tolist(), [e["secs"][0].tolist() for e in stats.trace], stats,
                        launch_counts()["greedy_nms"])
    (g_secs, g_steps, g, g_nms), (e_secs, e_steps, e, e_nms) = runs[True], runs[False]
    assert g_secs == e_secs and g_steps == e_steps
    assert g.replays > 0 and g.host_reads == 2 * g.steps and e.replays == 0
    assert g_nms == e_nms == g.steps + len(g.verify_widths)
