"""The multi-device layer on one card (``chip_smoke.py`` phase 14 at a
smaller depth).  Skipped without CUDA; no JAX.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py

  * a one-rank NCCL mesh: the detector sharded at model = 1 keeps its
    row-parallel all-reduces inside the captured step graphs, and the
    search equals the one without a mesh (keyframes, iterations, replays
    and host reads a step);
  * two ranks sharing cuda:0 over gloo (NCCL refuses them, which
    ``make_mesh`` says first): the dry run's dp and tp searches and TP
    decode against the unsharded ones on each rank (at model = 2 the tiny
    random detector's search may part after equal steps, which the tool
    reports only with its witness: distributions within the tolerance and
    every second the draws disagree on tied; ROADMAP queue 3 item 11); B/32 at full width (two
    layers) sharded over the two ranks launches K1 at 6 heads and scores
    within phase 4's 2e-2 of the whole model.
"""

import os
import pickle
import socket
import sys
import tempfile

import pytest
import torch

# the rank bodies' module, imported by its own name (the spawned ranks import
# it so; another installed package may be called ``tests``)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_ranks as ranks  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_ranks(body: str):
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(ranks.cuda_rank, args=(2, _port(), body, out_dir), nprocs=2,
                           start_method="spawn")
        outs = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    return outs


def test_one_rank_nccl_mesh_captures_its_collectives(cuda):
    import torch.distributed as dist

    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.models import owlvit as tow
    from tstar_tpu_torch.parallel import VideoTask, make_mesh, search_videos, shard_module
    from tstar_tpu_torch.search.step_graphs import StepStats
    from tstar_tpu_torch.utils.config import SearchConfig

    heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.float32,
                                model_config=ranks.tiny_owlvit(tow), seed=0)
    cfg = SearchConfig(**ranks.CONFIG)

    def run(**kw):
        tasks = [VideoTask(f"mem://{i}", ranks.TARGETS, ranks.CUES, seed=s, decoder=d)
                 for i, (s, d) in enumerate(zip(ranks.SEEDS, ranks.decoders()))]
        stats = StepStats()
        rows = search_videos(tasks, heur, cfg, stats=stats, **kw)
        return [(r["keyframe_secs"], r["iterations"]) for r in rows], stats

    mesh = make_mesh(1, 1)
    try:
        assert mesh.backend == "nccl"
        plain, st0 = run()
        shard_module(heur.model, mesh)
        assert heur.model.vision.encoder.layers[0].self_attn.out_proj.reduce is not None
        meshed, st1 = run(mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert meshed == plain
    assert st1.replays > 0 and not st1.eager_reason
    assert st1.replays * st0.steps == st0.replays * st1.steps
    assert st1.host_reads == 2 * st1.steps


@pytest.mark.parametrize("data, model", [(2, 1), (1, 2)])
def test_dry_run_on_two_ranks_sharing_the_card(cuda, data, model):
    from tstar_tpu_torch.tools.dryrun_multi import dryrun_multiprocess

    out = dryrun_multiprocess(world=2, data=data, model=model, backend="gloo", device="cuda:0")
    assert out["ok"] and len(out["videos"]) == 2 * data
    for rep in out["ranks"]:
        assert rep["conf_err"] <= 1e-5
        if model == 1:    # the same forwards: every video's search equal
            assert rep["parted"] == {}
        for witness in rep["parted"].values():   # each parting came with its tie
            assert witness["tie"] in ("threshold", "key") and witness["seconds"]
        assert rep["backend"] == "gloo" and rep["device"] == "cuda:0"
        if model > 1:     # gloo collectives in the forward: eager steps and decode
            assert rep["search_eager_reason"] and rep["decode_eager_reason"]
            assert rep["search_replays"] == 0
        else:             # no collective in a step: graphs kept
            assert not rep["search_eager_reason"] and rep["search_replays"] > 0


def test_tp_b32_forward_at_six_heads(cuda):
    for out in _two_ranks("tp_b32_forward"):
        assert out["heads"] == 6 and out["k1"] == 2
        assert out["score_err"] <= 2e-2


def test_nccl_refuses_two_ranks_on_one_card(cuda):
    for out in _two_ranks("nccl_on_one_card"):
        assert out["error"] and "two ranks on one device" in out["error"]
