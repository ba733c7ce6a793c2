"""Dry runs of the port's multi-device layer: the counterparts of the
reference's ``__graft_entry__.py`` (``entry``, ``dryrun_multichip``,
``_multiproc_worker`` / ``dryrun_multiprocess``).

    python -m tstar_tpu_torch.tools.dryrun_multi --world 2 --data 1 --model 2 \
        --device cuda:0 --backend gloo            # two ranks sharing one card
    python -m tstar_tpu_torch.tools.dryrun_multi --world 4 --data 2 --model 2 --device cpu
    torchrun --nproc-per-node 4 -m tstar_tpu_torch.tools.dryrun_multi --data 2 --model 2

``entry()`` is the flagship step (the B/32 grid forward and
``postprocess_detections``).  ``dryrun_multichip`` runs on every rank of a
process group: the tiny OWL-ViT of the reference's dry run, tensor-parallel
over ``model`` and with two videos a data rank, searches them to completion
through ``search_videos(mesh=)`` and must equal the unsharded search of the
same videos on this rank (keyframes and iterations exact, the final
distributions within rtol 1e-5, atol 1e-6, as the reference's), step by
step: every grid forward that sampled the same seconds within rtol 1e-5.
The split sums move confidences by ~1e-7, which a knife edge of the
search's sampler can turn into other seconds (ROADMAP queue 3 item 11; a
tiny random model on the card parts so at step 1).  A video whose sampled
seconds part is reported with the step (``parted``) only with a witness
(``_knife_edge``): at that step both distributions agree within the
tolerance, the sampler replays both draws, and every second the draws
disagree on is tied, at the quartile threshold or at the k-th key.
Anything else fails.  The CPU tests hold the port's dp x tp search to the
reference's exactly.  Then a
tensor-parallel tiny Qwen2-VL prefills and decodes, its greedy tokens equal
to the unsharded model's.  ``dryrun_multiprocess`` spawns the ranks (one
device each: ``cuda:<rank>``, or the ``device`` given, which two ranks may
share over gloo), and writes its report only where it is given a path.
Every rank runs on the card unless ``device`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# __graft_entry__.py's tiny detector and VLM (dryrun_multichip)
TINY_OWL = dict(vision=dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                            patch_size=16, image_size=64),
                text=dict(vocab_size=100, hidden_size=24, num_layers=2, num_heads=4,
                          intermediate_size=48, max_length=8),
                projection_dim=24)
TINY_QWEN = dict(vision=dict(depth=2, embed_dim=16, num_heads=2, mlp_ratio=2.0, patch_size=2,
                             temporal_patch_size=1, spatial_merge_size=2, hidden_size=32),
                 text=dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                           num_kv_heads=2, intermediate_size=64, mrope_section=(1, 1, 2)))


def entry(device="cuda"):
    """-> (fn, example_args): the flagship step, one 768^2 grid image through
    the B/32 detector (bf16, seeded weights) to post-processed detections
    (scores, class ids, boxes)."""
    from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer
    from tstar_tpu_torch.models.owlvit import (
        OwlViTDetector, init_params, owlvit_base_patch32, postprocess_detections,
    )

    cfg = owlvit_base_patch32()
    model = init_params(OwlViTDetector(cfg), 0).to(device, torch.bfloat16)
    model.requires_grad_(False).eval()
    ids, mask = HashTokenizer(cfg.text.vocab_size, cfg.text.max_length).encode_batch(
        ["couch", "lamp", "tv", "person"])
    with torch.no_grad():
        queries = model.encode_text(torch.as_tensor(np.asarray(ids)).to(device),
                                    torch.as_tensor(np.asarray(mask)).to(device))
    size = cfg.vision.image_size

    @torch.no_grad()
    def fn(model, pixels, queries):
        logits, boxes = model.predict(model.encode_image(pixels), queries)
        return postprocess_detections(logits, boxes, (size, size))

    pixels = torch.zeros(1, size, size, 3, dtype=torch.bfloat16, device=device)
    return fn, (model, pixels, queries)


def _tiny_owl():
    from tstar_tpu_torch.models import owlvit

    return owlvit.OwlViTConfig(vision=owlvit.VisionConfig(**TINY_OWL["vision"]),
                               text=owlvit.TextConfig(**TINY_OWL["text"]),
                               projection_dim=TINY_OWL["projection_dim"])


def _tiny_qwen():
    from tstar_tpu_torch.models import qwen2vl

    return qwen2vl.Qwen2VLConfig(vision=qwen2vl.Qwen2VLVisionConfig(**TINY_QWEN["vision"]),
                                 text=qwen2vl.Qwen2VLTextConfig(**TINY_QWEN["text"]),
                                 image_token_id=251)


@torch.no_grad()
def dryrun_multichip(data: Optional[int] = None, model: int = 2, backend: Optional[str] = None,
                     device=None) -> Dict:
    """On every rank of the default process group (a one-rank group is made
    when there is none): the dp x tp search and the TP VLM (module
    docstring).  Raises on any difference; returns this rank's report."""
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.models.generate import GenerateStats, generate
    from tstar_tpu_torch.models.qwen2vl import Qwen2VLModel, build_mrope_position_ids, random_model
    from tstar_tpu_torch.parallel import (
        VideoTask, data_sharding, make_mesh, search_videos, shard_module,
    )
    from tstar_tpu_torch.search.step_graphs import StepStats
    from tstar_tpu_torch.utils.config import SearchConfig
    from tstar_tpu_torch.video.synthetic import scene_variant

    mesh = make_mesh(data, model, backend, device)
    dev = mesh.device
    cfg = SearchConfig(search_budget=0.5, cache_hw=(32, 64))
    tasks = [VideoTask(f"mem://scene-{i}", ["couch", "lamp"], ["tv"], seed=i,
                       decoder=scene_variant(i, 240.0)) for i in range(2 * mesh.data)]

    def heuristic():
        return initialize_heuristic("owl-vit-random", device=dev, dtype=torch.float32,
                                    model_config=_tiny_owl(), seed=0)

    sharded = heuristic()
    shard_module(sharded.model, mesh)
    stats, whole_stats = StepStats(record=True), StepStats(record=True)
    rows = search_videos(tasks, sharded, cfg, mesh=mesh, stats=stats)
    whole = search_videos(tasks, heuristic(), cfg, stats=whole_stats)
    share = data_sharding(mesh, len(tasks))
    parted, conf_err, close = _compare(stats.trace, whole_stats.trace, share, cfg)
    if not close:
        raise AssertionError(f"rank {mesh.rank}: grid confidences up to {conf_err:.3e} from "
                             "the unsharded search's on the same seconds")
    for i in range(share.start, share.stop):
        got, want = rows[i], whole[i]
        same = (got["keyframe_secs"] == want["keyframe_secs"]
                and got["iterations"] == want["iterations"]
                and np.allclose(got["keyframe_distribution"], want["keyframe_distribution"],
                                rtol=RTOL, atol=ATOL))
        if not same and i - share.start not in parted:
            raise AssertionError(f"rank {mesh.rank}: {got['video_path']} differs from the "
                                 f"unsharded search: {got['keyframe_secs']} / "
                                 f"{want['keyframe_secs']}")

    # the VLM: a TP Qwen2-VL prefill + decode against the whole model
    vcfg = _tiny_qwen()
    vlm = shard_module(random_model(Qwen2VLModel, vcfg, torch.float32, dev, seed=3), mesh)
    ref = random_model(Qwen2VLModel, vcfg, torch.float32, dev, seed=3)
    ids = np.array([[5, 251, 251, 251, 251, 9]])
    patches = torch.randn(1, 16, 12, generator=torch.Generator().manual_seed(4)).to(dev)
    pos = build_mrope_position_ids(ids[0], 251, [(1, 4, 4)], 2)[:, None]
    kw = dict(max_new_tokens=4, eos_token_ids=[255], image_patches=patches,
              image_grid_hw=(4, 4))
    gstats = GenerateStats()
    tokens = generate(vlm, ids, np.array([6]), pos, stats=gstats, **kw).tolist()
    want = generate(ref, ids, np.array([6]), pos, **kw).tolist()
    if tokens != want:
        raise AssertionError(f"rank {mesh.rank}: TP tokens {tokens} != unsharded {want}")
    return {
        "rank": mesh.rank, "mesh": mesh.shape, "backend": mesh.backend, "device": str(dev),
        "parted": {tasks[share.start + j].video_path: w for j, w in parted.items()},
        "conf_err": conf_err,
        "videos": [r["video_path"] for r in rows],
        "iterations": [r["iterations"] for r in rows],
        "search_steps": stats.steps, "search_replays": stats.replays,
        "search_eager_reason": stats.eager_reason,
        "vlm_tokens": tokens, "decode_eager_reason": gstats.eager_reason,
    }


# the tolerance the dry run holds distributions to (the reference's
# :178-189), and the key difference it lets that tolerance explain
RTOL, ATOL = 1e-5, 1e-6
KEY_TIE = 2 * RTOL          # |log(w (1 + rtol)) - log(w (1 - rtol))|


def _compare(trace, whole_trace, share: slice, config):
    """Step by step, this rank's videos in the sharded search's trace
    against the same videos in the unsharded one -> ({local video: the
    witness of the step its sampled seconds parted at (``_knife_edge``)},
    the largest grid confidence difference over the steps that sampled the
    same seconds, whether all of those lie within RTOL, ATOL)."""
    parted, err, close = {}, 0.0, True
    for j, i in enumerate(range(share.start, share.stop)):
        mine = [e for e in trace if e["active"][j]]
        theirs = [e for e in whole_trace if e["active"][i]]
        for step, (a, b) in enumerate(zip(mine, theirs)):
            if not torch.equal(a["secs"][j], b["secs"][i]):
                parted[j] = dict(step=step, **_knife_edge(a, j, b, i, config))
                break
            c1, c2 = a["conf"][j], b["conf"][i]
            err = max(err, (c1 - c2).abs().max().item())
            close = close and torch.allclose(c1, c2, rtol=RTOL, atol=ATOL)
    return parted, err, close


def _knife_edge(a, j, b, i, config) -> Dict:
    """The witness that two searches which sampled the same seconds until
    this step part here at a knife edge of the sampler, and not through a
    fault: row ``j`` of trace entry ``a`` against row ``i`` of ``b``.
    Raises unless (1) both rows have the same visited seconds, valid count
    and noise, (2) their distributions agree within RTOL, ATOL, (3) the
    sampler replays each row's seconds from its own distribution, and (4)
    every second the two draws disagree on is tied: where the quartile
    masks differ, its weight lies within the tolerance of both thresholds;
    where they agree, its key lies within KEY_TIE of the k-th key of both.
    -> what was found."""
    from tstar_tpu_torch.ops.sampling import gumbel_topk_from_noise
    from tstar_tpu_torch.search.engine import sampling_weights

    k = config.frames_per_iteration
    # replayed on the searches' own device: another device's sort or log
    # may round a tie the other way
    rows = [dict({key: e[key][r:r + 1] for key in ("P", "visited", "gumbel", "n_valid")},
                 secs=e["secs"][r]) for e, r in ((a, j), (b, i))]
    x, y = rows
    what = (f"the searches parted at a step that sampled seconds {x['secs'].tolist()} / "
            f"{y['secs'].tolist()}")
    for key in ("visited", "gumbel", "n_valid"):
        if not torch.equal(x[key], y[key]):
            raise AssertionError(f"{what}, but with other {key}")
    dist_err = (x["P"] - y["P"]).abs().max().item()
    if not torch.allclose(x["P"], y["P"], rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: distributions {dist_err:.3e} apart")
    valid = torch.arange(x["P"].shape[-1], device=x["P"].device)[None] < x["n_valid"][:, None]
    for r in rows:
        r["draw"], r["w"], r["thr"] = sampling_weights(r["P"], r["visited"], valid, r["n_valid"],
                                                       config)
        idx, r["keys"] = gumbel_topk_from_noise(r["gumbel"], r["draw"], k)
        if not torch.equal(idx[0], r["secs"]):
            raise AssertionError(f"{what}: the sampler does not replay {r['secs'].tolist()}")
    free = valid[0] & ~x["visited"][0]
    masks = [(r["w"] >= r["thr"])[0] & free for r in rows]
    moved = masks[0] != masks[1]
    if moved.any():
        gaps = [(r["w"] - r["thr"])[0][moved].abs() for r in rows]
        tol = ATOL + RTOL * max(r["thr"].abs().item() for r in rows)
        margin = max(g.max().item() for g in gaps)
        if margin > tol:
            raise AssertionError(f"{what}: the quartile masks differ at seconds "
                                 f"{moved.nonzero().flatten().tolist()}, {margin:.3e} from a "
                                 f"threshold (tie tolerance {tol:.3e})")
        return {"dist_err": dist_err, "tie": "threshold",
                "seconds": moved.nonzero().flatten().tolist(), "margin": margin}
    changed = sorted(set(x["secs"].tolist()) ^ set(y["secs"].tolist()))
    margin = 0.0
    for r in rows:
        keys = r["keys"][0]
        kth = keys.topk(k).values[-1]
        margin = max(margin, (keys[changed] - kth).abs().max().item())
    if margin > KEY_TIE:
        raise AssertionError(f"{what}: equal quartile masks, and seconds {changed} lie "
                             f"{margin:.3e} from the k-th key (tie tolerance {KEY_TIE:.0e})")
    return {"dist_err": dist_err, "tie": "key", "seconds": changed, "margin": margin}


def _rank(rank: int, world: int, port: int, data, model, backend, device, out_dir) -> None:
    """One spawned rank: its own process group member, then the dry run."""
    if device is None:
        device = f"cuda:{rank}"
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    init = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(init, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        report = dryrun_multichip(data, model, backend, dev)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(report, f)


def dryrun_multiprocess(world: int = 2, data: Optional[int] = None, model: int = 2,
                        backend: Optional[str] = None, device=None,
                        artifact_path: Optional[str] = None) -> Dict:
    """Spawn ``world`` ranks of ``dryrun_multichip`` and collect their
    reports; writes them to ``artifact_path`` only when given one."""
    import torch.multiprocessing as mp

    from tstar_tpu_torch.parallel.mesh import free_port

    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank, args=(world, free_port(), data, model, backend, device,
                                        out_dir), nprocs=world, start_method="spawn")
        reports = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                reports.append(pickle.load(f))
    covered = sorted({v for r in reports for v in r["videos"]})
    result = {"ok": True, "world": world, "ranks": reports, "videos": covered}
    if artifact_path:
        with open(artifact_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn (default: run in torchrun's process group)")
    ap.add_argument("--data", type=int, default=None)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default=None, help="cpu, cuda:N (default cuda:LOCAL_RANK)")
    ap.add_argument("--out", default=None, help="write the reports here as JSON")
    args = ap.parse_args(argv)
    if args.world is None:          # under torchrun: this process is one rank
        report = dryrun_multichip(args.data, args.model, args.backend, args.device)
        print(json.dumps(report))
        return 0
    result = dryrun_multiprocess(args.world, args.data, args.model, args.backend, args.device,
                                 args.out)
    print(json.dumps({k: result[k] for k in ("ok", "world", "videos")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
