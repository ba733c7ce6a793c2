"""User-facing batched multi-video search (port of
``tstar_tpu/parallel/multi_video.py``, one device).

Searches a dataset of videos in batches: frame caches pad to a shared bucket
length, per-video states and scorers stack on a leading axis, and every step
runs ONE detector forward over the bucket's B grid canvases
(``parallel/batched.py``), where the reference's dataset loop searched one
video after another.

  * Length buckets: videos group by padded cache length, so one long video
    does not pad a batch of short ones to its length.
  * Decode / search overlap: the next bucket's caches are decoded on worker
    threads and uploaded from pinned memory on a side stream while the
    current bucket searches; its search waits on that stream's event.

Each video is read from its path with the file decoder, a handle per task
(a handle is not thread-safe), or from the task's ``decoder`` when it
carries one (as ``KeyframeSearcher(decoder=)`` takes).  A video whose
full-resolution cache exceeds its bucket's per-video budget, or every video
under ``cache_mode='streaming'``, takes the streaming search
(``_search_streaming_video``: host-paged at full resolution, one video at a
time, before the buckets); ``cache_mode='downscale'`` shrinks such caches to
fit instead.  With ``collect_history=True`` each batched result row also
holds the video's per-iteration histories (``_per_video_history``); a
streamed video's row has none.

On a mesh (``search_videos(mesh=)``, ``parallel/mesh.py``) each bucket's
videos split in contiguous, equal shares over the ``data`` ranks (a bucket
the data degree does not divide raises, as the reference's ``device_put``
does), and each rank decodes and searches only its share: the reference's
per-process host decode feeding only local shards.  The ranks of a model
group search the same share through a tensor-parallel detector
(``parallel/shardings.shard_module`` on the heuristic's model).  With more
than one data rank a bucket verifies per video (``verify_flat=False``,
unless the config says otherwise), as the reference's mesh does.  Streamed
videos go to the data ranks in turn.  The result rows come back to every
rank in task order (``mesh.gather_rows``).  Every rank takes the smallest
of the ranks' cache budgets, so they route and size the videos alike; a
bucket that runs out of memory on a mesh of several ranks raises instead
of retrying (a retry on one rank would part it from the others).
"""

from __future__ import annotations

import dataclasses
import gc
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from tstar_tpu_torch.parallel.mesh import Mesh, data_sharding, gather_rows
from tstar_tpu_torch.parallel.batched import (
    run_search_batched_auto,
    run_search_batched_with_history,
    stack_scorers,
)
from tstar_tpu_torch.search.detector_scorer import resolve_pallas_preprocess
from tstar_tpu_torch.search.engine import run_search_streaming
from tstar_tpu_torch.search.state import init_state, stack_states
from tstar_tpu_torch.search.step_graphs import StepStats, history_lists
from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.video.cache import (
    FrameCache,
    build_frame_cache,
    build_frame_cache_host,
    cache_route,
    per_video_hbm_budget,
    probe_video_length,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class VideoTask:
    video_path: str
    target_objects: List[str]
    cue_objects: List[str]
    seed: int = 0
    decoder: Any = None      # read in place of the file at video_path when given


def _bucket_indices(n_pads: Sequence[int], bucket_by_length: bool) -> List[List[int]]:
    """Group task indices by padded cache length (ascending)."""
    if not bucket_by_length:
        return [list(range(len(n_pads)))]
    groups: Dict[int, List[int]] = {}
    for i, p in enumerate(n_pads):
        groups.setdefault(p, []).append(i)
    return [groups[p] for p in sorted(groups)]


def _search_bucket(
    tasks: Sequence[VideoTask],
    caches: List[FrameCache],
    heuristic,
    config: SearchConfig,
    graphs: Optional[bool] = None,
    stats: Optional[StepStats] = None,
    collect_history: bool = False,
    mesh: Optional[Mesh] = None,
) -> List[Dict]:
    """Stack one bucket and search it to completion.

    Takes ownership of ``caches`` (a mutable list): each video's frames are
    dropped once the stacked cache holds them, so a bucket peaks at ~2x its
    cache bytes, as ``per_video_hbm_budget`` assumes.
    """
    n_pad = max(c.n_pad for c in caches)
    n_valids = [c.n_valid for c in caches]
    hws = {tuple(c.frames.shape[1:3]) for c in caches}
    if len(hws) > 1:
        raise ValueError(
            f"bucket caches disagree on resolution {sorted(hws)}: all videos in a "
            "bucket must share a cache_hw"
        )
    scorers, states = [], []
    for i, task in enumerate(tasks):
        frames = caches[i].frames
        if caches[i].n_pad < n_pad:
            pad = frames.new_zeros((n_pad - caches[i].n_pad, *frames.shape[1:]))
            frames = torch.cat([frames, pad])
        scorers.append(heuristic.build_scorer(
            frames, task.target_objects, task.cue_objects, config
        ))
        rng = torch.Generator(device=frames.device).manual_seed(task.seed)
        states.append(init_state(
            caches[i].n_valid, len(task.target_objects), config, rng, n_pad=n_pad,
            device=frames.device,
        ))
        caches[i] = None
    batched_config = resolve_pallas_preprocess(config, batched=True)
    if mesh is not None and mesh.data > 1 and batched_config.verify_flat is None:
        # the reference's mesh keeps verification per video (shard-aligned)
        batched_config = dataclasses.replace(batched_config, verify_flat=False)
    batched_scorer = stack_scorers(scorers, batched_config)
    stacked = stack_states(states)
    del scorers, states        # the stacked copies hold the frames now

    max_iters = max(config.iteration_cap(nv) for nv in n_valids)
    history = None
    if collect_history:
        finals, secs, history = run_search_batched_with_history(
            stacked, batched_scorer, batched_config, max_iters, graphs, stats
        )
    else:
        finals, secs = run_search_batched_auto(
            stacked, batched_scorer, batched_config, max_iters, graphs, stats
        )
    secs = secs.cpu().tolist()
    remaining = finals.remaining.cpu().tolist()
    iterations = finals.iteration.cpu().tolist()
    final_p = finals.P.float().cpu()

    results = []
    for i, task in enumerate(tasks):
        row = {
            "video_path": task.video_path,
            "keyframe_timestamps": sorted(float(s) / config.sampling_fps for s in secs[i]),
            "keyframe_secs": secs[i],
            "keyframe_distribution": final_p[i, :n_valids[i]].tolist(),
            "remaining_targets": [t for j, t in enumerate(task.target_objects) if remaining[i][j]],
            "iterations": int(iterations[i]),
        }
        if history is not None:
            row.update(_per_video_history(history, i, n_valids[i]))
        results.append(row)
    return results


def _per_video_history(history, i: int, n_valid: int) -> Dict:
    """Video ``i``'s histories from the batched snapshots (``P_history``,
    ``Score_history``, ``non_visiting_history``, ``sampled_history`` and,
    with detections, ``detect_bbox_iters``), over the steps it was active."""
    p_hist, s_hist, nv_hist, samp, dets = history_lists(history, n_valid, video=i)
    out = {
        "P_history": p_hist,
        "Score_history": s_hist,
        "non_visiting_history": nv_hist,
        "sampled_history": samp,
    }
    if dets:
        out["detect_bbox_iters"] = [{k: v.tolist() for k, v in d.items()} for d in dets]
    return out


def _search_streaming_video(
    task: VideoTask, heuristic, config: SearchConfig, graphs: Optional[bool] = None,
    stats: Optional[StepStats] = None,
) -> Dict:
    """One video searched through the streaming cache (full resolution,
    memory that does not grow with its length).  The row has the keys of
    ``_search_bucket``'s rows, without histories."""
    device = torch.device(heuristic.device)
    stream = build_frame_cache(task.video_path, dataclasses.replace(config, cache_mode="streaming"),
                               device=device, decoder=task.decoder)
    try:
        scorer = heuristic.build_scorer(stream.frames, task.target_objects, task.cue_objects,
                                        config)
        rng = torch.Generator(device=device).manual_seed(task.seed)
        state = init_state(stream.n_valid, len(task.target_objects), config, rng,
                           n_pad=stream.n_pad, device=device)
        final, secs = run_search_streaming(state, scorer, stream, config, graphs, stats)
    finally:
        stream.close()
    secs = secs.cpu().tolist()
    remaining = final.remaining.cpu().tolist()
    return {
        "video_path": task.video_path,
        "keyframe_timestamps": sorted(float(s) / config.sampling_fps for s in secs),
        "keyframe_secs": secs,
        "keyframe_distribution": final.P.float().cpu()[:stream.n_valid].tolist(),
        "remaining_targets": [t for j, t in enumerate(task.target_objects) if remaining[j]],
        "iterations": int(final.iteration),
    }


class _Uploader:
    """Decodes a video into a host cache and uploads it: on a CUDA device
    from pinned memory on a side stream, with an event the search waits on."""

    def __init__(self, device: torch.device, config: SearchConfig):
        self.device, self.config = device, config
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def build(self, task: VideoTask, budget: int):
        host = build_frame_cache_host(
            task.video_path, self.config, decoder=task.decoder, budget_bytes=budget
        )
        if self.stream is None:
            return host.to_device(self.device), None
        pinned = torch.from_numpy(host.frames).pin_memory()
        with torch.cuda.stream(self.stream):
            frames = pinned.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        cache = FrameCache(frames=frames, n_valid=host.n_valid, raw_fps=host.raw_fps,
                           duration=host.duration)
        return cache, done

    def wait(self, built):
        """The cache, usable on the current stream."""
        cache, done = built
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
            cache.frames.record_stream(torch.cuda.current_stream(self.device))
        return cache


def _budgets(sizes: Sequence[int], device, total_bytes, mesh: Optional[Mesh]) -> List[int]:
    """Each bucket's per-video cache budget (``sizes``: the videos a rank
    holds of it); on a mesh the smallest over the ranks."""
    budgets = [per_video_hbm_budget(n, device, total_bytes=total_bytes) for n in sizes]
    if mesh is None or mesh.world == 1 or not budgets:
        return budgets
    t = torch.tensor(budgets, dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return t.tolist()


def search_videos(
    tasks: Sequence[VideoTask],
    heuristic,
    config: Optional[SearchConfig] = None,
    mesh: Optional[Mesh] = None,
    bucket_by_length: bool = True,
    decode_workers: int = 2,
    prefetch: bool = True,
    hbm_budget_bytes: Optional[int] = None,
    graphs: Optional[bool] = None,
    stats: Optional[StepStats] = None,
    collect_history: bool = False,
) -> List[Dict]:
    """Search every video to completion in batched searches on the
    heuristic's device, one length bucket at a time; on ``mesh``, each
    data rank its share of each bucket (module docstring).

    Each video's cache budget is its bucket's share of the device's free
    memory (``per_video_hbm_budget``; ``hbm_budget_bytes`` replaces the free
    memory).  A video whose full-resolution cache exceeds its own bucket's
    budget streams (``_search_streaming_video``, serially, before the
    buckets), as does every video under ``cache_mode='streaming'``;
    'downscale' shrinks such caches instead, and 'resident' raises
    ``ValueError`` on them.  ``prefetch=False`` decodes each bucket only
    when it is searched.  A bucket that runs out of device memory
    (``torch.cuda.OutOfMemoryError``) is retried twice, each time with half
    the per-video budget, so at a lower cache resolution, as the reference
    retries.  ``graphs`` and ``stats`` go to the drivers.

    Returns one dict per video, in task order: {"video_path",
    "keyframe_timestamps", "keyframe_secs", "keyframe_distribution",
    "remaining_targets", "iterations"}, and with ``collect_history`` also
    the batched video's "P_history", "Score_history",
    "non_visiting_history", "sampled_history" and, for detector scorers,
    "detect_bbox_iters" (the same searches: history collection changes what
    is copied out, not the trajectory).
    """
    config = config or SearchConfig()
    device = torch.device(heuristic.device)
    if mesh is not None and (device.type, device.index or 0) != (
            mesh.device.type, mesh.device.index or 0):
        raise ValueError(f"the heuristic is on {device}, the mesh rank on {mesh.device}")
    data = mesh.data if mesh is not None else 1
    n_pads = [probe_video_length(t.decoder or t.video_path, config)[1] for t in tasks]

    # Each video is judged by its OWN bucket's budget (the budget its bucket's
    # videos would get if none streamed); streaming a video only grows the
    # survivors' budgets, so none of them goes over.
    stream_idx: List[int] = []
    first = _bucket_indices(n_pads, bucket_by_length)
    for bucket, budget in zip(first, _budgets([-(-len(b) // data) for b in first], device,
                                              hbm_budget_bytes, mesh)):
        stream_idx += [
            i for i in bucket
            if cache_route(n_pads[i], config, budget, f"{tasks[i].video_path!r} (its "
                           "bucket's per-video budget)") == "streaming"
        ]
    stream_idx.sort()
    if stream_idx and collect_history:
        logger.warning(
            "search_videos: %d videos stream (full-resolution cache over their bucket's "
            "per-video budget); per-iteration histories are not collected for streamed "
            "videos", len(stream_idx),
        )
    results: List[Optional[Dict]] = [None] * len(tasks)
    mine: Dict[int, Dict] = {}          # the rows this rank searched
    for j, i in enumerate(stream_idx):
        if mesh is None or j % data == mesh.data_index:
            mine[i] = _search_streaming_video(tasks[i], heuristic, config, graphs, stats)
    streamed = set(stream_idx)
    batched_idx = [i for i in range(len(tasks)) if i not in streamed]
    buckets = [[batched_idx[j] for j in b]
               for b in _bucket_indices([n_pads[i] for i in batched_idx], bucket_by_length) if b]
    if mesh is not None:
        buckets = [b[data_sharding(mesh, len(b))] for b in buckets]
    budget_by_index = {
        i: budget
        for bucket, budget in zip(buckets, _budgets([len(b) for b in buckets], device,
                                                    hbm_budget_bytes, mesh))
        for i in bucket
    }
    if len(buckets) > 1:
        logger.info("search_videos: %d videos -> %d length buckets %s",
                    len(batched_idx), len(buckets), [n_pads[b[0]] for b in buckets])

    uploader = _Uploader(device, config)
    with ThreadPoolExecutor(max_workers=max(1, decode_workers)) as pool:
        futures = {}

        def submit(bucket: List[int]):
            for i in bucket:
                if i not in futures:
                    futures[i] = pool.submit(uploader.build, tasks[i], budget_by_index[i])

        for b, bucket in enumerate(buckets):
            submit(bucket)
            if prefetch and b + 1 < len(buckets):
                submit(buckets[b + 1])   # decode + upload while this bucket searches
            caches = [uploader.wait(futures.pop(i).result()) for i in bucket]
            budget = budget_by_index[bucket[0]]
            out = None
            for attempt in range(3):
                oom = False
                try:
                    out = _search_bucket([tasks[i] for i in bucket], caches, heuristic, config,
                                         graphs, stats, collect_history, mesh)
                except torch.cuda.OutOfMemoryError:
                    if attempt == 2 or (mesh is not None and mesh.world > 1):
                        raise
                    oom = True
                # rebuild outside the handler: its traceback pins the failed
                # attempt's tensors until the handler exits
                if not oom:
                    break
                del caches
                gc.collect()
                torch.cuda.empty_cache()
                budget = max(budget // 2, 32 * 1024 ** 2)
                logger.warning("bucket of %d videos ran out of device memory; retrying with "
                               "a %.0f MB per-video cache budget", len(bucket), budget / 2 ** 20)
                caches = [uploader.wait(uploader.build(tasks[i], budget)) for i in bucket]
            mine.update(zip(bucket, out))
    shares = gather_rows(mesh, mine) if mesh is not None else [mine]
    for share in shares:
        for i, row in share.items():
            results[i] = row
    return results
