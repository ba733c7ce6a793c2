"""Batch search runner over a dataset (port of ``tstar_tpu/bench/runner.py``,
after the reference's run_TStar_onDataset.py).

Per-item schema and defaults mirror the reference
(``run_TStar_onDataset.py:89-211``: per-item TStarFramework invocation,
sorted timestamps, result keys ``grounding_objects`` / ``keyframe_timestamps``
/ ``keyframe_distribution`` = final P, per-item try/except-continue, output
``{heuristic}_{output_json_name}``).  Upgrades (SURVEY.md §5.3-5.4): per-item
JSONL manifest with resume (the reference only writes one JSON at the end and
restarts from scratch on failure), and typed per-item error records.
Videos are read from their paths (``video/decoder.open_video``); the search
runs on the heuristic's device.  Grounding failures of an item (frame decode,
response parse) fail only that item; a failure of the grounder's batched
forward raises, as the port's grounder does (ROADMAP queue 3 item 7).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List

from tstar_tpu_torch.bench.evaluate import resume_key

logger = logging.getLogger(__name__)


def search_one_item(
    item: Dict[str, Any],
    grounder,
    heuristic,
    search_nframes: int = 8,
    grid_rows: int = 4,
    grid_cols: int = 4,
    confidence_threshold: float = 0.7,
    search_budget: float = 1.0,
    output_dir: str = "./results/frame_search",
    seed: int = 0,
    save_artifacts: bool = False,
    config=None,
    device=None,
) -> Dict[str, Any]:
    """Run grounding + search for one dataset item; returns the result row.
    ``device``: the framework's (default: the heuristic's device)."""
    from tstar_tpu_torch.framework.framework import TStarFramework

    if device is None:
        device = getattr(heuristic, "device", "cuda")
    fw = TStarFramework(
        video_path=item["video_path"],
        question=item["question"],
        options=item.get("options", ""),
        grounder=grounder,
        heuristic=heuristic,
        search_nframes=search_nframes,
        grid_rows=grid_rows,
        grid_cols=grid_cols,
        output_dir=output_dir,
        confidence_threshold=confidence_threshold,
        search_budget=search_budget,
        seed=seed,
        save_artifacts=save_artifacts,
        config=config,
        device=device,
    )
    targets, cues = fw.get_grounded_objects()
    searcher = fw.initialize_videoSearcher(targets, cues)
    _, timestamps = fw.perform_search(searcher, visualization=save_artifacts)
    timestamps = sorted(timestamps)
    searcher._record_final_history()
    return {
        "video_path": item["video_path"],
        "grounding_objects": {"target_objects": targets, "cue_objects": cues},
        "keyframe_timestamps": timestamps,
        "keyframe_distribution": searcher.P_history[-1],
    }


def run_dataset_batched(
    dataset: List[Dict[str, Any]],
    grounder,
    heuristic,
    output_json: str,
    batch_videos: int = 4,
    search_nframes: int = 8,
    grid_rows: int = 4,
    grid_cols: int = 4,
    confidence_threshold: float = 0.7,
    search_budget: float = 1.0,
    seed: int = 0,
    config=None,
    collect_history: bool = False,
    artifact_dir: str = None,
    **_ignored,
) -> List[Dict[str, Any]]:
    """Batched variant: grounding runs serially (VLM/API-bound), searches run
    ``batch_videos`` at a time in one on-device loop (parallel/multi_video).

    The detector backend must produce OwlVitScorer-shaped scorers.

    ``collect_history`` threads the reference's per-iteration detection
    history through the batched search (interface_searcher.py:469-474):
    each result row gains ``sampled_history`` + ``detect_bbox_iters``, and
    with ``artifact_dir`` set, an annotated per-iteration search GIF is
    written per video (the serial runner's framework artifacts, batched).
    """
    import dataclasses as _dc

    from tstar_tpu_torch.parallel.multi_video import VideoTask, search_videos
    from tstar_tpu_torch.utils.config import SearchConfig

    config = _dc.replace(
        config or SearchConfig(),
        search_nframes=search_nframes,
        grid_rows=grid_rows,
        grid_cols=grid_cols,
        confidence_threshold=confidence_threshold,
        search_budget=search_budget,
    )

    if not hasattr(heuristic, "build_scorer") or not hasattr(heuristic, "model"):
        raise TypeError(
            f"--batch_videos needs a detector backend with shared weights "
            f"(OwlVitScorer-shaped); {getattr(heuristic, 'name', heuristic)!r} "
            f"is not supported — use the serial runner"
        )

    # stage 1: grounding (VLM/API bound; batched across items when the
    # grounder supports it, sharing prefill/decode forwards) + per-item
    # video probing
    from tstar_tpu_torch.video.decoder import open_video

    tasks, rows = [], []
    probed: List[int] = []
    for idx, item in enumerate(dataset):
        row = dict(item)
        row["error"] = None
        try:
            open_video(item["video_path"]).close()   # fail fast per item
            probed.append(idx)
        except Exception as e:  # noqa: BLE001
            logger.error("probe failed for %s: %s", item.get("video_id"), e)
            row["error"] = f"{type(e).__name__}: {e}"
        tasks.append(None)
        rows.append(row)

    batch_ground = getattr(grounder, "inference_query_grounding_batch", None)
    for start in range(0, len(probed), batch_videos):
        chunk = probed[start : start + batch_videos]
        if batch_ground is not None:
            grounded = batch_ground([
                {
                    "video_path": dataset[i]["video_path"],
                    "question": dataset[i]["question"],
                    "options": dataset[i].get("options", ""),
                }
                for i in chunk
            ])
            if len(grounded) != len(chunk):
                raise ValueError(
                    f"batched grounding returned {len(grounded)} results "
                    f"for {len(chunk)} items"
                )
        else:
            grounded = []
            for i in chunk:
                try:
                    grounded.append(grounder.inference_query_grounding(
                        video_path=dataset[i]["video_path"],
                        question=dataset[i]["question"],
                        options=dataset[i].get("options", ""),
                    ))
                except Exception as e:  # noqa: BLE001
                    grounded.append(e)
        for i, res in zip(chunk, grounded):
            if isinstance(res, Exception):
                logger.error(
                    "grounding failed for %s: %s", dataset[i].get("video_id"), res
                )
                rows[i]["error"] = f"{type(res).__name__}: {res}"
                continue
            targets, cues = res
            rows[i]["grounding_objects"] = {
                "target_objects": targets, "cue_objects": cues
            }
            tasks[i] = VideoTask(
                dataset[i]["video_path"], targets, cues, seed=seed + i
            )

    # stage 2: batched searches
    live = [(i, t) for i, t in enumerate(tasks) if t is not None]
    for start in range(0, len(live), batch_videos):
        chunk = live[start : start + batch_videos]
        try:
            outs = search_videos(
                [t for _, t in chunk], heuristic, config,
                collect_history=collect_history,
            )
        except Exception as e:  # noqa: BLE001
            logger.error("batched search failed: %s", e)
            for i, _ in chunk:
                rows[i]["error"] = f"{type(e).__name__}: {e}"
            continue
        for (i, _), out in zip(chunk, outs):
            rows[i]["keyframe_timestamps"] = out["keyframe_timestamps"]
            rows[i]["keyframe_distribution"] = out["keyframe_distribution"]
            if collect_history:
                rows[i]["sampled_history"] = out.get("sampled_history", [])
                rows[i]["detect_bbox_iters"] = out.get("detect_bbox_iters", [])
                if artifact_dir:
                    _save_batched_artifacts(
                        dataset[i], rows[i], tasks[i], heuristic, config,
                        artifact_dir,
                    )

    results = [r for r in rows if r.get("error") is None]
    os.makedirs(os.path.dirname(output_json) or ".", exist_ok=True)
    with open(output_json, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=4, ensure_ascii=False)
    logger.info("batched processing completed; results saved to %s", output_json)
    return results


def _save_batched_artifacts(item, row, task, heuristic, config, artifact_dir):
    """Annotated search GIF per batched item (best effort; never fails the
    run — mirrors the reference's per-item try/except artifact writes)."""
    import os as _os

    from tstar_tpu_torch.viz.artifacts import save_batched_search_artifacts

    try:
        det_size = heuristic.model.cfg.vision.image_size
    except AttributeError:
        det_size = getattr(getattr(heuristic, "model", None), "cfg", None)
        det_size = getattr(det_size, "image_size", None)
    if det_size is None:
        return
    names = list(task.target_objects) + list(task.cue_objects) + [" "]
    _os.makedirs(artifact_dir, exist_ok=True)
    gif = _os.path.join(
        artifact_dir, f"{item.get('video_id', 'video')}_searching_iterations.gif"
    )
    try:
        save_batched_search_artifacts(
            item["video_path"], row,
            (config.grid_rows, config.grid_cols), config.cell_hw,
            names, det_size, gif, sampling_fps=config.sampling_fps,
        )
    except Exception as e:  # noqa: BLE001
        logger.error("artifact write failed for %s: %s", item.get("video_id"), e)


def run_dataset(
    dataset: List[Dict[str, Any]],
    grounder,
    heuristic,
    output_json: str,
    resume: bool = True,
    **search_kwargs,
) -> List[Dict[str, Any]]:
    """Serial per-item runner with JSONL manifest + final JSON dump."""
    manifest = output_json + ".manifest.jsonl"
    done: Dict[str, Dict] = {}
    if resume and os.path.exists(manifest):
        with open(manifest, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    row = json.loads(line)
                    done[resume_key(row)] = row
        logger.info("resuming: %d items already done", len(done))

    results: List[Dict] = []
    os.makedirs(os.path.dirname(output_json) or ".", exist_ok=True)
    with open(manifest, "a", encoding="utf-8") as sink:
        for idx, item in enumerate(dataset):
            key = resume_key(item)
            logger.info(
                "Processing %d/%d: %s", idx + 1, len(dataset), item.get("video_id")
            )
            if key in done:
                results.append(done[key])
                continue
            row = dict(item)
            try:
                row.update(search_one_item(item, grounder, heuristic, **search_kwargs))
                row["error"] = None
            except Exception as e:  # noqa: BLE001 — per-item continue (:197-202)
                logger.error("error processing %s: %s", item.get("video_id"), e)
                row["error"] = f"{type(e).__name__}: {e}"
                json.dump(row, sink, ensure_ascii=False)
                sink.write("\n")
                sink.flush()
                continue
            results.append(row)
            json.dump(row, sink, ensure_ascii=False)
            sink.write("\n")
            sink.flush()

    with open(output_json, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=4, ensure_ascii=False)
    logger.info("batch processing completed; results saved to %s", output_json)
    return results
