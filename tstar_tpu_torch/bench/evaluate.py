"""Evaluation runners: keyframe-search metrics and QA accuracy (port of
``tstar_tpu/bench/evaluate.py``).

Counterparts of ``LVHaystackBench/val_tstar_results.py`` and
``val_qa_results.py``: frame extraction is keyed by item index (the
reference appends in thread-completion order, which can misalign lists when
early videos fail, val_tstar_results.py:309-348), and the QA evaluator
resumes from its per-item JSONL file.  Frames are read with the file decoder
(``video/decoder.open_video``), a handle per item and thread.  Where the
JAX package retries a failed batched QA call item by item, this port lets
it raise, as its grounder does (ROADMAP queue 3 item 7): an item's own
frame-extraction or answer failure stays that item's failure row.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np

from tstar_tpu_torch.video.decoder import opened
from tstar_tpu_torch.bench.metrics import annd, match_answer, ssim_prf, temporal_prf

logger = logging.getLogger(__name__)


def resume_key(item: Dict[str, Any]) -> str:
    """The per-item resume-manifest key, shared by every resumable stage.

    Keys on (video_path, question): one video commonly carries several
    questions (the reference keys its QA resume on video_path alone and
    would misattribute cached answers across questions,
    val_qa_results.py:219)."""
    return f"{item.get('video_path', '')}||{item.get('question', '')}"


# ---------------------------------------------------------------------------
# Keyframe-search metric evaluation (val_tstar_results.py:296-380)
# ---------------------------------------------------------------------------

def _extract_frames(video_path: str, frame_indices: List[int]) -> List[np.ndarray]:
    with opened(video_path) as dec:
        total = max(1, dec.meta.total_frames)
        clipped = [min(max(0, int(i)), total - 1) for i in frame_indices]
        return list(dec.decode_batch(clipped))


def evaluate_search_results(
    result_data: List[Dict[str, Any]],
    frame_index_key: str = "keyframe_timestamps",
    fps: float = 1.0,
    threshold: float = 5.0,
    compute_ssim: bool = True,
    ssim_axis_convention: str = "reference",
    max_workers: int = 4,
    device="cuda",
) -> Dict[str, float]:
    """Temporal PRF + SSIM PRF + ANND over search-result items.

    Items need {video_path, <frame_index_key> (pred timestamps in seconds),
    gt_frame_index (raw frame indices)}.  Frame extraction parallelizes over
    ``max_workers`` threads with results keyed by item INDEX — the reference
    appends in thread-completion order, which misaligns its gt/pred lists
    when early videos fail (val_tstar_results.py:309-348).

    ``fps`` is accepted for CLI parity but IGNORED: the reference converts
    predicted timestamps to raw frame indices with its --fps flag (default
    1.0, val_tstar_results.py:316,395), which decodes the wrong frames for
    SSIM unless the caller passes each video's true rate; here the probed
    per-video fps is always used instead.  SSIM runs on ``device`` ("cuda"
    unless the caller passes "cpu").
    """
    del fps
    from concurrent.futures import ThreadPoolExecutor

    def one(idx_item):
        idx, item = idx_item
        try:
            video_path = item["video_path"]
            pred_ts = list(item[frame_index_key])
            gt_idx = list(item["gt_frame_index"])
        except KeyError as e:
            logger.error("entry %d missing field %s", idx, e)
            return None
        try:
            with opened(video_path) as dec:
                video_fps = dec.meta.fps
            gt_sec = np.asarray([i / video_fps for i in gt_idx])
            gt_img, pred_img = [], []
            if compute_ssim:
                pred_frame_idx = [int(ts * video_fps) for ts in pred_ts]
                frames = _extract_frames(video_path, gt_idx + pred_frame_idx)
                gt_img = frames[: len(gt_idx)]
                pred_img = frames[len(gt_idx):]
            return gt_sec, np.asarray(pred_ts), gt_img, pred_img
        except Exception as e:  # noqa: BLE001 — per-item continue
            logger.error("entry %d (%s) failed: %s", idx, video_path, e)
            return None

    with ThreadPoolExecutor(max_workers=max(1, max_workers)) as pool:
        rows = list(pool.map(one, enumerate(result_data)))

    gt_secs, pred_secs, gt_images, pred_images = [], [], [], []
    for row in rows:
        if row is None:
            continue
        gt_secs.append(row[0])
        pred_secs.append(row[1])
        if compute_ssim:
            gt_images.append(row[2])
            pred_images.append(row[3])

    p, r, f1 = temporal_prf(gt_secs, pred_secs, threshold=threshold)
    metrics = {
        "Average Temporal Precision": p,
        "Average Temporal Recall": r,
        "Average Temporal F1 Score": f1,
    }
    annd_p, annd_r = annd(gt_secs, pred_secs)
    metrics["Average ANND Precision (s)"] = annd_p
    metrics["Average ANND Recall (s)"] = annd_r
    if compute_ssim and gt_images:
        sp, sr, sf = ssim_prf(gt_images, pred_images, ssim_axis_convention, device)
        metrics["Average SSIM Precision"] = sp
        metrics["Average SSIM Recall"] = sr
        metrics["Average SSIM F1 Score"] = sf
    return metrics


# ---------------------------------------------------------------------------
# QA accuracy evaluation (val_qa_results.py:48-299)
# ---------------------------------------------------------------------------

def extract_qa_frames(
    video_path: str,
    item: Dict[str, Any],
    frame_distribution: Optional[List[float]] = None,
    num_frames: int = 8,
    duration_type: str = "video",
) -> List[np.ndarray]:
    """Frame selection for QA: 'uniform' (linspace) or distribution top-k
    within the clip slice (val_qa_results.py:89-117)."""
    with opened(video_path) as dec:
        total = dec.meta.total_frames
        fps = dec.meta.fps
        duration = total / fps
        if duration_type == "clip":
            start, end = item.get("vclip_interval_in_video") or [0, duration]
        else:
            start, end = 0, duration
        start, end = max(0, start), min(duration, end)

        if frame_distribution is not None:
            dist = np.nan_to_num(np.asarray(frame_distribution, np.float32))
            if dist.sum() == 0:
                dist = np.ones_like(dist)
            lo, hi = int(start), int(end)
            clip = dist[lo:hi]
            if clip.size == 0 or clip.sum() == 0:
                clip = np.ones(max(1, hi - lo), np.float32)
            topk = np.argsort(-clip)[:num_frames]
            secs = np.sort(topk) + lo
        else:
            secs = np.linspace(start, end, num_frames).astype(int)

        idx = [min(max(0, int(s * fps)), total - 1) for s in secs]
        return list(dec.decode_batch(idx))


def compute_qa_accuracy(
    result_data: List[Dict[str, Any]],
    vlm_model,
    nframe: int = 8,
    sampling_type: str = "uniform",
    duration_type: str = "video",
    output_file: str = "./qa_results.jsonl",
    qa_batch: int = 1,
    max_workers: int = 4,
) -> tuple:
    """QA eval with JSONL resume (val_qa_results.py:182-299).

    ``qa_batch`` > 1 batches VLM inference across items (the reference is
    strictly serial, one generate per item): frames for the chunk extract on
    ``max_workers`` threads keyed by item index, then one
    ``inference_qa_batch`` call answers the whole chunk in shared
    prefill/decode forwards when the grounder supports it.  Extraction and
    serial answer errors fail only their item; a failed batched call
    raises.
    """
    if sampling_type not in ("uniform", "TStar"):
        raise NotImplementedError(
            f"sampling_type '{sampling_type}' not in [uniform, TStar]"
        )

    existing: Dict[str, Dict] = {}
    if os.path.exists(output_file):
        logger.info("resuming from %s", output_file)
        with open(output_file, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    it = json.loads(line)
                    existing[resume_key(it)] = it

    from concurrent.futures import ThreadPoolExecutor

    results: List[Optional[Dict[str, Any]]] = [None] * len(result_data)
    pending: List[int] = []
    correct = total = 0
    for idx, item in enumerate(result_data):
        done = existing.get(resume_key(item))
        if done is not None:
            results[idx] = done
            # Failure rows never count toward the accuracy denominator —
            # same rule as fresh failures below (a resume must not change
            # the reported metric).  The explicit qa_failed flag is the
            # marker; the prediction-prefix check only covers manifests
            # written before the flag existed.
            pred = str(done.get(f"{sampling_type}_pred_answer", ""))
            failed = done.get("qa_failed", pred.startswith("failed:"))
            if not failed:
                correct += bool(done.get("correct"))
                total += 1
        else:
            pending.append(idx)

    def extract_one(idx):
        item = result_data[idx]
        dist = (
            item.get("keyframe_distribution") if sampling_type == "TStar" else None
        )
        return extract_qa_frames(
            item["video_path"], item, dist, nframe, duration_type=duration_type
        )

    chunk_size = max(1, qa_batch)
    with open(output_file, "a", encoding="utf-8") as sink:
        for at in range(0, len(pending), chunk_size):
            chunk = pending[at: at + chunk_size]
            # index-keyed threaded extraction (reference appends in
            # completion order, which misaligns lists — see module docstring)
            frames_by_idx: Dict[int, Any] = {}
            with ThreadPoolExecutor(max_workers=max(1, max_workers)) as pool:
                for idx, res in zip(
                    chunk,
                    pool.map(
                        lambda i: _try_extract(extract_one, i), chunk
                    ),
                ):
                    frames_by_idx[idx] = res

            ok = [i for i in chunk if not isinstance(frames_by_idx[i], Exception)]
            preds: Dict[int, str] = {}
            if len(ok) > 1 and hasattr(vlm_model, "inference_qa_batch"):
                answers = vlm_model.inference_qa_batch(
                    [
                        {
                            "frames": frames_by_idx[i],
                            "question": result_data[i]["question"],
                            "options": result_data[i]["options"],
                        }
                        for i in ok
                    ],
                    temperature=0.2,
                )
                preds = dict(zip(ok, answers))
            for i in ok:
                if i in preds:
                    continue
                try:
                    preds[i] = vlm_model.inference_qa(
                        frames=frames_by_idx[i],
                        question=result_data[i]["question"],
                        options=result_data[i]["options"],
                        temperature=0.2,
                        max_tokens=1024,
                    ).strip()
                except Exception as e:  # noqa: BLE001 — per-item continue
                    logger.error("item %d failed: %s", i, e)
                    frames_by_idx[i] = e

            for idx in chunk:
                item = result_data[idx]
                err = frames_by_idx[idx]
                if not isinstance(err, Exception):
                    try:
                        pred = preds[idx]
                        is_correct = match_answer(pred, item["gt_answer"].strip())
                    except Exception as e:  # noqa: BLE001 — per-item row
                        logger.error("item %d failed: %s", idx, e)
                        err = e
                if isinstance(err, Exception):
                    item[f"{sampling_type}_pred_answer"] = f"failed: {err}"
                    item["correct"] = False
                    item["qa_failed"] = True
                else:
                    item[f"{sampling_type}_pred_answer"] = pred
                    item["correct"] = is_correct
                    item["qa_failed"] = False
                    correct += is_correct
                    total += 1
                results[idx] = item
                json.dump(item, sink, ensure_ascii=False)
                sink.write("\n")
                sink.flush()

    accuracy = correct / total if total else 0.0
    logger.info("QA Accuracy: %.2f%% (%d/%d)", accuracy * 100, correct, total)
    return accuracy, [r for r in results if r is not None]


def _try_extract(fn, idx):
    try:
        return fn(idx)
    except Exception as e:  # noqa: BLE001 — per-item failure row
        return e
