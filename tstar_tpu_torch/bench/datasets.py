"""Dataset adapters: LV-Haystack and LongVideoBench -> T* item schema (port
of ``tstar_tpu/bench/datasets.py``).

Target schema (reference ``LVHaystackBench/run_TStar_onDataset.py:67-75``):
    {"video_id", "video_path", "question", "options" (lettered "A) ...\\n"),
     "gt_answer", "gt_frame_index", "vclip_interval_in_video"}

The LV-Haystack adapter reads a local JSON dump and applies the reference's
200-item cap (:85).  Loading from the HF hub downloads, which the port does
not do: without ``local_json`` it raises ``NotImplementedError``.  The
LongVideoBench adapter filters subtitle questions and keeps only the 3600 s
duration group (Longvideobench2LVHaystackFormat.py:39-42).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

ITEM_CAP = 200  # run_TStar_onDataset.py:85


def _letter_options(options) -> str:
    if isinstance(options, str):
        return options
    if isinstance(options, dict):
        return "\n".join(f"{k}) {v}" for k, v in options.items())
    letters = [chr(ord("A") + i) for i in range(len(options))]
    return "\n".join(f"{l}) {o}" for l, o in zip(letters, options))


def lvhaystack_to_tstar(
    dataset_meta: str = "LVHaystack/LongVideoHaystack",
    split: str = "test_tiny",
    video_root: str = "./Datasets/ego4d_data/ego4d_data/v1/256p",
    local_json: Optional[str] = None,
    cap: int = ITEM_CAP,
) -> List[Dict]:
    """Load LV-Haystack from a local JSON dump into T* format."""
    if not local_json:
        raise NotImplementedError(
            f"loading {dataset_meta!r} ({split}) from the HF hub downloads it, which this port "
            "does not do: pass local_json= (--local_json) with a dump of the split"
        )
    with open(local_json, encoding="utf-8") as f:
        rows = json.load(f)

    items: List[Dict] = []
    for idx, row in enumerate(rows):
        try:
            video_id = row.get("video_id")
            question = row.get("question")
            if not video_id or not question:
                raise ValueError("missing video_id or question")
            options = row.get("options", "")
            meta = row.get("video_metadata", {}) or {}
            items.append(
                {
                    "video_id": video_id,
                    "video_path": os.path.join(video_root, f"{video_id}.mp4"),
                    "question": question,
                    "options": _letter_options(options) if options else "",
                    "gt_answer": row.get("answer"),
                    "gt_frame_index": row.get("frame_indexes_video", []),
                    "vclip_interval_in_video": meta.get("vclip_interval_in_video"),
                }
            )
        except Exception as e:  # noqa: BLE001 — per-item skip (:80-83)
            logger.warning("skipping LV-Haystack entry %d: %s", idx + 1, e)
    return items[:cap]


def longvideobench_to_tstar(
    dataset_path: str,
    video_root: str,
    output_path: Optional[str] = None,
    duration_group: int = 3600,
) -> List[Dict]:
    """LongVideoBench JSON -> T* format (subtitle Qs dropped, one duration
    group kept; answers mapped to letters)."""
    with open(dataset_path, encoding="utf-8") as f:
        rows = json.load(f)

    num2letter = ["A", "B", "C", "D", "E"]
    items: List[Dict] = []
    for idx, row in enumerate(rows):
        try:
            category = row.get("question_category", "Unknown")
            if "T" in category:        # subtitle-dependent question
                continue
            if row.get("duration_group") != duration_group:
                continue
            candidates = row.get("candidates", [])
            video_id = row.get("video_id")
            question = row.get("question")
            if not video_id or not question or not candidates:
                raise ValueError("missing required fields")
            items.append(
                {
                    "video_id": video_id,
                    "video_path": os.path.join(video_root, row.get("video_path", "")),
                    "question": question,
                    "options": _letter_options(candidates),
                    "gt_answer": num2letter[row.get("correct_choice", 0)],
                    "gt_frame_index": row.get("position", []),
                    "duration_group": duration_group,
                }
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("skipping LongVideoBench entry %d: %s", idx + 1, e)

    if output_path:
        with open(output_path, "w", encoding="utf-8") as f:
            json.dump(items, f, indent=4)
        logger.info("wrote %d items to %s", len(items), output_path)
    return items


def load_results_json(path: str) -> List[Dict]:
    """JSON with JSONL fallback (val_tstar_results.py:150-175)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines() if line.strip()]
