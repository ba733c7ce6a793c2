"""Batch dataset runner CLI (port of ``tstar_tpu/cli/dataset.py``, after the
reference's run_TStar_onDataset.py:149-213; the same flags, plus
``--device``).

    python -m tstar_tpu_torch.cli.dataset --local_json meta.json \
        --video_root videos --grounder fake --heuristic owl-vit-random \
        --device cpu [--batch_videos 2]

Defaults mirror the reference (grounder gpt-4o, heuristic owl-vit, conf 0.7,
budget 1.0, grid 4x4, split test_tiny).  The dataset comes from a local
JSON dump (``--local_json``): the HF hub path downloads, which the port does
not do.  Videos are read from ``--video_root``.  ``--device`` is "cuda"
unless asked otherwise, for the grounder and the detector alike.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="T* (PyTorch + CUDA): batch video search over a dataset")
    p.add_argument("--dataset_meta", type=str, default="LVHaystack/LongVideoHaystack")
    p.add_argument("--split", type=str, default="test_tiny")
    p.add_argument("--video_root", type=str,
                   default="./Datasets/ego4d_data/ego4d_data/v1/256p")
    p.add_argument("--local_json", type=str, default=None,
                   help="offline dataset dump instead of the HF hub")
    p.add_argument("--output_json_name", type=str,
                   default="TStar_LongVideoHaystack_tiny.json")
    p.add_argument("--grounder", type=str, default="gpt-4o")
    p.add_argument("--heuristic", type=str, default="owl-vit")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--search_nframes", type=int, default=8)
    p.add_argument("--grid_rows", type=int, default=4)
    p.add_argument("--grid_cols", type=int, default=4)
    p.add_argument("--confidence_threshold", type=float, default=0.7)
    p.add_argument("--search_budget", type=float, default=1.0)
    p.add_argument("--output_dir", type=str, default="./results/frame_search")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--batch_videos", type=int, default=0,
                   help=">0: search N videos concurrently in one on-device "
                        "batched loop (detector backends only)")
    p.add_argument("--detector_quant", type=str, default=None,
                   choices=["int8", "w8a16"],
                   help="quantize the OWL-ViT encoder: W8A8 (int8) or weight-only (w8a16)")
    p.add_argument("--verify_image_size", type=int, default=None,
                   help="verification rescore resolution (e.g. 512); "
                        "default = detector native size")
    p.add_argument("--max_items", type=int, default=0,
                   help=">0: truncate the dataset to the first N items "
                        "(the adapter already caps hub splits at 200, "
                        "run_TStar_onDataset.py:85; this caps local JSON too)")
    p.add_argument("--collect_history", action="store_true",
                   help="batched runs: record per-iteration sampled frames + "
                        "detections per video (reference detect_bbox_iters)")
    p.add_argument("--artifact_dir", type=str, default=None,
                   help="with --collect_history: write annotated "
                        "per-iteration search GIFs here")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the grounder and the detector: cuda | cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tstar_tpu_torch.bench.datasets import lvhaystack_to_tstar
    from tstar_tpu_torch.bench.runner import run_dataset
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.grounding.universal import UniversalGrounder

    dataset = lvhaystack_to_tstar(
        dataset_meta=args.dataset_meta,
        split=args.split,
        video_root=args.video_root,
        local_json=args.local_json,
    )
    if args.max_items > 0:
        dataset = dataset[: args.max_items]
    grounder = UniversalGrounder(model_name=args.grounder, device=args.device)
    hk = {}
    if args.checkpoint_dir:
        hk["checkpoint_dir"] = args.checkpoint_dir
    heuristic = initialize_heuristic(args.heuristic, device=args.device, **hk)

    os.makedirs(args.output_dir, exist_ok=True)
    output_json = os.path.join(
        args.output_dir, f"{args.heuristic}_{args.output_json_name}"
    )
    common = dict(
        search_nframes=args.search_nframes,
        grid_rows=args.grid_rows,
        grid_cols=args.grid_cols,
        confidence_threshold=args.confidence_threshold,
        search_budget=args.search_budget,
    )
    if args.detector_quant or args.verify_image_size:
        from tstar_tpu_torch.utils.config import SearchConfig

        common["config"] = SearchConfig(
            detector_quant=args.detector_quant,
            verify_image_size=args.verify_image_size,
        )
    if args.batch_videos > 0:
        from tstar_tpu_torch.bench.runner import run_dataset_batched

        results = run_dataset_batched(
            dataset, grounder, heuristic, output_json,
            batch_videos=args.batch_videos,
            collect_history=args.collect_history or bool(args.artifact_dir),
            artifact_dir=args.artifact_dir,
            **common,
        )
    else:
        results = run_dataset(
            dataset, grounder, heuristic, output_json,
            resume=not args.no_resume,
            output_dir=args.output_dir,
            **common,
        )
    print(f"Batch processing completed. {len(results)} results -> {output_json}")
    return results


if __name__ == "__main__":
    main()
