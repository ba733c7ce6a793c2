"""Evaluation CLI: keyframe metrics and QA accuracy (port of
``tstar_tpu/cli/evaluate.py``; the same flags, plus ``--device``).

    python -m tstar_tpu_torch.cli.evaluate search --search_result_path out.json
    python -m tstar_tpu_torch.cli.evaluate qa --backend fake --json_file out.json \
        --sampling_type TStar --device cpu

Two subcommands covering the reference's two evaluator scripts:

  search — Temporal/SSIM/ANND metrics over a search-results JSON
           (val_tstar_results.py:385-443 surface; writes
           *lvhaystack_score.json next to ./results/lvhaystack_score/)
  qa     — QA accuracy with uniform/TStar sampling and resume
           (val_qa_results.py:302-372 surface; writes qa results + metrics)

``--device`` ("cuda" unless asked otherwise) is where the SSIM convolutions
run (``search``) and where the VLM backend runs (``qa``).
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="T* (PyTorch + CUDA) evaluation")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("search", help="keyframe-search metrics")
    s.add_argument("--search_result_path", type=str, required=True)
    s.add_argument("--frame_index_key", type=str, default="keyframe_timestamps")
    s.add_argument("--fps", type=float, default=1.0)
    s.add_argument("--threshold", type=int, default=5)
    s.add_argument("--no_ssim", action="store_true")
    s.add_argument("--ssim_axis_convention", type=str, default="reference",
                   choices=["reference", "standard"])
    s.add_argument("--max_workers", type=int, default=4)
    s.add_argument("--output_root", type=str, default="./results/lvhaystack_score")
    s.add_argument("--device", type=str, default="cuda",
                   help="device of the SSIM convolutions: cuda | cpu")

    q = sub.add_parser("qa", help="QA accuracy")
    q.add_argument("--backend", type=str, default="gpt-4o")
    q.add_argument("--json_file", type=str, required=True)
    q.add_argument("--sampling_type", type=str, default="uniform",
                   choices=["uniform", "TStar"])
    q.add_argument("--num_frame", type=int, default=8)
    q.add_argument("--duration_type", type=str, default="video",
                   choices=["video", "clip"])
    q.add_argument("--output_root", type=str, default="./results/qa_version")
    q.add_argument("--qa_batch", type=int, default=1,
                   help="batch VLM inference across items (the local "
                        "backends share prefill/decode forwards)")
    q.add_argument("--model_path", type=str, default=None,
                   help="local checkpoint dir for the local VLM backends")
    q.add_argument("--device", type=str, default="cuda",
                   help="device of the VLM backend: cuda | cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.command == "search":
        from tstar_tpu_torch.bench.datasets import load_results_json
        from tstar_tpu_torch.bench.evaluate import evaluate_search_results

        data = load_results_json(args.search_result_path)
        required = {"video_path", args.frame_index_key, "gt_frame_index"}
        valid = [d for d in data if required.issubset(d.keys())]
        if not valid:
            raise SystemExit("No valid entries found in JSON data.")
        metrics = evaluate_search_results(
            valid,
            frame_index_key=args.frame_index_key,
            fps=args.fps,
            threshold=args.threshold,
            compute_ssim=not args.no_ssim,
            ssim_axis_convention=args.ssim_axis_convention,
            max_workers=args.max_workers,
            device=args.device,
        )
        os.makedirs(args.output_root, exist_ok=True)
        name = os.path.basename(args.search_result_path)
        out = os.path.join(
            args.output_root, name.replace(".json", "lvhaystack_score.json")
        )
        with open(out, "w", encoding="utf-8") as f:
            json.dump(metrics, f, indent=4)
        print(json.dumps(metrics, indent=2))
        print(f"Metrics saved to {out}")
        return metrics

    # qa
    import numpy as np

    np.random.seed(2025)  # val_qa_results.py:319
    from tstar_tpu_torch.bench.datasets import load_results_json
    from tstar_tpu_torch.bench.evaluate import compute_qa_accuracy
    from tstar_tpu_torch.grounding.universal import UniversalGrounder

    grounder = UniversalGrounder(model_name=args.backend, model_path=args.model_path,
                                 device=args.device)
    data = load_results_json(args.json_file)
    os.makedirs(args.output_root, exist_ok=True)
    base = os.path.basename(args.json_file)
    backend_name = args.backend.replace("/", "_")
    out = os.path.join(
        args.output_root,
        base.replace(
            ".json",
            f"qa_{args.num_frame}frames_{backend_name}_{args.duration_type}_{args.sampling_type}.json",
        ),
    )
    accuracy, _ = compute_qa_accuracy(
        data, grounder,
        nframe=args.num_frame,
        sampling_type=args.sampling_type,
        duration_type=args.duration_type,
        output_file=out,
        qa_batch=args.qa_batch,
    )
    metrics_path = out.replace(".json", "_metrics.json")
    with open(metrics_path, "w", encoding="utf-8") as f:
        json.dump({"qa_accuracy": accuracy}, f, indent=2)
    print(f"QA Accuracy: {accuracy * 100:.2f}%")
    print(f"Results saved to {out}")
    print(f"Metrics saved to {metrics_path}")
    return accuracy


if __name__ == "__main__":
    main()
