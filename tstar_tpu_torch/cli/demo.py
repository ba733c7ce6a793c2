"""Demo CLI: one video and a question -> keyframes and an answer (port of
``tstar_tpu/cli/demo.py``, the same flags, plus ``--device``).

    python -m tstar_tpu_torch.cli.demo --video_path scene.mp4 --synthesize \\
        --question "What is the color of the couch?" \\
        --options "A) Red\\nB) Blue" --grounder fake --heuristic color-probe \\
        --device cpu --json

Without ``--synthesize`` the file at ``--video_path`` is read with the file
decoder (``video/decoder.py``).  ``--synthesize`` serves the in-memory
synthetic scene (``video/synthetic.default_scene``, 120 s) as the video's
decoder instead; the ``--video_path`` then only names the run.
``--device`` is "cuda" unless asked otherwise, for the grounder and the
detector alike.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="T* (PyTorch + CUDA): video keyframe search and question answering"
    )
    p.add_argument("--video_path", type=str, required=True)
    p.add_argument("--question", type=str, required=True)
    p.add_argument("--options", type=str, default="")
    p.add_argument("--grounder", type=str, default="gpt-4o",
                   help="VLM backend: gpt-4o | qwen-* | llava-* | fake")
    p.add_argument("--heuristic", type=str, default="owl-vit",
                   help="detector: owl-vit | owl-vit-random | color-probe | yolo-world")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="local checkpoint dir for the detector")
    p.add_argument("--heuristic_size", type=str, default=None,
                   help="detector size variant (e.g. yolo-world: xl | small)")
    p.add_argument("--search_nframes", type=int, default=8)
    p.add_argument("--grid_rows", type=int, default=4)
    p.add_argument("--grid_cols", type=int, default=4)
    p.add_argument("--confidence_threshold", type=float, default=0.6)
    p.add_argument("--search_budget", type=float, default=0.5)
    p.add_argument("--output_dir", type=str, default="./output")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic", action="store_true",
                   help="top-k keyframe pop instead of sampled (reproducible)")
    p.add_argument("--detector_quant", type=str, default=None, choices=["int8", "w8a16"],
                   help="quantize the OWL-ViT encoder: W8A8 (int8) or weight-only (w8a16)")
    p.add_argument("--verify_image_size", type=int, default=None,
                   help="verification rescore resolution (e.g. 512); "
                        "default = detector native size")
    p.add_argument("--json", action="store_true", help="print results as JSON")
    p.add_argument("--synthesize", action="store_true",
                   help="search the in-memory synthetic scene (no file is read or written)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the grounder and the detector: cuda | cpu")
    return p


def _gt_seconds(decoder) -> dict:
    end = decoder.meta.duration
    out: dict = {}
    for o in decoder.objects:
        secs = range(int(o.interval[0]), int(min(-(-o.interval[1] // 1), end)))
        out.setdefault(o.name, []).extend(secs)
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s",
                        handlers=[logging.StreamHandler(sys.stdout)])

    decoder = None
    if args.synthesize:
        from tstar_tpu_torch.video.synthetic import default_scene

        decoder = default_scene(120.0)
        print(f"Synthesized fixture video: {json.dumps(_gt_seconds(decoder))}")

    from tstar_tpu_torch.framework.framework import run_tstar

    kwargs = {}
    if args.checkpoint_dir:
        kwargs["checkpoint_dir"] = args.checkpoint_dir
    if args.heuristic_size:
        kwargs["size"] = args.heuristic_size
    if args.deterministic or args.detector_quant or args.verify_image_size:
        from tstar_tpu_torch.utils.config import SearchConfig

        kwargs["config"] = SearchConfig(
            deterministic_pop=args.deterministic,
            detector_quant=args.detector_quant,
            verify_image_size=args.verify_image_size,
        )
    results = run_tstar(
        video_path=args.video_path,
        question=args.question,
        options=args.options,
        grounder=args.grounder,
        heuristic=args.heuristic,
        search_nframes=args.search_nframes,
        grid_rows=args.grid_rows,
        grid_cols=args.grid_cols,
        confidence_threshold=args.confidence_threshold,
        search_budget=args.search_budget,
        output_dir=args.output_dir,
        seed=args.seed,
        decoder=decoder,
        device=args.device,
        **kwargs,
    )

    if args.json:
        print(json.dumps(results))
    else:
        print("#" * 40)
        print(f"Question: {args.question}")
        print(f"Options: {args.options}")
        print("#" * 40)
        print("T* Search Results:")
        print(f"  Grounding Objects: {results['Grounding Objects']}")
        print(f"  Frame Timestamps: {results['Frame Timestamps']}")
        print(f"  Answer: {results['Answer']}")
    return results


if __name__ == "__main__":
    main()
