"""A/B of the verification rescore: frames from the device cache against the
reference's fidelity chain, on the port.

    python -m tstar_tpu_torch.tools.verify_ab [--checkpoint_dir DIR]
        [--videos 3] [--duration 120] [--confidence_threshold 0.3]
        [--device cuda]

For each synthetic video, one search with the production verification
(``engine.run_search_chained``: the candidates rescored from the resident
cache rows) and one from the same initial state with the reference's
fidelity chain (``search/reference_verify.run_search_reference_verify``:
the raw frames decoded again and resized to ``verify_hw``, 285x600).  It
compares the removal decisions, the final remaining-target sets and the
keyframe overlap, and prints one JSON line.  With ``--checkpoint_dir`` (a
local HF OWL-ViT checkpoint) the difference is the real fidelity question;
with ``owl-vit-random`` B/32 it exercises the whole mechanism.

The videos are the reference tool's (120 s at 12 fps, 192x320, a couch at
the frame's center, size 0.4, for 6 s starting at (0.4 + 0.1 i) of the
video, cue ``tv``), served from memory (``video/synthetic.SyntheticDecoder``)
where the reference writes them through an mp4v encode: the card's machine
has no video codec.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch


def run(heuristic, videos: int, duration: float, confidence_threshold: float) -> dict:
    """The A/B over ``videos`` scenes with ``heuristic`` (on its device)."""
    from tstar_tpu_torch.search.engine import run_search_chained
    from tstar_tpu_torch.search.reference_verify import (
        make_raw_frame_source,
        run_search_reference_verify,
    )
    from tstar_tpu_torch.search.state import init_state
    from tstar_tpu_torch.utils.config import SearchConfig
    from tstar_tpu_torch.video.cache import build_frame_cache
    from tstar_tpu_torch.video.synthetic import PlantedObject, SyntheticDecoder

    dev = heuristic.device
    cfg = SearchConfig(search_budget=1.0, confidence_threshold=confidence_threshold)
    rows = []
    for i in range(videos):
        ev = duration * (0.4 + 0.1 * i)
        objects = [PlantedObject("couch", (ev, ev + 6.0), (200, 40, 40), (0.5, 0.5), 0.4)]

        def decoder():
            return SyntheticDecoder(duration, fps=12.0, hw=(192, 320), objects=objects)

        path = f"mem://verify-ab-v{i}"
        cache = build_frame_cache(path, cfg, device=dev, decoder=decoder())
        scorer = heuristic.build_scorer(cache.frames, ["couch"], ["tv"], cfg)

        def state0():
            rng = torch.Generator(device=dev).manual_seed(100 + i)
            return init_state(cache.n_valid, 1, cfg, rng, n_pad=cache.n_pad, device=dev)

        with torch.no_grad():
            fa, sa = run_search_chained(state0(), scorer, cfg)
            source = make_raw_frame_source(path, cfg, decoder=decoder())
            try:
                fb, sb, decisions = run_search_reference_verify(
                    state0(), scorer, cfg, source, collect_decisions=True)
            finally:
                source.close()
        ka, kb = set(sa.cpu().tolist()), set(sb.cpu().tolist())
        ra, rb = fa.remaining.cpu(), fb.remaining.cpu()
        rows.append({
            "video": f"v{i}",
            "iters_cache": int(fa.iteration),
            "iters_reference": int(fb.iteration),
            "remaining_cache": ra[:1].tolist(),
            "remaining_reference": rb[:1].tolist(),
            "removal_agree": bool(ra[0] == rb[0]),
            "keyframe_overlap": len(ka & kb) / max(1, len(ka | kb)),
            "reference_rescores": len(decisions),
        })
    agree = sum(r["removal_agree"] for r in rows)
    return {
        "videos": len(rows),
        "removal_agreement": f"{agree}/{len(rows)}",
        "mean_keyframe_overlap": round(float(np.mean([r["keyframe_overlap"] for r in rows])), 3),
        "per_video": rows,
    }


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--videos", type=int, default=3)
    p.add_argument("--duration", type=float, default=120.0)
    p.add_argument("--confidence_threshold", type=float, default=0.3)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from tstar_tpu_torch.framework.heuristics import initialize_heuristic

    heuristic = initialize_heuristic(
        "owl-vit" if args.checkpoint_dir else "owl-vit-random",
        checkpoint_dir=args.checkpoint_dir, device=args.device,
    )
    out = {"weights": "real" if args.checkpoint_dir else "random",
           "device": (torch.cuda.get_device_name(heuristic.device)
                      if heuristic.device.type == "cuda" else "cpu"),
           **run(heuristic, args.videos, args.duration, args.confidence_threshold)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
