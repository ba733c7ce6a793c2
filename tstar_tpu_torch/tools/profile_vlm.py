"""Where the device time of one full-width VLM request goes, on one GPU.

    python -m tstar_tpu_torch.tools.profile_vlm [--out FILE.json] [--top N]

The QA request of ``chip_smoke.py`` phase 9a: LLaVA-OneVision at 7B's
widths (seeded random weights, bf16, built on the card), 8 frames of a
synthetic 600 s video, a multiple-choice prompt, 30 new tokens, greedy;
the decode stepped through a CUDA graph ("llava qa") or eagerly ("llava qa
eager").  For each: one warm-up request (it captures the graph), one timed
on the host clock (ending in ``torch.cuda.synchronize()``) with the
prefill's and the decode's device milliseconds (CUDA events), then one
under ``torch.profiler`` (CPU + CUDA activities).  From the device events:
the summed device time, the device-busy share of the profiled wall (the
union of the device intervals), K3's time and launches, and the largest
kernel lines.  Needs a CUDA device; prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import torch

from tstar_tpu_torch.tools.profile_search import _busy_ms, device_events


def _request(model, tok, graphs):
    """-> a callable running one QA request, returning its ``GenerateStats``."""
    from tstar_tpu_torch.grounding.prompts import build_qa_prompt
    from tstar_tpu_torch.models.generate import GenerateStats, generate
    from tstar_tpu_torch.models.llava_onevision import prepare_llava_inputs
    from tstar_tpu_torch.utils.images import load_video_frames
    from tstar_tpu_torch.video.synthetic import default_scene

    prompt = build_qa_prompt("What color is the couch in the video?",
                             "A) red\nB) blue\nC) green\nD) yellow", 8)

    def go():
        stats = GenerateStats(timed=True)
        frames = load_video_frames("mem://scene", 8, decoder=default_scene(600.0))
        inp = prepare_llava_inputs(tok, prompt, frames, model.cfg)
        generate(model, inp["input_ids"], inp["prompt_lens"], inp["position_ids"],
                 max_new_tokens=30, eos_token_ids=[tok.eos_id, tok.pad_id], temperature=0.0,
                 image_patches=inp["image_patches"], graphs=graphs, stats=stats).tolist()
        return stats
    return go


def profile_request(go, top):
    go()                                               # warm-up (captures)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = go()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    by_name, intervals = device_events(prof)
    k3 = [v for k, v in by_name.items() if "layernorm" in k]
    largest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    busy = _busy_ms(intervals)
    return {
        "wall_s": wall, "prefill_ms": stats.prefill_ms[0], "decode_ms": stats.decode_ms[0],
        "decode_steps": stats.decode_steps, "captures": stats.captures,
        "replays": stats.replays, "host_reads": stats.flag_reads,
        "profiled_wall_s": profiled_wall, "device_ms": sum(v[0] for v in by_name.values()),
        "device_events": sum(v[1] for v in by_name.values()),
        "busy_ms": busy, "busy_share": busy / (profiled_wall * 1e3),
        "k3": {"ms": sum(v[0] for v in k3), "launches": sum(v[1] for v in k3)},
        "largest": [{"name": k[:120], "ms": v[0], "count": v[1]} for k, v in largest],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--top", type=int, default=10, help="largest kernel lines to keep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_vlm needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionConfig, LlavaOnevisionModel
    from tstar_tpu_torch.models.qwen2vl import random_model
    from tstar_tpu_torch.models.qwen_tokenizer import QwenTokenizer, write_byte_vocab

    model = random_model(LlavaOnevisionModel, LlavaOnevisionConfig(), torch.bfloat16, "cuda")
    with tempfile.TemporaryDirectory() as d:
        write_byte_vocab(d)
        tok = QwenTokenizer.from_dir(d)
    results = {"card": card, "torch": torch.__version__, "runs": {}}
    with torch.no_grad():
        for label, graphs in (("llava qa", None), ("llava qa eager", False)):
            r =  profile_request(_request(model, tok, graphs), args.top)
            results["runs"][label] = r
            print(f"[{label}] wall {r['wall_s']:.4f} s (prefill {r['prefill_ms']:.3f} ms, decode "
                  f"{r['decode_ms']:.3f} ms in {r['decode_steps']} steps, {r['replays']} replays, "
                  f"{r['host_reads']} host reads), profiled wall {r['profiled_wall_s']:.4f} s, "
                  f"device {r['device_ms']:.2f} ms in {r['device_events']} events, busy "
                  f"{r['busy_ms']:.2f} ms ({100 * r['busy_share']:.1f}% of the profiled wall); "
                  f"K3 {r['k3']['ms']:.3f} ms / {r['k3']['launches']}  ({card})", flush=True)
            for line in r["largest"]:
                print(f"[{label}]   {line['ms']:9.3f} ms {line['count']:6d}x  {line['name']}",
                      flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
