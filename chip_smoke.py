"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result line):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles the port's CUDA kernels from ``tstar_tpu_torch/csrc``;
  3. kernels: each hand-written kernel (K1 attention, K2 patch embed, K3
     LayerNorm) against its plain PyTorch version at the main path's shapes,
     bf16 and f32, with the max abs error, its tolerance, and CUDA-event
     times of kernel and plain version;
  4. tower numerics: one 768^2 grid image through the full-width OWL-ViT B/32
     (seeded random weights) in bf16 on the card with the kernels, against
     the same weights in f32 on the CPU with the plain versions;
  5. the slice: ``initialize_heuristic('owl-vit-random')`` in bf16 on the card,
     ``KeyframeSearcher.search()`` over a synthetic 600 s video; every kernel
     must launch during the search.
The second-to-last line is a JSON object of per-kernel results; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, fenced by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(torch, card):
    """Phase 3: every kernel against its plain version; returns summary rows."""
    from tstar_tpu_torch.kernels import attention, layernorm, patch_matmul

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # Pass when |kernel - reference| <= atol + rtol * |reference| everywhere.
    # bf16: the f32 results before the final rounding differ by summation
    # order only (~1e-6 relative), so the outputs differ by at most one bf16
    # ulp, which rtol = 2^-7 covers; K1's atol also covers a rounding flip of
    # one of its bf16 probabilities.  f32: summation order only.
    bf16_ulp = 2.0 ** -7
    tols = {
        "K1": {torch.bfloat16: (1e-3, bf16_ulp), torch.float32: (1e-6, 1e-5)},
        "K2": {torch.bfloat16: (1e-4, bf16_ulp), torch.float32: (1e-4, 1e-5)},
        "K3": {torch.bfloat16: (1e-5, bf16_ulp), torch.float32: (1e-5, 1e-5)},
    }
    cases = []   # (kernel, shape, input, kernel fn, plain fn, reference fn)
    mha = lambda x: attention.fused_mha_from_qkv(x, 12)              # noqa: E731
    mha_plain = lambda x: attention.fused_mha_from_qkv_plain(x, 12)  # noqa: E731
    # B=1: the grid forward; B=8 / 16: the bucketed / wide verify forwards.
    # S=385 keeps even f32 K/V resident in shared memory (the branch bf16
    # takes at S=577); f32 at S=577 takes the tiled branch.
    for b, s in ((1, 577), (8, 577), (16, 577), (2, 385)):
        qkv = torch.randn(b, s, 3 * 768, generator=g, device=dev)
        cases.append(("K1", f"B={b} S={s} 12x64", qkv, mha, mha_plain, mha_plain))
    w32 = torch.randn(32, 32, 3, 768, generator=g, device=dev) * 0.02
    w_patch = {torch.float32: w32, torch.bfloat16: w32.to(torch.bfloat16)}

    def patch_ref(x):
        # the plain version in f32 on the same (rounded) inputs, rounded once:
        # cuBLAS's bf16 GEMM may itself reduce in reduced precision
        w = w_patch[x.dtype]
        return patch_matmul.patch_embed_matmul_plain(x.float(), w.float()).to(x.dtype)

    for b in (1, 8, 16):
        px = torch.randn(b, 768, 768, 3, generator=g, device=dev)
        cases.append(("K2", f"B={b} 768x768x3->768", px,
                      lambda x: patch_matmul.patch_embed_matmul(x, w_patch[x.dtype]),
                      lambda x: patch_matmul.patch_embed_matmul_plain(x, w_patch[x.dtype]),
                      patch_ref))
    for rows, d in ((577, 768), (8 * 577, 768), (16 * 577, 768), (256, 512)):
        x = torch.randn(rows, d, generator=g, device=dev) * 3 + 1
        s = torch.randn(d, generator=g, device=dev)
        bias = torch.randn(d, generator=g, device=dev)
        plain = lambda t, s=s, bias=bias: layernorm.fused_layernorm_plain(t, s, bias)  # noqa: E731
        cases.append(("K3", f"{rows}x{d}", x,
                      lambda t, s=s, bias=bias: layernorm.fused_layernorm(t, s, bias),
                      plain, plain))

    rows_out = []
    for name, shape, x32, kern, plain, ref in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            got = kern(x)
            torch.cuda.synchronize()
            want = ref(x).float()
            diff = (got.float() - want).abs()
            err = diff.max().item()
            atol, rtol = tols[name][dtype]
            ok = bool((diff <= atol + rtol * want.abs()).all()) and bool(
                torch.isfinite(got.float()).all())
            ms, plain_ms = cuda_ms(lambda: kern(x)), cuda_ms(lambda: plain(x))
            dt = "bf16" if dtype == torch.bfloat16 else "f32"
            log(f"[kernels] {name} {shape} {dt}: max_abs_err={err:.3e} "
                f"tol=atol {atol:.0e} + rtol {rtol:.2e}*|ref| "
                f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms  ({card}) {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name} {shape} {dt} disagrees with its plain version")
            rows_out.append((name, shape, dt, err, ms, plain_ms))
    return rows_out


def phase_tower(torch):
    """Phase 4: full-width B/32 on the card (bf16, kernels) vs CPU (f32, plain)."""
    import copy

    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.kernels.image import build_detector_grid
    from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer
    from tstar_tpu_torch.models.owlvit import (
        OwlViTDetector, init_params, owlvit_base_patch32, postprocess_detections,
    )
    from tstar_tpu_torch.search.detector_scorer import build_prompt_batch
    from tstar_tpu_torch.video.cache import build_frame_cache_host
    from tstar_tpu_torch.video.synthetic import default_scene

    cfg = owlvit_base_patch32()
    cpu_model = init_params(OwlViTDetector(cfg), seed=0).requires_grad_(False).eval()
    gpu_model = copy.deepcopy(cpu_model).to("cuda", torch.bfloat16)
    host = build_frame_cache_host("mem://scene", SearchConfig(), decoder=default_scene(600.0))
    secs = torch.tensor([0, 40, 75, 78, 100, 140, 200, 250, 300, 350, 385, 402, 405, 410, 420, 500])
    tok = HashTokenizer(cfg.text.vocab_size, cfg.text.max_length)
    ids, mask, _ = build_prompt_batch(["couch", "lamp"], ["tv"], tok, SearchConfig())

    def run(model, device, dtype):
        cache = torch.from_numpy(host.frames).to(device)
        px = build_detector_grid(cache, secs.to(device), (4, 4), 768, dtype)
        with torch.no_grad():
            q = model.encode_text(torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device))
            qmask = torch.from_numpy(ids[:, 0] > 0).to(device)
            logits, boxes = model.predict(model.encode_image(px), q, qmask)
            return postprocess_detections(logits, boxes, (768, 768))

    t0 = time.perf_counter()
    gs, gc, gb = run(gpu_model, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cs, cc, cb = run(cpu_model, "cpu", torch.float32)
    t2 = time.perf_counter()
    score_err = (gs.float().cpu() - cs).abs().max().item()
    box_err = (gb.float().cpu() - cb).abs().max().item()
    agree = (gc.cpu() == cc).float().mean().item()
    # bf16 keeps 8 mantissa bits; twelve layers of bf16 rounding move the
    # post-sigmoid scores by up to a few 1e-3 on random weights.
    tol = 2e-2
    ok = score_err <= tol and bool(torch.isfinite(gs).all()) and gs.shape == (1, 576)
    log(f"[tower] B/32 full width, one 768^2 grid image: scores shape {tuple(gs.shape)}, "
        f"max |score cuda-bf16 - cpu-f32| = {score_err:.3e} (tol {tol:.0e}), "
        f"max box err {box_err:.3e} px, class agreement {agree:.4f}; "
        f"card forward {t1 - t0:.3f} s (first call), cpu forward {t2 - t1:.3f} s "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("full-width tower on the card disagrees with the CPU reference")
    return score_err


def phase_slice(torch, card):
    """Phase 5: the slice's main path; returns (launch counts, summary)."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.search.searcher import KeyframeSearcher
    from tstar_tpu_torch.video.synthetic import default_scene

    heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.bfloat16, seed=0)
    cfg = SearchConfig(cache_hw=(192, 384))

    def make(seed):
        s = KeyframeSearcher(
            "mem://synthetic-600s", heur, ["couch", "lamp"], ["tv"],
            search_budget=0.5, config=cfg, seed=seed, decoder=default_scene(600.0),
        )
        counted = {"frames": 0, "grid": 0, "verify_batches": []}
        grid, verify = s.scorer.score_grid, s.scorer.score_verify

        def score_grid(secs):
            counted["frames"] += secs.numel()
            counted["grid"] += 1
            return grid(secs)

        def score_verify(secs):
            counted["frames"] += secs.numel()
            counted["verify_batches"].append(secs.numel())
            return verify(secs)

        s.scorer.score_grid, s.scorer.score_verify = score_grid, score_verify
        return s, counted

    warm, _ = make(seed=1)
    warm.search()                              # warm-up: cuBLAS, Triton caches
    searcher, counted = make(seed=0)
    log(f"[slice] frame cache {tuple(searcher.cache.frames.shape)} uint8 "
        f"({searcher.cache.frames.numel() / 1e6:.1f} MB) on {searcher.cache.frames.device}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    frames, stamps = searcher.search()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    state = searcher._final_state
    scores = searcher.score_distribution
    checks = {
        "8 timestamps": len(stamps) == 8 and len(frames) == 8,
        "timestamps in range": all(0 <= t < searcher.duration for t in stamps),
        "timestamps sorted": stamps == sorted(stamps),
        "finite scores": bool(torch.isfinite(state.scores).all()) and len(scores) == 600,
        "frames at native size": all(f.shape == (360, 640, 3) for f in frames),
        **{f"{k} launched": v > 0 for k, v in counts.items()},
    }
    log(f"[slice] iterations={state.iteration} frames_scored={counted['frames']} "
        f"wall={wall:.3f} s peak_mem={peak / 2**20:.1f} MiB  ({card})")
    log(f"[slice] detector forwards: {counted['grid']} grid (B=1), verify batches "
        f"{counted['verify_batches']}")
    log(f"[slice] timestamps={stamps} remaining={searcher.remaining_targets}")
    log(f"[slice] kernel launches during the search: {counts}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"slice checks failed: {failed}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    card = card_line()
    log(card)  # the card's name and power limit, as nvidia-smi prints them
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices={torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tstar_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"[build] CUDA kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({_build.library_path().name})")

    rows = phase_kernels(torch, card)
    phase_tower(torch)
    counts = phase_slice(torch, card)

    meta = {
        "K1": ("fused_mha_from_qkv", "cuda", "tstar_tpu_torch/csrc/mha.cu",
               "tstar_tpu/kernels/attention.py:298"),
        "K2": ("patch_embed_matmul", "cuda", "tstar_tpu_torch/csrc/patch_embed.cu",
               "tstar_tpu/kernels/patch_matmul.py:76"),
        "K3": ("fused_layernorm", "triton", "tstar_tpu_torch/kernels/layernorm.py",
               "tstar_tpu/kernels/layernorm.py:126"),
    }
    kernels = []
    for k, (name, route, source, replaces) in meta.items():
        mine = [r for r in rows if r[0] == k and r[2] == "bf16"]
        main_shape = mine[0]    # the B=1 grid forward's shape: most of the launches
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r[3] for r in mine),
            "ms": main_shape[4], "plain_ms": main_shape[5],
            "shape": f"{main_shape[1]} bf16",
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
