"""Where the device time of the port's full-width search goes, on one GPU.

    python -m tstar_tpu_torch.tools.profile_search [--out FILE.json] [--top N]
        [--runs LABEL ...] [--ln-fold-trace]

The search of ``chip_smoke.py`` phases 5 to 7 (``owl-vit-random`` B/32 in
bf16, a synthetic 600 s video, targets couch + lamp, cue tv, budget 0.5)
under each configuration (all by default, or those named by ``--runs``),
stepped through CUDA graphs unless the label says "eager": bf16; bf16
eager; the batched search of phase 8 over one bucket of eight distinct
videos (``batched b8``, its caches built outside the timed region; and
eager); ``detector_quant='int8'`` with ``verify_image_size=512``;
``detector_quant='w8a16'``; bf16 with ``TSTAR_LN_MATMUL=force``;
``use_pallas_preprocess=True`` (K7); ``TSTAR_GRID_EMBED=force`` (K6);
``TSTAR_FUSED_MHA=0 TSTAR_FLASH_ATTENTION=1`` (K8); and YOLO-World v2-XL
(``calibrated_yolo_xl``, bf16, ``chip_smoke.py`` phase 10) on the same
video, stepped through graphs (``yolo``), eagerly (``yolo eager``) and
over the bucket of eight (``yolo batched b8``).  For each: one warm-up search, one search timed
on the host clock (ending in ``torch.cuda.synchronize()``), then one under
``torch.profiler`` (CPU + CUDA activities).  From the profiler's device
events it reports the summed device time, the device-busy share of the
profiled wall (the union of the device intervals), each port kernel's
device time and launches, the largest kernel lines, and the steps' host
reads and graph replays.

``--ln-fold-trace`` also runs the ``TSTAR_LN_MATMUL=force`` search three
more times, unprofiled, to show how far a summation order moves it: through
K5, with every launch also held against ``ln_matmul_plain`` on the same
inputs within ``bf16_error_bound``; with each K5 launch replaced by
``ln_matmul_plain`` on the card (the same math, cuBLAS's sums); and
unfused (K3, then the matmul).  For each: the grid forwards' sampled
seconds, the verification batches and the keyframes; for each pair, the
grid forwards that sampled the same seconds and the largest difference of
their scores.  Needs a CUDA device; prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import time

import torch

# Device-kernel name fragments of the port's hand-written kernels (K1 and K8
# in bf16 share attn_sm90_kernel; its first template argument is the mode:
# 0 / 1 K1, 2 K8).
PORT_KERNELS = {
    "K1 mha": ("mha_kernel", "attn_sm90_kernel<0", "attn_sm90_kernel<1"),
    "K2 patch_embed": "patch_embed",
    "K3 layernorm": ("layernorm_kernel", "layernorm_wide_kernel"),
    "K4 w8a8": "w8a8_kernel",
    "K5 ln_matmul": "ln_matmul_kernel",
    "K6 grid_embed": ("grid_embed_kernel", "grid_embed_sm90_kernel"),
    "K7 grid pack": "grid_pack_kernel",
    "K8 flash": ("flash_kernel", "attn_sm90_kernel<2"),
    "nms": ("nms_mask_kernel", "nms_scan_kernel"),
}


@contextlib.contextmanager
def environ(env):
    """Set the environment variables of ``env`` inside the block; restore
    (or unset) them after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _busy_ms(intervals):
    """Length of the union of (start, end) intervals, in ms."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def device_events(prof):
    """A profile's device events -> ({kernel name: [ms, launches]}, their
    (start, end) intervals in ns)."""
    by_name = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        by_name[e.name()][0] += e.duration_ns() / 1e6
        by_name[e.name()][1] += 1
        intervals.append((e.start_ns(), e.end_ns()))
    return by_name, intervals


def _single(heur, config, graphs):
    """-> make(seed): a callable running one ``KeyframeSearcher.search()``
    (the searcher built outside it) and returning its ``StepStats``."""
    from tstar_tpu_torch.search.searcher import KeyframeSearcher
    from tstar_tpu_torch.video.synthetic import default_scene

    def make(seed):
        s = KeyframeSearcher(
            "mem://synthetic-600s", heur, ["couch", "lamp"], ["tv"],
            search_budget=0.5, config=config, seed=seed, decoder=default_scene(600.0),
        )

        def go():
            s.search(graphs=graphs)
            return s.step_stats
        return go
    return make


def calibrated_yolo_xl(dtype, seed=0):
    """``yolo-world-random`` at size xl on the card, its folded BN scales set
    for unit variance (``unit_variance_bn_``) on four grid canvases of the
    synthetic 600 s scene under the searches' prompts (couch, lamp; tv).  At
    the seeded init the activations shrink until every anchor scores 0.5000
    and every class and NMS decision is a tie; a checkpoint's BN statistics
    do what this does."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.models.yoloworld import unit_variance_bn_
    from tstar_tpu_torch.video.cache import build_frame_cache
    from tstar_tpu_torch.video.synthetic import default_scene

    heur = initialize_heuristic("yolo-world-random", size="xl", device="cuda", dtype=dtype,
                                seed=seed)
    cfg = SearchConfig(cache_hw=(192, 384))
    cache = build_frame_cache("mem://synthetic-600s", cfg, device="cuda",
                              decoder=default_scene(600.0))
    scorer = heur.build_scorer(cache.frames, ["couch", "lamp"], ["tv"], cfg)
    cells = torch.arange(16, device="cuda") * 37
    px = torch.cat([scorer._grid_pixels(scorer.cache, cells + o) for o in (0, 9, 18, 27)])
    with torch.no_grad():
        unit_variance_bn_(heur.model, px.to(heur.model.dtype), scorer.text_embeds)
    return heur


def _bucket(heur, config, graphs, n=8):
    """-> make(seed): a callable searching one bucket of ``n`` distinct
    600 s videos (``scene_variant``) through ``multi_video._search_bucket``,
    their caches decoded and uploaded outside it; returns its ``StepStats``."""
    from tstar_tpu_torch.parallel.multi_video import VideoTask, _search_bucket
    from tstar_tpu_torch.search.step_graphs import StepStats
    from tstar_tpu_torch.video.cache import build_frame_cache
    from tstar_tpu_torch.video.synthetic import scene_variant

    def make(seed):
        tasks = [VideoTask(f"mem://synthetic-600s-{i}", ["couch", "lamp"], ["tv"], seed=seed + i,
                           decoder=scene_variant(i)) for i in range(n)]
        caches = [build_frame_cache(t.video_path, config, device="cuda", decoder=t.decoder)
                  for t in tasks]

        def go():
            stats = StepStats()
            _search_bucket(tasks, caches, heur, config, graphs, stats)
            return stats
        return go
    return make


def profile_config(make, top):
    """One warm-up run of ``make(1)``, one timed run of ``make(0)``, one
    under ``torch.profiler``; ``make(seed)`` returns the run (a callable
    returning its ``StepStats``)."""
    make(1)()                                           # warm-up
    go = make(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = go()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    go = make(0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    by_name, intervals = device_events(prof)
    device_ms = sum(v[0] for v in by_name.values())
    port = {}
    for label, frag in PORT_KERNELS.items():
        frags = (frag,) if isinstance(frag, str) else frag
        hits = [v for k, v in by_name.items() if any(f in k for f in frags)]
        port[label] = {"ms": sum(v[0] for v in hits), "launches": sum(v[1] for v in hits)}
    largest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    steps = max(stats.steps, 1)
    return {
        "wall_s": wall, "profiled_wall_s": profiled_wall, "device_ms": device_ms,
        "busy_ms": _busy_ms(intervals), "busy_share": _busy_ms(intervals) / (profiled_wall * 1e3),
        "device_events": sum(v[1] for v in by_name.values()),
        "steps": stats.steps, "grid_images": stats.grid_images,
        "verify_images": sum(stats.verify_widths),
        "host_reads_per_step": stats.host_reads / steps,
        "graph_replays_per_step": stats.replays / steps, "graph_captures": stats.captures,
        "port_kernels": port,
        "largest": [{"name": k[:120], "ms": v[0], "count": v[1]} for k, v in largest],
    }


def _traced_search(heur):
    """One search's grid forwards (sampled seconds, scores), verification
    batches and keyframes, under the switches set by the caller (the LN fold
    here; ``chip_smoke.py`` traces K6's route)."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.search.searcher import KeyframeSearcher
    from tstar_tpu_torch.video.synthetic import default_scene

    s = KeyframeSearcher(
        "mem://synthetic-600s", heur, ["couch", "lamp"], ["tv"], search_budget=0.5,
        config=SearchConfig(cache_hw=(192, 384)), seed=0, decoder=default_scene(600.0),
    )
    grid, verify = [], []
    score_grid, score_verify = s.scorer.score_grid, s.scorer.score_verify

    def traced_grid(secs):
        out = score_grid(secs)
        grid.append((torch.as_tensor(secs).cpu().clone(), out[0].float().cpu()))
        return out

    def traced_verify(secs):
        verify.append(int(torch.as_tensor(secs).numel()))
        return score_verify(secs)

    s.scorer.score_grid, s.scorer.score_verify = traced_grid, traced_verify
    _, stamps = s.search(graphs=False)      # eager: every forward passes the tracers
    torch.cuda.synchronize()
    return {"grid": grid, "verify_batches": verify, "keyframes": [float(t) for t in stamps]}


def _same_seconds(a, b):
    """Grid forwards of two traced searches that sampled the same seconds
    (from the first on), and the largest score difference over them."""
    n, diff = 0, 0.0
    for (sa, ca), (sb, cb) in zip(a["grid"], b["grid"]):
        if not torch.equal(sa, sb):
            break
        n += 1
        diff = max(diff, (ca - cb).abs().max().item())
    return {"forwards": n, "of": min(len(a["grid"]), len(b["grid"])), "max_score_diff": diff}


def ln_fold_trace(heur, card):
    """``--ln-fold-trace``: the LN-fold search through K5 (each launch held
    against its plain version), through the plain version, and unfused."""
    from tstar_tpu_torch.kernels import ln_matmul

    launch = ln_matmul._launch
    held = {"launches": 0, "outputs_over_bound": 0, "max_diff_over_bound": 0.0}

    def checked(x, scale, bias, w, b, eps):
        out = launch(x, scale, bias, w, b, eps)
        want = ln_matmul.ln_matmul_plain(x, scale, bias, w, b, eps)
        bound = ln_matmul.bf16_error_bound(x, scale, bias, w, b, eps, want)
        diff = (out.float() - want.float()).abs()
        held["launches"] += 1
        held["outputs_over_bound"] += int((diff > bound).sum().item())
        held["max_diff_over_bound"] = max(held["max_diff_over_bound"], (diff / bound).max().item())
        return out

    runs = {}
    with environ({"TSTAR_LN_MATMUL": "force"}):
        for label, body in (("K5 kernel", checked), ("K5 plain version", ln_matmul.ln_matmul_plain)):
            ln_matmul._launch = body
            try:
                runs[label] = _traced_search(heur)
            finally:
                ln_matmul._launch = launch
    with environ({"TSTAR_LN_MATMUL": "0"}):
        runs["unfused"] = _traced_search(heur)
    for label, r in runs.items():
        print(f"[ln fold trace] {label}: {len(r['grid'])} grid forwards, verify batches "
              f"{r['verify_batches']}, keyframes {r['keyframes']}", flush=True)
    print(f"[ln fold trace] K5 kernel against its plain version in the search: "
          f"{held['launches']} launches, {held['outputs_over_bound']} outputs over "
          f"bf16_error_bound, largest |diff| / bound {held['max_diff_over_bound']:.3f}  ({card})",
          flush=True)
    pairs = {f"{a} / {b}": _same_seconds(runs[a], runs[b])
             for a, b in (("K5 kernel", "K5 plain version"), ("K5 kernel", "unfused"),
                          ("K5 plain version", "unfused"))}
    for label, c in pairs.items():
        print(f"[ln fold trace] {label}: the first {c['forwards']} of {c['of']} grid forwards "
              f"sampled the same seconds; largest score difference on them "
              f"{c['max_score_diff']:.3e}", flush=True)
    return {
        "runs": {k: {"grid_forwards": len(r["grid"]), "verify_batches": r["verify_batches"],
                     "keyframes": r["keyframes"],
                     "grid_seconds": [sec.tolist() for sec, _ in r["grid"]]}
                 for k, r in runs.items()},
        "k5_against_plain": held, "same_seconds": pairs,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--top", type=int, default=8, help="largest kernel lines to keep")
    ap.add_argument("--runs", nargs="*", default=None, help="configurations to profile (labels)")
    ap.add_argument("--ln-fold-trace", action="store_true",
                    help="also trace the LN-fold search under K5, its plain version and unfused")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_search needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic

    heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.bfloat16, seed=0)
    base = dict(cache_hw=(192, 384))
    bf16 = SearchConfig(**base)
    runs = {
        "bf16": (_single(heur, bf16, None), {}),
        "bf16 eager": (_single(heur, bf16, False), {}),
        "batched b8": (_bucket(heur, bf16, None), {}),
        "batched b8 eager": (_bucket(heur, bf16, False), {}),
        "int8+verify512": (_single(heur, SearchConfig(
            detector_quant="int8", verify_image_size=512, **base), None), {}),
        "w8a16": (_single(heur, SearchConfig(detector_quant="w8a16", **base), None), {}),
        "ln_matmul": (_single(heur, bf16, None), {"TSTAR_LN_MATMUL": "force"}),
        "k7 pallas preprocess": (_single(heur, SearchConfig(
            use_pallas_preprocess=True, **base), None), {}),
        "k6 grid embed": (_single(heur, bf16, None), {"TSTAR_GRID_EMBED": "force"}),
        "k8 flash": (_single(heur, bf16, None),
                     {"TSTAR_FUSED_MHA": "0", "TSTAR_FLASH_ATTENTION": "1"}),
    }
    yolo = {}

    def yolo_heur():
        """YOLO-World v2-XL (``calibrated_yolo_xl``), made at first use."""
        if not yolo:
            yolo["h"] = calibrated_yolo_xl(torch.bfloat16)
        return yolo["h"]

    runs.update({
        "yolo": (lambda seed: _single(yolo_heur(), bf16, None)(seed), {}),
        "yolo eager": (lambda seed: _single(yolo_heur(), bf16, False)(seed), {}),
        "yolo batched b8": (lambda seed: _bucket(yolo_heur(), bf16, None)(seed), {}),
    })
    unknown = set(args.runs or ()) - set(runs)
    if unknown:
        raise SystemExit(f"unknown runs {sorted(unknown)}; choose from {sorted(runs)}")
    results = {"card": card, "torch": torch.__version__, "runs": {}}
    for label, (make, env) in runs.items():
        if args.runs and label not in args.runs:
            continue
        with environ(env):
            r = profile_config(make, args.top)
        results["runs"][label] = r
        kern = ", ".join(f"{k} {v['ms']:.2f} ms/{v['launches']}" for k, v in r["port_kernels"].items())
        print(f"[{label}] wall {r['wall_s']:.4f} s, profiled wall {r['profiled_wall_s']:.4f} s, "
              f"device {r['device_ms']:.2f} ms in {r['device_events']} events, busy "
              f"{r['busy_ms']:.2f} ms ({100 * r['busy_share']:.1f}% of the profiled wall); "
              f"{r['steps']} steps, {r['grid_images']} grid + {r['verify_images']} verify "
              f"images, {r['host_reads_per_step']:.2f} host reads and "
              f"{r['graph_replays_per_step']:.2f} graph replays a step "
              f"({r['graph_captures']} captures); {kern}  ({card})", flush=True)
        for line in r["largest"]:
            print(f"[{label}]   {line['ms']:9.3f} ms {line['count']:6d}x  {line['name']}", flush=True)
    if args.ln_fold_trace:
        results["ln_fold_trace"] = ln_fold_trace(heur, card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
